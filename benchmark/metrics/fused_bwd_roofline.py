"""fused_bwd_roofline: the differentiable fused route's kernels, K1 with
residuals (``fused_bounce_kernel``) and both of K2's
(``fused_bounce_bwd_kernel``, ``reduce_partials_kernel``): their summed
least time over their summed device time in the traced steps, in
percent.  K1's least time by its bytes (``yardstick.k1_bytes`` with the
residual planes), K2's by ``yardstick.k2_bound``, each at the step's
lanes."""

from benchmark.yardstick import K1_RESIDUAL_PLANES, bound, k1_bytes, k2_bound

K2_NAMES = ("fused_bounce_bwd_kernel", "reduce_partials_kernel")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    lanes, prims = ctx["lanes"], ctx["counts"]["total"]
    k1_s, n1 = tr.device_seconds(lambda name: "fused_bounce_kernel" in name)
    k2_s, _ = tr.device_seconds(lambda name: any(k in name for k in K2_NAMES))
    _, n2 = tr.device_seconds(lambda name: "fused_bounce_bwd_kernel" in name)
    if n1 == 0 or n2 == 0:
        return None
    least_ms = (n1 * bound(k1_bytes(lanes, prims, K1_RESIDUAL_PLANES), 0)[0]
                + n2 * k2_bound(lanes, prims)[0])
    return 100.0 * least_ms / 1e3 / (k1_s + k2_s)
