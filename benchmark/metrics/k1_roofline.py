"""k1_roofline: K1's (``fused_bounce_kernel``) summed least time over its
summed device time in the traced frames, in percent.  A launch's least
time is ``yardstick.bound`` of the bytes it moves at the chunk's lanes
(``yardstick.k1_bytes``; operations left out, so the share is a lower
bound of K1's)."""

from benchmark.yardstick import bound, k1_bytes


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    seconds, n = tr.device_seconds(lambda name: "fused_bounce_kernel" in name)
    if n == 0 or seconds <= 0.0:
        return None
    least_ms = bound(k1_bytes(ctx["lanes"], ctx["counts"]["total"]), 0)[0]
    return 100.0 * n * least_ms / 1e3 / seconds
