"""k1_lane_roofline: K1's (``fused_bounce_kernel``) summed least time over
its summed device time in the traced frames of the regen wavefront, in
percent.  Every launch there covers the whole pool (``ctx["lanes"]``)
with a depth row; its least time is ``yardstick.bound`` of the bytes it
moves (``yardstick_regen.k1_lane_bytes``; operations left out, so the
share is a lower bound of K1's).  None off the regen renderer, and where
the trace has no K1 launch."""

from benchmark.yardstick_regen import k1_lane_bound


def read(ctx):
    tr = ctx["trace"]
    if tr is None or ctx.get("renderer") != "regen":
        return None
    seconds, n = tr.device_seconds(lambda name: "fused_bounce_kernel" in name)
    if n == 0 or seconds <= 0.0:
        return None
    least_ms = k1_lane_bound(ctx["lanes"], ctx["counts"]["total"])[0]
    return 100.0 * n * least_ms / 1e3 / seconds
