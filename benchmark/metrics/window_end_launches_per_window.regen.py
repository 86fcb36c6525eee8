"""window_end_launches_per_window.regen: launches of the regen window end's
kernels (``window_end_finish_kernel``, ``window_end_add_kernel`` and
``window_end_respawn_kernel``, ``rust_pathtracer_tpu_torch/ops/csrc/
window_end.cu``) in the traced frames over their window ends, the
``rpt.flush`` spans.  3.0 where every window end runs on the device: the
count that says the mechanism engaged, and one that repeats exactly.  None
where the trace holds no launch of them (a program without the kernels, a
route that bypasses them) or no window end."""

from benchmark import spans

KERNELS = ("window_end_finish_kernel", "window_end_add_kernel", "window_end_respawn_kernel")


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    windows = len(spans.named(tr, "rpt.flush"))
    _, n = tr.device_seconds(lambda name: any(k in name for k in KERNELS))
    if n == 0 or windows == 0:
        return None
    return n / windows
