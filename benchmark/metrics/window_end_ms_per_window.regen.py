"""window_end_ms_per_window.regen: the device time of the regen window end
in the traced frames, in milliseconds a window: every device operation
from the start of a ``window_end_finish_kernel`` to the end of the
``window_end_respawn_kernel`` after it (``rust_pathtracer_tpu_torch/ops/
csrc/window_end.cu``, on one stream: the finish, the library sort of the
(pixel, lane) pairs, whose kernels carry CUB's names, the add and the
respawn), over the window ends (the ``rpt.flush`` spans).  A finish whose
respawn the trace does not hold is left out.  None where the trace holds
no finish and respawn (a program without the kernels, a route that
bypasses them) or no window end."""

from benchmark import spans

FINISH, RESPAWN = "window_end_finish_kernel", "window_end_respawn_kernel"


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    windows = len(spans.named(tr, "rpt.flush"))
    us, ends, inside = 0.0, 0, None
    for name, s, e in sorted(tr.ops, key=lambda op: op[1]):
        if FINISH in name:
            inside = 0.0
        if inside is None:
            continue
        inside += e - s
        if RESPAWN in name:
            us, ends, inside = us + inside, ends + 1, None
    if ends == 0 or windows == 0:
        return None
    return us / windows / 1e3
