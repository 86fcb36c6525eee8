"""shade_ms_per_bounce.render: the shade kernel's device time
(``shade_bounce_kernel``, ``rust_pathtracer_tpu_torch/ops/csrc/shade.cu``:
the hit record, texture, banking, scatter, commit and roulette of a
big-scene bounce) in the traced frames over the bounce iterations they ran
(``TraceStats.bounces``, summed over chunks), in milliseconds.  None where
the trace holds no launch of it."""

KERNEL = "shade_bounce_kernel"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["bounces"]:
        return None
    seconds, n = tr.device_seconds(lambda name: KERNEL in name)
    if n == 0:
        return None
    return 1e3 * seconds / ctx["bounces"]
