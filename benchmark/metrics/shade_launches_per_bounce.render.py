"""shade_launches_per_bounce.render: launches of the shade kernel
(``shade_bounce_kernel``, ``rust_pathtracer_tpu_torch/ops/csrc/shade.cu``)
in the traced frames over the bounce iterations they ran (the renderer's
``TraceStats.bounces``, summed over chunks).  1.0 where every bounce
shades in the kernel: the count that says the big-scene bounce took it,
and one that repeats exactly.  None where the trace holds no launch of it
(a program without the kernel, a route that bypasses it)."""

KERNEL = "shade_bounce_kernel"


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["bounces"]:
        return None
    _, n = tr.device_seconds(lambda name: KERNEL in name)
    if n == 0:
        return None
    return n / ctx["bounces"]
