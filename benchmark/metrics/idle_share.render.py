"""idle_share.render: the device's idle share of the traced frames, 1 -
busy / wall, busy the union of the device operations' intervals
(``yardstick.busy_ms``) and wall the host clock from the first traced
frame's start to the last one's end.  The profiler
slows the host, so this reads high against an untraced run."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.ops:
        return None
    return 1.0 - tr.busy_s / tr.window_s
