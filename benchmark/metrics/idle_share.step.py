"""idle_share.step: the device's idle share of the traced steps, 1 - busy /
wall, as ``idle_share.render`` reads it for frames."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.ops:
        return None
    return 1.0 - tr.busy_s / tr.window_s
