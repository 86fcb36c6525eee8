"""device_ops_per_bounce.render: device operations (kernels, copies,
sets) in the traced frames over the bounce iterations they ran (the
renderer's ``TraceStats.bounces``, summed over chunks): the host's
launches a bounce, a count that repeats exactly."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.ops or not ctx["bounces"]:
        return None
    return len(tr.ops) / ctx["bounces"]
