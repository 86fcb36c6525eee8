"""idle_share.mesh: rank 0's device idle share of the traced frames of a
grid of ranks, 1 - busy / wall, as ``idle_share.render`` reads it; its
waits in the collectives for slower ranks count as busy (NCCL's kernels
spin), which ``rank_skew.mesh`` shows."""


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.ops:
        return None
    return 1.0 - tr.busy_s / tr.window_s
