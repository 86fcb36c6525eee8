"""rank_skew.mesh: how far the busiest rank of a grid holds the frame
back: the largest of the ranks' device busy seconds over the traced
frames, NCCL's kernels left out (they spin while they wait for the
slower ranks), over the ranks' mean, less 1.  0 is a grid in balance."""


def read(ctx):
    busy = ctx.get("rank_busy_s")
    if not busy or len(busy) < 2 or min(busy) <= 0.0:
        return None
    return max(busy) / (sum(busy) / len(busy)) - 1.0
