"""pool_occupancy.regen: the share of the regen pool's lane-bounces that
traced a ray segment in the traced frames: the frames' segments
(``TraceStats.segments``, summed after the window) over their bounces
(``TraceStats.bounces``, the loop's bounce iterations) times the pool's
lanes.  A lane whose path ended waits dead until its window ends (every
``wavefront.FLUSH_EVERY`` bounces), and the pool idles through the last
paths once the queue is spent; both lower the share.  A count, which
the profiler does not change.  None off the regen renderer or without
bounces."""


def read(ctx):
    if ctx["trace"] is None or ctx.get("renderer") != "regen" or not ctx["bounces"]:
        return None
    return ctx["segments"] / (ctx["bounces"] * ctx["lanes"])
