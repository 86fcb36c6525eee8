"""syncs_per_frame.render: the times a traced frame blocks the host on
the card, a count a frame: the ``rpt.sync`` spans over the frames
traced.  A count that repeats exactly from run to run where the frames'
work does; the profiler does not change it.

Spans (``benchmark/spans.py``), emitted by ``rust_pathtracer_tpu_torch``:
``rpt.sync`` around each host read of a device value on the frame path
(``integrator._trace_fused`` / ``_trace_generic``'s liveness reads,
``render.py``'s cascade live count, overflow read and schedule probe,
``wavefront.py``'s regen reads, ``parallel/shard.py``'s statistics and
overflow reads, ``ops/worklist.py``'s overflow read) and ``rpt.frame``
around each frame (``render.render_radiance``,
``wavefront.render_radiance_regen``,
``parallel/shard.render_radiance_sharded``).  None where the program
has no frame spans."""

from benchmark import spans


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not ctx["answers"] or not spans.named(tr, "rpt.frame"):
        return None
    return len(spans.named(tr, "rpt.sync")) / ctx["answers"]
