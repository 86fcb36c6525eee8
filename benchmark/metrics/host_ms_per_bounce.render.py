"""host_ms_per_bounce.render: the host's own time a bounce in the traced
frames, in ms: the summed ``rpt.bounce`` spans less the part of them
that ``rpt.sync`` spans cover (the host blocked on the card), over the
number of ``rpt.bounce`` spans.  What the host spends launching a
bounce's work, where the device may wait for it.  The profiler slows the
host, so this reads high against an untraced run.

Spans (``benchmark/spans.py``), emitted by ``rust_pathtracer_tpu_torch``:
``rpt.bounce`` around one bounce's host work, the liveness read that
admits it left out (``integrator._trace_fused`` and
``integrator._trace_generic`` with its reorder; ``FusedScanTrace.forward``
in ``ops/fused_bounce.py``; the regen loop of
``wavefront.render_radiance_regen``); ``rpt.sync`` around each host read
of a device value (the loops' liveness reads, ``wavefront._reorder_pool``'s
live count).  None where the program has no bounce spans."""

from benchmark import spans


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    bounces = spans.named(tr, "rpt.bounce")
    if not bounces:
        return None
    blocked = spans.intersect(spans.union(bounces), spans.union(spans.named(tr, "rpt.sync")))
    return (spans.length(bounces) - spans.length(blocked)) / len(bounces) / 1e3
