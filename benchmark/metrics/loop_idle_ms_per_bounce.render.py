"""loop_idle_ms_per_bounce.render: the device's idle time while the host
runs the bounce loop, in ms a bounce: the idle time (no device operation
running) inside the union of the ``rpt.bounce`` and ``rpt.sync`` spans
of the traced frames, over the number of ``rpt.bounce`` spans.  The
device time that the host between bounces leaves unused.  The profiler
slows the host, so this reads high against an untraced run.

Spans (``benchmark/spans.py``), emitted by ``rust_pathtracer_tpu_torch``:
``rpt.bounce`` (``integrator._trace_fused``, ``integrator._trace_generic``,
``FusedScanTrace.forward`` in ``ops/fused_bounce.py``, the regen loop of
``wavefront.render_radiance_regen``) and ``rpt.sync`` (every host read of
a device value on the frame path: the loops' liveness reads in
``integrator.py``, the cascade's live count and overflow read in
``render.py``, the regen's in ``wavefront.py``, the grid's in
``parallel/shard.py``).  None without device operations (a CPU run) or
without bounce spans."""

from benchmark import spans


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.ops:
        return None
    bounces = spans.named(tr, "rpt.bounce")
    if not bounces:
        return None
    loop = bounces + spans.named(tr, "rpt.sync")
    return spans.idle_within(tr, loop) / len(bounces) / 1e3
