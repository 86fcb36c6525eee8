"""flush_idle_ms_per_window.regen: the device's idle time inside the regen
wavefront's window ends, in ms a window: the idle time (no device
operation running) inside the ``rpt.flush`` spans of the traced frames,
over their count.  What the host's reads at a window end (the finished
lanes' ``nonzero``, the length histogram's ``bincount``, the liveness
read once the queue is spent) and the launches of the flush and respawn
leave unused on the card.  The profiler slows the host, so this reads
high against an untraced run.

Spans (``benchmark/spans.py``), emitted by ``rust_pathtracer_tpu_torch``:
``rpt.flush`` around each window end of ``wavefront.render_radiance_regen``
(``_flush_refill`` or ``_advance_stripe``, and the liveness read), the
``rpt.sync`` spans of its reads inside.  None without device operations
(a CPU run) or without flush spans, as on a program that has none."""

from benchmark import spans


def read(ctx):
    tr = ctx["trace"]
    if tr is None or not tr.ops:
        return None
    flushes = spans.named(tr, "rpt.flush")
    if not flushes:
        return None
    return spans.idle_within(tr, flushes) / len(flushes) / 1e3
