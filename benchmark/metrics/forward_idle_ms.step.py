"""forward_idle_ms.step: the device's idle time inside the loss's
forward (the differentiable render and the loss), in ms a traced step:
the idle time (no device operation running) inside the ``rpt.forward``
spans, over the steps traced.  It splits the step's idle time
(``idle_share.step``) between the program's forward, its backward, and
what the caller does around them (Adam).  The profiler slows the host,
so this reads high against an untraced run.

Spans (``benchmark/spans.py``), emitted by ``rust_pathtracer_tpu_torch``:
``rpt.forward`` around ``l2_loss`` in ``grad.render_loss_and_grad``.
None without device operations (a CPU run) or without the spans."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms_per_answer(ctx, "rpt.forward")
