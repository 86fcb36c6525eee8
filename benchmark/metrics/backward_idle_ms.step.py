"""backward_idle_ms.step: the device's idle time inside the backward
(``torch.autograd.grad``: K2 and autograd's tensor ops), in ms a traced
step: the idle time (no device operation running) inside the
``rpt.backward`` spans, over the steps traced.  It splits the step's idle time
(``idle_share.step``) between the program's forward, its backward, and
what the caller does around them (Adam).  The profiler slows the host,
so this reads high against an untraced run.

Spans (``benchmark/spans.py``), emitted by ``rust_pathtracer_tpu_torch``:
``rpt.backward`` around ``torch.autograd.grad`` in
``grad.render_loss_and_grad``.  None without device operations (a CPU
run) or without the spans."""

from benchmark import spans


def read(ctx):
    return spans.idle_ms_per_answer(ctx, "rpt.backward")
