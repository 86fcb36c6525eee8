"""The program's spans (``utils/metrics.span``) on the CPU at toy sizes.

Under ``torch.profiler`` a frame opens one ``rpt.frame``, one
``rpt.chunk`` a sample chunk, one ``rpt.bounce`` a bounce the renderer
counts (``TraceStats.bounces``), each bounce inside its chunk and each
chunk inside the frame, and every host read of a device value inside a
chunk (``aten::_local_scalar_dense``) lies inside an ``rpt.sync``: on
the fused route (CornellBox), the generic route with the between-bounce
reorder and the dynamic cascade (SphereField), and the regen wavefront,
in both its modes, whose window ends open one ``rpt.flush`` each,
between bounces, around every read outside the bounces.  A step opens
one ``rpt.forward`` and then one ``rpt.backward``.  With no profiler
running no span is built: every path renders with
``torch.profiler.record_function`` made to raise.  The benchmark's
readers of these spans are tested in ``benchmark/tests/test_bench_spans.py``.
"""

import dataclasses

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from rust_pathtracer_tpu_torch import sampling
from rust_pathtracer_tpu_torch.grad import CameraParams, DiffParams, render_loss_and_grad
from rust_pathtracer_tpu_torch.integrator import use_wavefront_reorder
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.ops.fused_bounce import fused_bounce_diff_ok, fused_bounce_ok
from rust_pathtracer_tpu_torch.render import render_radiance
from rust_pathtracer_tpu_torch.utils.metrics import span
from rust_pathtracer_tpu_torch.wavefront import FLUSH_EVERY, render_radiance_regen

torch.set_num_threads(2)

CORNELL_CAM = ((278.0, 278.0, -800.0), (278.0, 278.0, 0.0), (0.0, 1.0, 0.0),
               40.0, 1.0, 0.0, 10.0)
SPP, SPP_CHUNK = 4, 2
KEY = sampling.prng_key(11)
# route -> (scene, settings over the scene's own)
ROUTES = {
    "fused": ("CornellBox", dict(max_bounces=5)),
    "generic-reorder": ("SphereField", dict(max_bounces=4, reorder=True)),
    "cascade": ("SphereField", dict(max_bounces=6, cascade=True)),
    "regen": ("CornellBox", dict(max_bounces=5)),
    "regen-stripe": ("CornellBox", dict(max_bounces=5)),
}


def _scene(name, **kw):
    sd = get_scene(name)
    settings = dataclasses.replace(sd.output.image, width=8, height=6,
                                   samples_per_pixel=SPP, spp_chunk=SPP_CHUNK, **kw)
    return sd, sd.build(device="cpu"), settings


def _ranges(events, name):
    return sorted((e.time_range.start, e.time_range.end) for e in events if e.name == name)


def _inside(r, outer):
    return any(o0 <= r[0] and r[1] <= o1 for o0, o1 in outer)


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _frame(route):
    name, kw = ROUTES[route]
    sd, scene, settings = _scene(name, **kw)
    cam = sd.camera_at(0.0, device="cpu")
    if route.startswith("regen"):
        mode = "stripe" if route == "regen-stripe" else "queue"
        return lambda: render_radiance_regen(scene, cam, settings, KEY, lanes=64, mode=mode,
                                             device="cpu")
    return lambda: render_radiance(scene, cam, settings, KEY, device="cpu")


def _step():
    sd, scene, settings = _scene("CornellBox", max_bounces=3)
    params = DiffParams.from_scene(scene, CameraParams.create(*CORNELL_CAM), (0.0, 0.0, 0.0))
    target = torch.zeros((settings.height, settings.width, 3))
    return scene, settings, lambda: render_loss_and_grad(params, scene, settings, KEY,
                                                         target, device="cpu")


def test_frame_route_is_the_one_named():
    """The routes the span tests name are the routes the renders take."""
    assert fused_bounce_ok(_scene("CornellBox")[1])
    sphere_field = _scene("SphereField")[1]
    assert not fused_bounce_ok(sphere_field) and sphere_field.proj is not None
    assert use_wavefront_reorder(sphere_field, False, True)


@pytest.mark.parametrize("route", ["fused", "generic-reorder", "cascade"])
def test_chunked_frame_spans(route):
    (img, stats), events = _profiled(_frame(route))
    frames, chunks = _ranges(events, "rpt.frame"), _ranges(events, "rpt.chunk")
    bounces, syncs = _ranges(events, "rpt.bounce"), _ranges(events, "rpt.sync")
    assert len(frames) == 1
    assert len(chunks) == SPP // SPP_CHUNK
    assert stats.bounces > 0 and len(bounces) == stats.bounces
    assert all(_inside(b, chunks) for b in bounces)
    assert all(_inside(c, frames) for c in chunks)
    assert syncs and all(_inside(s, frames) for s in syncs)
    reads = [r for r in _ranges(events, "aten::_local_scalar_dense") if _inside(r, chunks)]
    assert reads and all(_inside(r, syncs) for r in reads)
    assert torch.isfinite(img).all()


def _regen_spans(route):
    """The regen frame's spans: its bounces, and one ``rpt.flush`` a
    window end (every ``FLUSH_EVERY`` bounces) inside the frame, which
    holds every sync outside the bounces."""
    (img, stats), events = _profiled(_frame(route))
    frames, bounces = _ranges(events, "rpt.frame"), _ranges(events, "rpt.bounce")
    syncs, flushes = _ranges(events, "rpt.sync"), _ranges(events, "rpt.flush")
    assert len(frames) == 1 and _ranges(events, "rpt.chunk") == []
    assert stats.bounces > 0 and len(bounces) == stats.bounces
    assert all(_inside(b, frames) for b in bounces)
    reads = [r for r in _ranges(events, "aten::_local_scalar_dense") if _inside(r, frames)]
    assert reads and all(_inside(r, syncs) for r in reads)
    assert stats.bounces % FLUSH_EVERY == 0
    assert len(flushes) == stats.bounces // FLUSH_EVERY
    assert all(_inside(f, frames) for f in flushes)
    assert not any(_inside(b, flushes) or _inside(f, bounces) for b in bounces for f in flushes)
    window_end = [s for s in syncs if not _inside(s, bounces)]
    assert window_end and all(_inside(s, flushes) for s in window_end)
    assert all(any(_inside(s, [f]) for s in syncs) for f in flushes)  # a read in each
    assert torch.isfinite(img).all()


def test_regen_frame_spans():
    _regen_spans("regen")


def test_regen_stripe_frame_spans():
    _regen_spans("regen-stripe")


def test_step_spans_forward_then_backward():
    scene, settings, step = _step()
    assert fused_bounce_diff_ok(scene, settings.diff_t)
    (loss, grads), events = _profiled(step)
    fwd, bwd = _ranges(events, "rpt.forward"), _ranges(events, "rpt.backward")
    assert len(fwd) == 1 and len(bwd) == 1 and fwd[0][1] <= bwd[0][0]
    frames, bounces = _ranges(events, "rpt.frame"), _ranges(events, "rpt.bounce")
    assert len(frames) == 1 and _inside(frames[0], fwd)
    # the whole-scan trace: every bounce of every chunk, all in the forward
    assert len(bounces) == settings.max_bounces * (SPP // SPP_CHUNK)
    assert all(_inside(b, fwd) for b in bounces)
    assert torch.isfinite(loss) and grads.tex_color.abs().sum() > 0


@pytest.mark.parametrize("route", ["fused", "generic-reorder", "cascade", "regen", "step",
                                   "regen-stripe"])
def test_no_span_is_built_without_a_profiler(route, monkeypatch):
    def no_range(*args, **kwargs):
        raise AssertionError("a span was built with no profiler running")

    work = _step()[2] if route == "step" else _frame(route)
    monkeypatch.setattr(torch.profiler, "record_function", no_range)
    out = work()
    assert torch.isfinite(out[0]).all()
    with pytest.raises(AssertionError):  # the patch is live where spans look for it
        with profile(activities=[ProfilerActivity.CPU]):
            with span("rpt.frame"):
                pass


def test_profiler_flag_follows_the_profiler():
    """The one switch of every span: a torch upgrade that renamed or
    stopped setting it would turn every span off silently."""
    assert not torch._C._autograd._profiler_enabled()
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch._C._autograd._profiler_enabled()
    assert not torch._C._autograd._profiler_enabled()


def test_span_off_is_one_shared_context():
    a, b = span("rpt.frame"), span("rpt.bounce", 3)
    assert a is b
    with a, b:  # nests, and enters again
        pass
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with span("rpt.bounce", 3):
            pass
    assert [e.name for e in prof.events() if e.name.startswith("rpt.")] == ["rpt.bounce"]
