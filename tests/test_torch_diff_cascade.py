"""The differentiable cascade (``RenderSettings.diff_cascade``, JAX
``RPT_DIFF_CASCADE``; ``integrator._trace_diff_cascade``) on the CPU.

JAX's ``tests/test_grad.py::test_diff_cascade_matches_plain_scan`` on the
port: the image-textured scene at 16x16, 4 spp, 12 bounces through
"4:2,8:4" has no dropped live lane (occupancy[-1] == 0), its loss within
1e-6 relative of the plain trace's and every gradient within rtol 1e-3 /
atol 1e-7 (each lane traces its path; only the order of its stage sums
differs), and an over-tight "1:16" reports the lanes it drops.  Against
JAX under ``RPT_DIFF_CASCADE`` (with ``jax.clear_caches()``, the variable
being read when JAX traces) at the port-vs-JAX tolerances of
``tests/test_torch_generic_grad.py``.  Also the applicability rules, the
routing of a fused scene to the generic route, and a malformed schedule
raising.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_pathtracer_tpu.grad import CameraParams as JCameraParams
from rust_pathtracer_tpu.grad import DiffParams as JDiffParams
from rust_pathtracer_tpu.grad import apply_params as j_apply_params
from rust_pathtracer_tpu.grad import render_loss_and_grad as j_render_loss_and_grad
from rust_pathtracer_tpu.render import RenderSettings as JRenderSettings
from rust_pathtracer_tpu.render import render_radiance as j_render_radiance
from rust_pathtracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from rust_pathtracer_tpu_torch import integrator, sampling
from rust_pathtracer_tpu_torch.grad import (
    apply_params,
    diff_params_from_numpy,
    render_loss_and_grad,
)
from rust_pathtracer_tpu_torch.integrator import MAX_BOUNCE_STATS, diff_cascade_stages
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
from rust_pathtracer_tpu_torch.scene import SceneBuilder
from test_torch_materials_textures import _scene_simple

torch.set_num_threads(2)

W, H, SPP, BOUNCES, BG = 16, 16, 4, 12, (0.1, 0.1, 0.1)  # tests/test_grad.py's
CAM = ((0.0, 1.0, 2.0), (0.0, 0.5, -3.0), (0.0, 1.0, 0.0), 50.0, 1.0)
CAMERA_FIELDS = ("lookfrom", "lookat", "up", "vfov_deg", "aspect", "aperture",
                 "focus_dist")
SCHEDULES = (None, "4:2,8:4", "1:16")


def _jax_leaves(p):
    return {"tex_color": p.tex_color, "tex_images": p.tex_images,
            "background": p.background,
            **{f"camera.{f}": getattr(p.camera, f) for f in CAMERA_FIELDS}}


def _flat(leaves):
    return np.concatenate([np.asarray(v, np.float32).ravel() for v in leaves])


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's params, and per schedule its loss, flat gradient and the
    differentiable render's occupancy[-1] (None: no schedule)."""
    scene = _scene_simple(JSceneBuilder)
    params = JDiffParams.from_scene(scene, JCameraParams.create(*CAM), BG)
    settings = JRenderSettings(W, H, SPP, BOUNCES, BG)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for sched in SCHEDULES:
            if sched is None:
                mp.delenv("RPT_DIFF_CASCADE", raising=False)
            else:
                mp.setenv("RPT_DIFF_CASCADE", sched)
            jax.clear_caches()
            loss, grads = j_render_loss_and_grad(params, scene, settings,
                                                 jax.random.PRNGKey(0),
                                                 jnp.zeros((H, W, 3)))
            _, st = j_render_radiance(j_apply_params(scene, params),
                                      params.camera.build(),
                                      dataclasses.replace(settings, differentiable=True),
                                      jax.random.PRNGKey(0), background=params.background)
            out[sched] = (float(loss), _flat(_jax_leaves(grads).values()),
                          float(st.occupancy[-1]))
    jax.clear_caches()
    return {k: np.asarray(v) for k, v in _jax_leaves(params).items()}, out


@pytest.fixture(scope="module")
def port_runs(jax_runs):
    """The port's, per schedule, from JAX's params."""
    params = diff_params_from_numpy(jax_runs[0])
    scene = _scene_simple(SceneBuilder)
    out = {}
    for sched in SCHEDULES:
        s = RenderSettings(W, H, SPP, BOUNCES, BG, diff_cascade=sched)
        loss, g = render_loss_and_grad(params, scene, s, sampling.prng_key(0),
                                       torch.zeros(H, W, 3), device="cpu")
        _, st = render_radiance(apply_params(scene, params), params.camera.build(),
                                dataclasses.replace(s, differentiable=True),
                                sampling.prng_key(0), background=params.background,
                                device="cpu")
        out[sched] = (float(loss), _flat(x.numpy() for x in g.leaves()),
                      float(st.occupancy[-1]), st)
    return out


def test_diff_cascade_matches_plain_scan(port_runs):
    loss0, g0, _, st0 = port_runs[None]
    loss1, g1, overflow, st1 = port_runs["4:2,8:4"]
    assert overflow == 0.0
    np.testing.assert_allclose(loss1, loss0, rtol=1e-6)
    np.testing.assert_allclose(g1, g0, rtol=1e-3, atol=1e-7)
    assert np.abs(g0).max() > 0
    # the trace's statistics: the same paths, so the same segments and
    # occupancy below the overflow slot
    assert torch.equal(st1.segments, st0.segments)
    assert torch.equal(st1.occupancy[:-1], st0.occupancy[:-1])


def test_tight_schedule_reports_dropped_lanes(port_runs, jax_runs):
    """"1:16" keeps 1/16 of the lanes after bounce 1: the dropped live
    lanes are counted into occupancy[-1], on both sides."""
    assert port_runs["1:16"][2] > 0
    assert jax_runs[1]["1:16"][2] > 0


@pytest.mark.parametrize("sched", SCHEDULES)
def test_matches_jax(sched, port_runs, jax_runs):
    """The port against JAX under the same schedule: the loss within 2e-3,
    every gradient within rtol 0.05 and 2e-3 of the largest, the
    overflow count within 1% (the paths agree on all but a few lanes)."""
    jl, jg, jo = jax_runs[1][sched]
    pl, pg, po, _ = port_runs[sched]
    np.testing.assert_allclose(pl, jl, rtol=2e-3)
    np.testing.assert_allclose(pg, jg, rtol=0.05, atol=2e-3 * np.abs(jg).max())
    assert abs(po - jo) <= 0.01 * max(jo, 1.0)


def test_stages_rules():
    """JAX's ``_diff_cascade_stages``: widths R // s; no schedule past the
    overflow slot, with a boundary at or past max_bounces, or a shrink
    that does not divide the lanes; a malformed string raises here (it
    is an argument, not an environment variable)."""
    assert diff_cascade_stages("4:2,8:4", 12, 1024) == [(4, 512), (8, 256)]
    assert diff_cascade_stages("1:16/11", 12, 1024 * 11) == [(1, 704 * 11)]
    assert diff_cascade_stages(None, 12, 1024) == []
    assert diff_cascade_stages("4:2", MAX_BOUNCE_STATS - 1, 1024) == []
    assert diff_cascade_stages("12:2", 12, 1024) == []
    assert diff_cascade_stages("4:3", 12, 1024) == []
    for bad in ("4-2", "4:2,2:4", "4:0", "x:2"):
        with pytest.raises(ValueError):
            diff_cascade_stages(bad, 12, 1024)


def test_inapplicable_schedule_is_the_plain_trace(port_runs):
    """A schedule that does not apply (a shrink of 3 on 1,024 lanes) runs
    the plain trace: bit for bit, the same loss and gradients."""
    loss0, g0, _, _ = port_runs[None]
    scene = _scene_simple(SceneBuilder)
    from rust_pathtracer_tpu_torch.grad import CameraParams, DiffParams

    params = DiffParams.from_scene(scene, CameraParams.create(*CAM), BG)
    out = []
    for sched in (None, "4:3"):
        loss, g = render_loss_and_grad(params, scene,
                                       RenderSettings(W, H, SPP, BOUNCES, BG,
                                                      diff_cascade=sched),
                                       sampling.prng_key(0), torch.zeros(H, W, 3),
                                       device="cpu")
        out.append((loss, g.leaves()))
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    with pytest.raises(ValueError, match="schedule"):
        render_loss_and_grad(params, scene, RenderSettings(W, H, SPP, BOUNCES, BG,
                                                           diff_cascade="4:2:1"),
                             sampling.prng_key(0), torch.zeros(H, W, 3), device="cpu")


def test_fused_scene_takes_the_generic_route(monkeypatch):
    """CornellBox's differentiable render takes the fused route, and the
    generic one when a differentiable cascade applies (JAX
    integrator.py:778): the image within 1e-6 of the fused render's, no
    lane dropped; the forward ignores the schedule."""
    calls = []
    for name in ("_trace_fused", "_trace_generic"):
        fn = getattr(integrator, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(integrator, name, spy)
    sd = get_scene("CornellBox")
    scene, cam = sd.build(), sd.camera_at(0.0)
    base = RenderSettings(8, 8, 4, 8, (0.0, 0.0, 0.0), differentiable=True)
    want, _ = render_radiance(scene, cam, base, sampling.prng_key(3), device="cpu")
    assert calls == ["_trace_fused"]
    calls.clear()
    img, st = render_radiance(scene, cam, dataclasses.replace(base, diff_cascade="7:2"),
                              sampling.prng_key(3), device="cpu")
    assert set(calls) == {"_trace_generic"} and float(st.occupancy[-1]) == 0.0
    np.testing.assert_allclose(img.detach().numpy(), want.detach().numpy(), rtol=1e-5,
                               atol=1e-6)
    calls.clear()
    fwd = dataclasses.replace(base, differentiable=False)
    a, _ = render_radiance(scene, cam, fwd, sampling.prng_key(3), device="cpu")
    b, _ = render_radiance(scene, cam, dataclasses.replace(fwd, diff_cascade="7:2"),
                           sampling.prng_key(3), device="cpu")
    assert torch.equal(a, b) and set(calls) == {"_trace_fused"}
