"""The differentiable generic route against the JAX package, on the CPU:
``render_loss_and_grad`` on TwoSphereCheckers (checker and perlin
textures, which K1 and K2 refuse), the routing between the fused and
the generic route, and the refusal of geometry gradients.

The JAX side of a generic differentiable render costs far more to
compile than to run, so it is computed once, in a module fixture.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_pathtracer_tpu.grad import CameraParams as JCameraParams
from rust_pathtracer_tpu.grad import DiffParams as JDiffParams
from rust_pathtracer_tpu.grad import render_loss_and_grad as j_render_loss_and_grad
from rust_pathtracer_tpu.models import get_scene as j_get_scene
from rust_pathtracer_tpu.render import RenderSettings as JRenderSettings
from rust_pathtracer_tpu_torch import integrator, sampling
from rust_pathtracer_tpu_torch.grad import (
    CameraParams,
    DiffParams,
    diff_params_from_numpy,
    render_loss_and_grad,
)
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
from rust_pathtracer_tpu_torch.scene import SceneBuilder
from test_torch_materials_textures import _scene_simple

torch.set_num_threads(2)

TSC_CAM = ((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 20.0, 854.0 / 480.0,
           0.0, 10.0)
CAMERA_FIELDS = ("lookfrom", "lookat", "up", "vfov_deg", "aspect", "aperture",
                 "focus_dist")
W, H, SPP, BOUNCES, BG = 16, 9, 4, 6, (1.0, 1.0, 1.0)


def _leaves(p):
    out = {"tex_color": p.tex_color, "tex_images": p.tex_images,
           "background": p.background}
    out.update({f"camera.{f}": getattr(p.camera, f) for f in CAMERA_FIELDS})
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's loss and gradients, TwoSphereCheckers 16x9, 4 spp, 6 bounces."""
    jscene = j_get_scene("TwoSphereCheckers").build()
    settings = JRenderSettings(W, H, SPP, BOUNCES, BG, differentiable=True)
    params = JDiffParams.from_scene(jscene, JCameraParams.create(*TSC_CAM), BG)
    loss, grads = j_render_loss_and_grad(params, jscene, settings, jax.random.PRNGKey(0),
                                         jnp.zeros((H, W, 3)))
    return _leaves(params), float(loss), _leaves(grads)


def test_loss_and_grad_match_jax(jax_reference):
    """Loss within 2e-3 rel; every leaf within rtol 0.05 and 2e-3 of the
    largest gradient (tests/test_torch_grad.py's tolerance).  The camera
    gradients are not zero here: the perlin sphere's value changes with
    the hit point."""
    jparams, jloss, jg = jax_reference
    scene = get_scene("TwoSphereCheckers").build()
    settings = RenderSettings(W, H, SPP, BOUNCES, BG)
    loss, g = render_loss_and_grad(diff_params_from_numpy(jparams), scene, settings,
                                   sampling.prng_key(0), torch.zeros(H, W, 3),
                                   device="cpu")
    np.testing.assert_allclose(float(loss), jloss, rtol=2e-3)
    got = _leaves(g)
    assert set(got) == set(jg)
    scale = max(np.abs(v).max() for v in jg.values())
    assert np.abs(jg["camera.lookfrom"]).min() > 0.01
    assert np.abs(jg["background"]).min() > 0.01
    for k in jg:
        np.testing.assert_allclose(got[k], jg[k], rtol=0.05, atol=2e-3 * scale,
                                   err_msg=k)


def _spy_routes(monkeypatch):
    calls = []
    for name in ("_trace_fused", "_trace_generic"):
        fn = getattr(integrator, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls.append(_name)
            return _fn(*a, **k)

        monkeypatch.setattr(integrator, name, spy)
    return calls


@pytest.mark.parametrize("name,diff,route", [
    ("CornellBox", True, "_trace_fused"),
    ("CornellBox", False, "_trace_fused"),
    ("TwoSphereCheckers", True, "_trace_generic"),
    ("TwoSphereCheckers", False, "_trace_fused"),
    ("image", True, "_trace_generic"),
    ("image", False, "_trace_generic"),
])
def test_routing(monkeypatch, name, diff, route):
    """Fused scenes go to K1 (and K2 when differentiable); perlin goes
    to the generic route when differentiable, an image texture always."""
    calls = _spy_routes(monkeypatch)
    sd = get_scene("TwoSphereCheckers" if name == "image" else name)
    scene = _scene_simple(SceneBuilder) if name == "image" else sd.build()
    settings = RenderSettings(4, 3, 1, 2, (0.5, 0.5, 0.5), differentiable=diff)
    img, _ = render_radiance(scene, sd.camera_at(0.0), settings,
                             sampling.prng_key(1), device="cpu")
    assert calls == [route] and torch.isfinite(img).all()


@pytest.mark.parametrize("name", ["CornellBox", "TwoSphereCheckers"])
def test_geometry_gradient_raises(name):
    """Asking for a gradient of the primitive data raises on both routes,
    instead of returning zero (the analytic hit distance is linearised
    in the ray alone)."""
    sd = get_scene(name)
    scene = sd.build()
    prims = dataclasses.replace(scene.prims,
                                data=scene.prims.data.clone().requires_grad_(True))
    settings = RenderSettings(4, 3, 1, 2, (0.5, 0.5, 0.5), differentiable=True)
    with pytest.raises(NotImplementedError, match="geometry"):
        render_radiance(dataclasses.replace(scene, prims=prims), sd.camera_at(0.0),
                        settings, sampling.prng_key(1), device="cpu")


def test_remat_auto_threshold():
    """auto keeps everything for TwoSphereCheckers at full width
    (854x480, 2 spp, 20 bounces) and checkpoints LightTest (50 bounces),
    never picking the lossy "bf16"; the named modes, "bf16" among them,
    pass through; an unknown one raises."""
    lanes = 854 * 480 * 2
    assert integrator.resolve_remat_mode(None, lanes, 20) == "none"
    assert integrator.resolve_remat_mode("auto", lanes, 50) == "mid"
    assert "bf16" in integrator.REMAT_MODES
    for mode in integrator.REMAT_MODES:
        assert integrator.resolve_remat_mode(mode, lanes, 50) == mode
    with pytest.raises(ValueError, match="bf17"):
        integrator.resolve_remat_mode("bf17", 8, 2)


def test_generic_step_deterministic():
    """Same key, same inputs: the loss and every gradient leaf bit for
    bit the same on a second step."""
    scene = get_scene("TwoSphereCheckers").build()
    params = DiffParams.from_scene(scene, CameraParams.create(*TSC_CAM), BG)
    settings = RenderSettings(8, 5, 2, 3, BG)
    runs = [render_loss_and_grad(params, scene, settings, sampling.prng_key(3),
                                 torch.zeros(5, 8, 3), device="cpu") for _ in range(2)]
    (l0, g0), (l1, g1) = runs
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0.leaves(), g1.leaves()))
