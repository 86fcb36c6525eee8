"""Gradients of image-textured scenes on the generic route, on the CPU.

* ``render_loss_and_grad`` against the JAX package's on
  ``tests/test_grad.py::_scene_simple``, rebuilt with the port's
  builder: the loss and every leaf, the image texels included;
* central finite differences of the port's own loss, the counterparts
  of ``tests/test_grad.py``'s albedo, emission, background, camera and
  texel checks, at those tests' tolerances (the renders are
  deterministic given a key, so FD measures the derivative the detached
  estimator defines);
* the remat modes "none", "mid" and "names" against each other.
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
from rust_pathtracer_tpu.render import RenderSettings as JRenderSettings
from rust_pathtracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from rust_pathtracer_tpu_torch.grad import (
    CameraParams,
    DiffParams,
    diff_params_from_numpy,
    l2_loss,
    render_loss_and_grad,
)
from rust_pathtracer_tpu_torch.render import RenderSettings
from rust_pathtracer_tpu_torch.sampling import prng_key
from rust_pathtracer_tpu_torch.scene import SceneBuilder
from test_torch_materials_textures import _scene_simple

torch.set_num_threads(2)

KEY = 0
CAM = ((0.0, 1.0, 2.0), (0.0, 0.5, -3.0), (0.0, 1.0, 0.0), 50.0, 1.0)
CAMERA_FIELDS = ("lookfrom", "lookat", "up", "vfov_deg", "aspect", "aperture",
                 "focus_dist")


def _setup(width=12, height=12, spp=8, bounces=4):
    """tests/test_grad.py::_setup on the port."""
    scene = _scene_simple(SceneBuilder)
    settings = RenderSettings(width, height, spp, bounces, (0.1, 0.1, 0.1))
    params = DiffParams.from_scene(scene, CameraParams.create(*CAM), settings.background)
    return params, scene, settings, torch.zeros(height, width, 3)


def _leaves(p):
    out = {"tex_color": p.tex_color, "tex_images": p.tex_images,
           "background": p.background}
    out.update({f"camera.{f}": getattr(p.camera, f) for f in CAMERA_FIELDS})
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


@pytest.fixture(scope="module")
def jax_reference():
    """JAX's loss and gradients on _scene_simple, 12x12, 8 spp, 4 bounces."""
    jscene = _scene_simple(JSceneBuilder)
    settings = JRenderSettings(12, 12, 8, 4, (0.1, 0.1, 0.1), differentiable=True)
    params = JDiffParams.from_scene(jscene, JCameraParams.create(*CAM),
                                    settings.background)
    loss, grads = j_render_loss_and_grad(params, jscene, settings,
                                         jax.random.PRNGKey(KEY), jnp.zeros((12, 12, 3)))
    return _leaves(params), float(loss), _leaves(grads)


def test_loss_and_grad_match_jax(jax_reference):
    """Loss within 2e-3 rel; every leaf, the texels included, within
    rtol 0.05 and 2e-3 of the largest gradient."""
    jparams, jloss, jg = jax_reference
    _, scene, settings, target = _setup()
    loss, g = render_loss_and_grad(diff_params_from_numpy(jparams), scene, settings,
                                   prng_key(KEY), target, device="cpu")
    np.testing.assert_allclose(float(loss), jloss, rtol=2e-3)
    got = _leaves(g)
    assert set(got) == set(jg)
    assert np.abs(jg["tex_images"]).max() > 1e-4
    scale = max(np.abs(v).max() for v in jg.values())
    for k in jg:
        np.testing.assert_allclose(got[k], jg[k], rtol=0.05, atol=2e-3 * scale,
                                   err_msg=k)


def _fd_check(params, scene, settings, target, get, replace, eps, rtol, atol=1e-7):
    """Central finite difference against autograd for one scalar slot
    (tests/test_grad.py::_fd_check)."""
    _, grads = render_loss_and_grad(params, scene, settings, prng_key(KEY), target,
                                    device="cpu")
    g_auto = float(get(grads))
    x0 = float(get(params))

    def loss_at(x):
        with torch.no_grad():
            return float(l2_loss(replace(params, x), scene, settings, prng_key(KEY),
                                 target, device="cpu"))

    g_fd = (loss_at(x0 + eps) - loss_at(x0 - eps)) / (2 * eps)
    assert np.isclose(g_auto, g_fd, rtol=rtol, atol=atol), (g_auto, g_fd)
    assert g_auto != 0.0


def _set(t, index, x):
    t = t.clone()
    t[index] = x
    return t


@pytest.mark.parametrize("slot", ["albedo", "emission", "background"])
def test_colour_gradients_fd(slot):
    """Texture 0 (the sphere's albedo, green), texture 2 (the light's
    emission, red) and the background (blue): eps 1e-2, rtol 2e-2."""
    params, scene, settings, target = _setup()
    if slot == "background":
        get = lambda p: p.background[2]  # noqa: E731
        replace = lambda p, x: dataclasses.replace(  # noqa: E731
            p, background=_set(p.background, 2, x))
    else:
        index = (0, 1) if slot == "albedo" else (2, 0)
        get = lambda p: p.tex_color[index]  # noqa: E731
        replace = lambda p, x: dataclasses.replace(  # noqa: E731
            p, tex_color=_set(p.tex_color, index, x))
    _fd_check(params, scene, settings, target, get, replace, eps=1e-2, rtol=2e-2)


def _setup_camera_fd(width=10, height=10, spp=4):
    """tests/test_grad.py::_setup_camera_fd: one huge image-textured
    plane fills the view and scattered rays escape, so small camera
    moves change no discrete decision."""
    b = SceneBuilder()
    ramp = np.linspace(0.05, 0.95, 16 * 16 * 3).reshape(16, 16, 3).astype(np.float32)
    b.add_rect("xy", (-200.0, -200.0, -5.0), (200.0, 200.0, -5.0), 1.0,
               b.lambertian(b.image_texture(ramp)))
    scene = b.build(use_bvh=False)
    cam = CameraParams.create((0.0, 0.0, 0.0), (0.0, 0.0, -5.0), (0.0, 1.0, 0.0), 50.0, 1.0)
    settings = RenderSettings(width, height, spp, 2, (0.3, 0.3, 0.3))
    params = DiffParams.from_scene(scene, cam, settings.background)
    return params, scene, settings, torch.zeros(height, width, 3)


@pytest.mark.parametrize("slot", ["vfov_deg", "lookfrom"])
def test_camera_gradients_fd(slot):
    """The field of view (eps 1) and lookfrom.y (eps 0.05): rtol 7e-2."""
    params, scene, settings, target = _setup_camera_fd()
    cam = params.camera
    if slot == "vfov_deg":
        get = lambda p: p.camera.vfov_deg  # noqa: E731
        replace = lambda p, x: dataclasses.replace(  # noqa: E731
            p, camera=dataclasses.replace(cam, vfov_deg=torch.tensor(x)))
        eps = 1.0
    else:
        get = lambda p: p.camera.lookfrom[1]  # noqa: E731
        replace = lambda p, x: dataclasses.replace(  # noqa: E731
            p, camera=dataclasses.replace(cam, lookfrom=_set(cam.lookfrom, 1, x)))
        eps = 0.05
    _fd_check(params, scene, settings, target, get, replace, eps=eps, rtol=7e-2,
              atol=1e-8)


def test_texel_gradient_fd():
    """An image-textured sphere: gradients reach single texels; FD on the
    texel with the largest gradient, eps 1e-2, rtol 3e-2."""
    b = SceneBuilder()
    tex = b.image_texture(np.full((4, 4, 3), 0.5, np.float32))
    b.add_sphere((0.0, 0.0, -3.0), 1.0, b.lambertian(tex))
    scene = b.build(use_bvh=False)
    cam = CameraParams.create((0, 0, 0), (0, 0, -3), (0, 1, 0), 60.0, 1.0)
    settings = RenderSettings(8, 8, 8, 3, (1.0, 1.0, 1.0))
    params = DiffParams.from_scene(scene, cam, settings.background)
    target = torch.zeros(8, 8, 3)
    _, grads = render_loss_and_grad(params, scene, settings, prng_key(KEY), target,
                                    device="cpu")
    g_img = grads.tex_images.numpy()
    assert np.abs(g_img).sum() > 0.0
    index = (0, *np.unravel_index(np.abs(g_img[0]).argmax(), g_img[0].shape))
    _fd_check(params, scene, settings, target, lambda p: p.tex_images[index],
              lambda p, x: dataclasses.replace(p, tex_images=_set(p.tex_images, index, x)),
              eps=1e-2, rtol=3e-2)


def test_remat_modes_match():
    """remat "none", "mid" and "names" run the same forward (loss bit
    for bit) and the same backward on recomputed values (gradients
    within 1e-6 relative); roulette from bounce 3 included."""
    params, scene, settings, target = _setup(spp=4, bounces=6)
    settings = dataclasses.replace(settings, russian_roulette_start=3)
    out = {}
    for mode in ("none", "mid", "names"):
        loss, g = render_loss_and_grad(params, scene,
                                       dataclasses.replace(settings, remat=mode),
                                       prng_key(KEY), target, device="cpu")
        out[mode] = (loss, torch.cat([x.reshape(-1) for x in g.leaves()]))
    l0, g0 = out["none"]
    assert g0.abs().max() > 0 and torch.isfinite(g0).all()
    for mode in ("mid", "names"):
        loss, g = out[mode]
        assert torch.equal(loss, l0), mode
        torch.testing.assert_close(g, g0, rtol=1e-6, atol=1e-6 * float(g0.abs().max()))
