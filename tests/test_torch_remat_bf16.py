"""remat "bf16" (``ops/compressed_vjp.py``) on the CPU: the generic
differentiable bounce with its saved residuals in bfloat16.

JAX's accuracy contract (``compressed_vjp.py:22-29``,
``tests/test_grad.py::test_bf16_residual_contract``) on the port: the
loss bit for bit remat "none"'s (the forward runs in f32; only what is
saved is rounded) and the gradient's normalised error against "none" in
(1e-7, 1e-2), the lower bound proving that compression engaged (64x64 at
8 spp: 32,768 lanes, the (R, 3) planes past MIN_COMPRESS_ELEMS).  Then
the port's bf16 gradient against JAX's within 2e-2 normalised, the JAX
side in a module fixture.  Also: the hooks themselves, "auto" never
choosing "bf16", and ``vecmath.safe_acos``'s slope, saved in the forward
so that a rounded residual cannot land on acos's pole (PyTorch's
``AcosBackward`` recomputes 1 / sqrt(1 - x^2) from the saved x, and a
bf16 x rounds to 1 near the pole: NaN camera gradients before it).
"""

import dataclasses

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_pathtracer_tpu.grad import CameraParams as JCameraParams
from rust_pathtracer_tpu.grad import DiffParams as JDiffParams
from rust_pathtracer_tpu.grad import render_loss_and_grad as j_render_loss_and_grad
from rust_pathtracer_tpu.render import RenderSettings as JRenderSettings
from rust_pathtracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from rust_pathtracer_tpu_torch import integrator, sampling
from rust_pathtracer_tpu_torch import vecmath as vm
from rust_pathtracer_tpu_torch.grad import diff_params_from_numpy, render_loss_and_grad
from rust_pathtracer_tpu_torch.ops import compressed_vjp as cv
from rust_pathtracer_tpu_torch.render import RenderSettings
from rust_pathtracer_tpu_torch.scene import SceneBuilder
from test_torch_materials_textures import _scene_simple

torch.set_num_threads(2)

W, H, SPP, BOUNCES, BG = 64, 64, 8, 4, (0.1, 0.1, 0.1)  # tests/test_grad.py's _setup
CAM = ((0.0, 1.0, 2.0), (0.0, 0.5, -3.0), (0.0, 1.0, 0.0), 50.0, 1.0)
CAMERA_FIELDS = ("lookfrom", "lookat", "up", "vfov_deg", "aspect", "aperture",
                 "focus_dist")


def _flat(leaves):
    return np.concatenate([np.asarray(v, np.float64).ravel() for v in leaves])


def _jax_leaves(p):
    return {"tex_color": p.tex_color, "tex_images": p.tex_images,
            "background": p.background,
            **{f"camera.{f}": getattr(p.camera, f) for f in CAMERA_FIELDS}}


@pytest.fixture(scope="module")
def jax_bf16():
    """JAX's params and its remat "bf16" loss and gradient leaves."""
    scene = _scene_simple(JSceneBuilder)
    params = JDiffParams.from_scene(scene, JCameraParams.create(*CAM), BG)
    settings = JRenderSettings(W, H, SPP, BOUNCES, BG, remat="bf16")
    loss, grads = j_render_loss_and_grad(params, scene, settings, jax.random.PRNGKey(0),
                                         jnp.zeros((H, W, 3)))
    leaves = {k: np.asarray(v) for k, v in _jax_leaves(params).items()}
    return leaves, float(loss), {k: np.asarray(v) for k, v in _jax_leaves(grads).items()}


@pytest.fixture(scope="module")
def port_steps(jax_bf16):
    """The port's loss and gradient leaves under "none" and "bf16", from
    JAX's params."""
    params = diff_params_from_numpy(jax_bf16[0])
    scene = _scene_simple(SceneBuilder)
    out = {}
    for remat in ("none", "bf16"):
        loss, g = render_loss_and_grad(params, scene,
                                       RenderSettings(W, H, SPP, BOUNCES, BG, remat=remat),
                                       sampling.prng_key(0), torch.zeros(H, W, 3),
                                       device="cpu")
        out[remat] = (float(loss), [x.numpy() for x in g.leaves()])
    return out


def test_bf16_residual_contract(port_steps):
    assert W * H * SPP * 3 >= cv.MIN_COMPRESS_ELEMS
    (l0, g0), (l1, g1) = port_steps["none"], port_steps["bf16"]
    assert l0 == l1
    f0, f1 = _flat(g0), _flat(g1)
    assert np.isfinite(f1).all()
    rel = float(np.linalg.norm(f0 - f1) / np.linalg.norm(f0))
    assert 1e-7 < rel < 1e-2, rel


def test_bf16_gradient_matches_jax_bf16(port_steps, jax_bf16):
    """Against JAX's remat "bf16": the loss within 2e-3 (the port-vs-JAX
    generic tolerance) and the gradient within 2e-2 normalised."""
    _, jloss, jg = jax_bf16
    loss, g = port_steps["bf16"]
    np.testing.assert_allclose(loss, jloss, rtol=2e-3)
    want = _flat(jg.values())
    rel = float(np.linalg.norm(_flat(g) - want) / np.linalg.norm(want))
    assert rel < 2e-2, rel


def test_hooks_pack_and_unpack():
    """Large f32 tensors are saved as bf16 copies and come back f32;
    small f32, f64, integer and bool tensors pass through as they are."""
    big = torch.randn(cv.MIN_COMPRESS_ELEMS)
    packed = cv._pack(big)
    assert packed.dtype == torch.bfloat16 and not packed.requires_grad
    assert torch.equal(cv._unpack(packed), big.to(torch.bfloat16).to(torch.float32))
    for x in (torch.randn(cv.MIN_COMPRESS_ELEMS - 1), big.double(),
              torch.arange(cv.MIN_COMPRESS_ELEMS), big > 0):
        assert cv._pack(x) is x and cv._unpack(x) is x


def test_hooks_round_only_the_backward():
    """Under ``compressed_residuals`` a product's forward is the f32 one
    and its backward reads the bf16-rounded factor."""
    a = torch.linspace(0.1, 1.7, cv.MIN_COMPRESS_ELEMS).requires_grad_(True)
    b = torch.linspace(1.3, 2.9, cv.MIN_COMPRESS_ELEMS).requires_grad_(True)
    with cv.compressed_residuals():
        y = a * b
    assert torch.equal(y, a.detach() * b.detach())
    y.sum().backward()
    assert torch.equal(a.grad, b.detach().to(torch.bfloat16).to(torch.float32))


def test_auto_never_picks_bf16():
    for lanes, nb in ((8, 2), (854 * 480 * 2, 20), (854 * 480 * 2, 50), (1 << 24, 64)):
        assert integrator.resolve_remat_mode("auto", lanes, nb) in ("none", "mid")
        assert integrator.resolve_remat_mode(None, lanes, nb) in ("none", "mid")
    assert integrator.resolve_remat_mode("bf16", 8, 2) == "bf16"


def test_safe_acos_slope():
    """In f32 the saved slope gives AcosBackward's bits; from a bf16
    residual near the pole it stays finite where AcosBackward's is not."""
    x = torch.linspace(-0.999998, 0.999998, 4097)
    x1, x2 = x.clone().requires_grad_(True), x.clone().requires_grad_(True)
    g = torch.linspace(-1.0, 1.0, 4097)
    torch.acos(x1).backward(g)
    vm._Acos.apply(x2).backward(g)
    assert torch.equal(x1.grad, x2.grad)
    near = torch.full((cv.MIN_COMPRESS_ELEMS,), 0.9999995).requires_grad_(True)
    with cv.compressed_residuals():
        y = vm.safe_acos(near)
    y.sum().backward()
    assert torch.isfinite(near.grad).all()
    plain = torch.full((cv.MIN_COMPRESS_ELEMS,), 0.9999995).requires_grad_(True)
    with cv.compressed_residuals():
        z = torch.acos(plain)
    z.sum().backward()
    assert not torch.isfinite(plain.grad).all()


def test_bf16_fused_route_keeps_its_residuals():
    """remat acts on the generic route only: a CornellBox step under
    "bf16" (the fused route, K1 with residuals and K2) is bit for bit
    the default one."""
    from rust_pathtracer_tpu_torch.grad import CameraParams, DiffParams
    from rust_pathtracer_tpu_torch.models import get_scene

    sd = get_scene("CornellBox")
    scene = sd.build()
    params = DiffParams.from_scene(scene, CameraParams.create(
        (278.0, 278.0, -800.0), (278.0, 278.0, 0.0), (0.0, 1.0, 0.0), 40.0, 1.0), BG)
    out = []
    for remat in (None, "bf16"):
        loss, g = render_loss_and_grad(params, scene,
                                       RenderSettings(12, 12, 2, 4, BG, remat=remat),
                                       sampling.prng_key(2), torch.zeros(12, 12, 3),
                                       device="cpu")
        out.append((loss, g.leaves()))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)


def test_bf16_with_differentiable_cascade(port_steps):
    """The two compose: "bf16" through a differentiable cascade keeps the
    loss within 1e-6 of "none" and the gradient within the bf16 bound."""
    params = diff_params_from_numpy({k: v for k, v in zip(
        ["tex_color", "tex_images", "background"] + [f"camera.{f}" for f in CAMERA_FIELDS],
        _param_arrays())})
    scene = _scene_simple(SceneBuilder)
    s = RenderSettings(W, H, SPP, BOUNCES, BG, remat="bf16", diff_cascade="2:2,3:4")
    loss, g = render_loss_and_grad(params, scene, s, sampling.prng_key(0),
                                   torch.zeros(H, W, 3), device="cpu")
    l0, g0 = port_steps["none"]
    np.testing.assert_allclose(float(loss), l0, rtol=1e-6)
    f0 = _flat(g0)
    rel = float(np.linalg.norm(_flat([x.numpy() for x in g.leaves()]) - f0)
                / np.linalg.norm(f0))
    assert 1e-7 < rel < 1e-2, rel


def _param_arrays():
    scene = _scene_simple(JSceneBuilder)
    p = JDiffParams.from_scene(scene, JCameraParams.create(*CAM), BG)
    return [np.asarray(v) for v in _jax_leaves(p).values()]


def test_settings_field_reaches_the_trace(monkeypatch):
    """RenderSettings.remat = "bf16" reaches ``_bounce_step`` as the mode."""
    modes = []
    step = integrator._bounce_step

    def spy(*a, **k):
        modes.append(a[7] if len(a) > 7 else k.get("mode"))
        return step(*a, **k)

    monkeypatch.setattr(integrator, "_bounce_step", spy)
    params = diff_params_from_numpy(dict(zip(
        ["tex_color", "tex_images", "background"] + [f"camera.{f}" for f in CAMERA_FIELDS],
        _param_arrays())))
    render_loss_and_grad(params, _scene_simple(SceneBuilder),
                         dataclasses.replace(RenderSettings(6, 4, 1, 3, BG), remat="bf16"),
                         sampling.prng_key(0), torch.zeros(4, 6, 3), device="cpu")
    assert modes == ["bf16"] * 3
