"""The port's differentiable path against the JAX package, on the CPU.

* the whole-scan ``FusedScanTrace`` (K1 with residuals forward, K2
  backward, both through their plain versions here) against central
  finite differences of its own forward;
* ``grad.render_loss_and_grad`` against the JAX package's on
  CornellBox, with and without russian roulette (the JAX side runs its
  Pallas kernels in the interpreter, ``RPT_FB_INTERPRET=1``, as its own
  tests do);
* the differentiable render's image against the forward render's.
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
from rust_pathtracer_tpu_torch import sampling
from rust_pathtracer_tpu_torch.grad import (
    CameraParams,
    DiffParams,
    diff_params_from_numpy,
    render_loss_and_grad,
)
from rust_pathtracer_tpu_torch.integrator import T_MIN, MAX_BOUNCE_STATS, trace
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
from rust_pathtracer_tpu_torch.render import RenderSettings, _make_lanes, render_radiance
from rust_pathtracer_tpu_torch.scene import SceneBuilder

torch.set_num_threads(2)

CORNELL_CAM = ((278.0, 278.0, -800.0), (278.0, 278.0, 0.0), (0.0, 1.0, 0.0),
               40.0, 1.0, 0.0, 10.0)
CAMERA_FIELDS = ("lookfrom", "lookat", "up", "vfov_deg", "aspect", "aperture",
                 "focus_dist")


def _solid_checker_scene():
    """tests/test_fused_bounce.py::_solid_checker_scene on the port's
    builder: solid and checker textures, all four materials."""
    b = SceneBuilder()
    checker = b.checker_texture(
        b.solid_texture((0.2, 0.3, 0.1)), b.solid_texture((0.9, 0.9, 0.9))
    )
    b.add_sphere((0, -100.5, -3), 100.0, b.lambertian(checker))
    b.add_sphere((0, 0.5, -3), 0.5, b.lambertian((0.5, 0.3, 0.2)))
    b.add_sphere((1.2, 0.5, -3), 0.5, b.metal((0.8, 0.7, 0.6), fuzz=0.2))
    b.add_sphere((-1.2, 0.5, -3), 0.5, b.dielectric(1.5))
    b.add_rect("xz", (-2, 3.0, -5), (2, 3.0, -1), -1.0,
               b.diffuse_light((4, 4, 4)))
    b.add_triangle((2.2, 0.0, -4), (3.2, 0.0, -4), (2.7, 1.2, -4),
                   b.lambertian((0.6, 0.2, 0.2)))
    return b.build(use_bvh=False)


def test_scan_vjp_finite_difference():
    """FusedScanTrace's backward against central finite differences of
    its own forward over 3 bounces of 96 lanes (same draws, so the same
    frozen discrete decisions: FD measures the derivative the detached
    estimator defines).  At least 20 coordinates over o, d, thr, the
    packed table's colour rows and the background, each among the
    largest gradients of its argument, within rtol 0.05 / atol 1e-3 of
    the FD at one of two steps, 1e-3 and 1e-4 of max(|x|, 1).  Two
    steps, because over three bounces each fails somewhere: the forward
    is f32 and the sphere discriminant's cancellation puts ~1e-6 of
    noise on the outputs (too much for the small step), and the large
    step can cross a discrete event (a hit or a checker edge) of a later
    bounce.  The loss is summed in f64."""
    scene = _solid_checker_scene()
    R, B = 96, 3
    ang = np.linspace(-0.5, 0.5, R)
    o = np.tile([[0.0, 0.8, 1.5]], (R, 1))
    d = np.stack([np.sin(ang), 0.3 * np.cos(5 * ang) - 0.3, -np.cos(ang)], 1)
    rng = np.random.default_rng(7)
    thr = 0.5 + 0.5 * rng.random((R, 1)) * np.array([[1.0, 0.8, 0.6]])
    table = fb.pack_prims_shaded(scene)
    bg = np.array([0.25, 0.15, 0.35])
    keys = fb.key_words(sampling.lane_keys(sampling.prng_key(5), torch.arange(R)))
    spec = fb._ScanSpec(kinds=scene.kinds_static, mat_types=scene.mat_types,
                        tex_types=scene.tex_types, t_min=T_MIN, max_bounces=B,
                        rr_start=B + 1, stats_slots=MAX_BOUNCE_STATS)
    ws = torch.from_numpy(rng.normal(size=(12, R)))

    def loss(o_, d_, thr_, table_, bg_):
        zeros = torch.zeros(R)
        cols = (o_[:, 0], o_[:, 1], o_[:, 2], d_[:, 0], d_[:, 1], d_[:, 2],
                thr_[:, 0], thr_[:, 1], thr_[:, 2], zeros, zeros, zeros,
                torch.ones(R))
        out = fb.FusedScanTrace.apply(spec, keys, table_, bg_, *cols)
        return (ws * torch.stack(out[:12]).double()).sum()

    f32 = [torch.tensor(np.asarray(x), dtype=torch.float32)
           for x in (o, d, thr, table.numpy(), bg)]
    leaves = [x.clone().requires_grad_(True) for x in f32]
    grads = torch.autograd.grad(loss(*leaves), leaves)
    assert not grads[3][:fb.PAY_COLOR].any()  # no geometry gradient
    names = ("o", "d", "thr", "table", "bg")
    checked = 0
    for ai, g in enumerate(grads):
        flat = g.numpy().ravel()
        idxs = np.argsort(-np.abs(flat))
        cand = [i for i in idxs[:40] if abs(flat[i]) > 1e-3]
        for i in rng.permutation(cand)[:8]:
            x0 = float(f32[ai].numpy().ravel()[i])

            def at(x):
                args = [a.clone() for a in f32]
                args[ai].view(-1)[i] = x
                with torch.no_grad():
                    return float(loss(*args))

            fds = [(at(x0 + eps) - at(x0 - eps)) / (2 * eps)
                   for eps in (1e-3 * max(abs(x0), 1.0), 1e-4 * max(abs(x0), 1.0))]
            assert any(np.isclose(flat[i], fd, rtol=0.05, atol=1e-3) for fd in fds), (
                names[ai], i, flat[i], fds)
            checked += 1
    assert checked >= 20


@pytest.fixture(scope="module")
def cornell():
    return j_get_scene("CornellBox").build(), get_scene("CornellBox").build()


@pytest.mark.parametrize("rr", [None, 4])
def test_loss_and_grad_match_jax(cornell, monkeypatch, rr):
    """CornellBox 16x16, 4 spp, 8 bounces: the port's
    ``render_loss_and_grad`` on the CPU against the JAX package's.  Both
    follow the same random stream bit for bit; a lane differs only where
    an ulp (XLA's fused multiply-adds) flipped a discrete choice.  Loss
    within rtol 2e-3; tex_color, background and each camera leaf within
    rtol 0.05 and 2e-3 of the largest gradient, the tolerance the JAX
    package holds between its own two differentiable paths
    (tests/test_fused_bounce.py:345-351).  The JAX image-texel gradient
    (a leaf the port leaves out) is zero on this scene."""
    jscene, tscene = cornell
    jsettings = JRenderSettings(16, 16, 4, 8, (0.5, 0.5, 0.5), spp_chunk=4,
                                differentiable=True, russian_roulette_start=rr)
    jparams = JDiffParams.from_scene(jscene, JCameraParams.create(*CORNELL_CAM),
                                     jsettings.background)
    target = np.zeros((16, 16, 3), np.float32)
    monkeypatch.setenv("RPT_FB_INTERPRET", "1")
    jax.clear_caches()
    jloss, jg = j_render_loss_and_grad(jparams, jscene, jsettings,
                                       jax.random.PRNGKey(7), jnp.asarray(target))
    monkeypatch.delenv("RPT_FB_INTERPRET")
    jax.clear_caches()
    assert not np.asarray(jg.tex_images).any()

    def leaves(p):
        out = {"tex_color": p.tex_color, "background": p.background,
               "tex_images": getattr(p, "tex_images", None)}
        out.update({f"camera.{f}": getattr(p.camera, f) for f in CAMERA_FIELDS})
        return {k: np.asarray(v) for k, v in out.items() if v is not None}

    params = diff_params_from_numpy(leaves(jparams))
    settings = RenderSettings(16, 16, 4, 8, (0.5, 0.5, 0.5), spp_chunk=4,
                              russian_roulette_start=rr)
    loss, g = render_loss_and_grad(params, tscene, settings, sampling.prng_key(7),
                                   torch.from_numpy(target), device="cpu")
    np.testing.assert_allclose(float(loss), float(jloss), rtol=2e-3)
    want, got = leaves(jg), leaves(g)
    assert set(got) == set(want) and not got["tex_images"].any()
    scale = max(np.abs(v).max() for v in want.values())
    assert np.abs(want["tex_color"]).max() > 0.01
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=0.05, atol=2e-3 * scale,
                                   err_msg=k)


@pytest.mark.parametrize("rr", [None, 3])
def test_diff_image_equals_forward_image(rr):
    """Same key, same kernel, same draws: the differentiable render's
    image is the forward render's, bit for bit (the fixed-length scan
    only adds bounces on dead lanes), and so are the segments."""
    sd = get_scene("CornellBox")
    settings = RenderSettings(12, 10, 6, 6, (0.5, 0.5, 0.5), spp_chunk=4,
                              russian_roulette_start=rr)
    runs = [render_radiance(sd.build(), sd.camera_at(0.0),
                            dataclasses.replace(settings, differentiable=diff),
                            sampling.prng_key(3), device="cpu")
            for diff in (False, True)]
    (img0, st0), (img1, st1) = runs
    assert torch.equal(img0, img1)
    assert float(st0.segments) == float(st1.segments)
    assert st1.bounces == 2 * settings.max_bounces  # two chunks, no early exit


def test_second_backward_raises():
    """The scan frees its saved bounces in the backward: a second
    backward through the same graph raises instead of reading them."""
    sd = get_scene("CornellBox")
    bg = torch.tensor([0.5, 0.5, 0.5], requires_grad=True)
    settings = RenderSettings(4, 4, 1, 3, (0.5, 0.5, 0.5), differentiable=True)
    img, _ = render_radiance(sd.build(), sd.camera_at(0.0), settings,
                             sampling.prng_key(0), background=bg, device="cpu")
    img.sum().backward(retain_graph=True)
    assert torch.isfinite(bg.grad).all()
    with pytest.raises(RuntimeError, match="second backward"):
        img.sum().backward()


def test_camera_lanes_carry_gradients():
    """No op between the camera parameters and the ray columns cuts the
    graph: each of the 7 leaves reaches the origins or directions."""
    params = CameraParams.create(*CORNELL_CAM[:5], aperture=2.0, focus_dist=10.0)
    leaves = {f: getattr(params, f).clone().requires_grad_(True)
              for f in CAMERA_FIELDS}
    cam = CameraParams(**leaves).build()
    pix = torch.arange(64)
    _, o, d, _ = _make_lanes(cam, sampling.prng_key(1), pix, 0, width=8, height=8,
                             spp_chunk=2, spp_total=2)
    w = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 128, 3))).float()
    grads = torch.autograd.grad((w[0] * o).sum() + (w[1] * d).sum(),
                                list(leaves.values()))
    for f, g in zip(CAMERA_FIELDS, grads):
        assert torch.isfinite(g).all() and g.abs().sum() > 0, f


def test_diff_params_from_numpy():
    """The JAX DiffParams leaves carry across as numpy arrays, the
    image texels included; unknown or missing leaves raise."""
    jscene = j_get_scene("CornellBox").build()
    jp = JDiffParams.from_scene(jscene, JCameraParams.create(*CORNELL_CAM),
                                (0.1, 0.2, 0.3))
    arrays = {"tex_color": np.asarray(jp.tex_color),
              "tex_images": np.asarray(jp.tex_images),
              "background": np.asarray(jp.background)}
    arrays.update({f"camera.{f}": np.asarray(getattr(jp.camera, f))
                   for f in CAMERA_FIELDS})
    p = diff_params_from_numpy(arrays)
    want = DiffParams.from_scene(get_scene("CornellBox").build(),
                                 CameraParams.create(*CORNELL_CAM), (0.1, 0.2, 0.3))
    for a, b in zip(p.leaves(), want.leaves()):
        assert a.dtype == torch.float32 and torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown"):
        diff_params_from_numpy(dict(arrays, extra=np.zeros(3)))
    with pytest.raises(ValueError, match="missing"):
        diff_params_from_numpy({k: v for k, v in arrays.items()
                                if k != "camera.up"})


def test_differentiable_trace_refuses_perlin():
    """K1 and K2 refuse perlin (its d(value)/d(point) has no backward
    kernel): a differentiable trace of a perlin scene takes the generic
    route, K4 and autograd, and gradients reach the rays."""
    scene = get_scene("TwoSphereCheckers").build()
    assert not fb.fused_bounce_diff_ok(scene)
    o = torch.tensor([[13.0, 2.0, 3.0]]).repeat(4, 1)
    d = torch.tensor([[-13.0, -1.0, -3.0], [-13.0, 0.5, -3.0], [-13.0, -2.5, -3.0],
                      [-13.0, 1.5, -2.5]], requires_grad=True)
    keys = sampling.lane_keys(sampling.prng_key(0), torch.arange(4))
    rad, st = trace(scene, o, d, keys, (1.0, 1.0, 1.0), 2, differentiable=True)
    (g,) = torch.autograd.grad(rad.sum(), [d])
    assert st.bounces == 2 and torch.isfinite(g).all() and g.abs().sum() > 0
