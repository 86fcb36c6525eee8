"""The regen wavefront (``wavefront.render_radiance_regen``) on the CPU,
against the JAX package's and against the port's chunked renderer.

Every case renders one key on both sides.  Scenes and settings are
``tests/test_wavefront.py``'s (20x20, 12 spp, 10 bounces, 1,024 lanes),
plus the image-textured scene (the generic route, K3's plain version)
and SphereField at 16x9 (the projected route; both builders pinned to
the numpy BVH).  Tolerances and why:

* port regen against JAX regen: each path draws the same random numbers
  on both sides, but XLA:CPU contracts multiply-adds into FMAs and the
  port does not (ROADMAP queue 3), so a path may take another branch.
  A regen case holds (a) the image contract (``IMAGE_MIN_CLOSE`` of the
  pixels close, the mean within ``IMAGE_MEAN_RTOL``, no NaN) and the
  segments within the 5% of
  ``test_torch_render.py::test_render_matches_jax_render``, and (b) the
  regen's disagreement to the chunked renderers' own on the same key:
  (port regen - JAX regen) - (port chunked - JAX chunked) within JAX's
  regen-vs-chunked bounds, mean abs < 1e-5 and max < 5e-3, i.e. regen
  adds no disagreement of its own.  CornellBox on key 7 once missed the
  mean by 2.35%: one camera ray met the glass sphere near its rim, where
  the f32 sphere discriminant cancels, and the port's root landed inside
  the surface by more than t_min, so the reflected ray met the sphere
  again.  The f64 path follows JAX's (``tests/test_torch_oracle.py::
  test_key7_lane_follows_f64``), and the port now takes a sphere's roots
  in f64;
* port regen against port chunked: JAX's own bounds
  (``tests/test_wavefront.py``: mean abs < 1e-5, max < 5e-3, segments
  within 0.1%).  On these settings no path differs: the segment counts
  and histograms are equal, and the images differ by at most 1.2e-7
  (the order of the per-pixel sums).
"""

import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

import rust_pathtracer_tpu.scene.builder as j_builder
import rust_pathtracer_tpu_torch.scene.builder as t_builder
from rust_pathtracer_tpu.bvh import build_bvh_numpy as j_build_bvh_numpy
from rust_pathtracer_tpu.camera import make_camera as j_make_camera
from rust_pathtracer_tpu.models import get_scene as j_get_scene
from rust_pathtracer_tpu.render import RenderSettings as JRenderSettings
from rust_pathtracer_tpu.render import render_radiance as j_render_radiance
from rust_pathtracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from rust_pathtracer_tpu.wavefront import render_radiance_regen as j_render_regen
from rust_pathtracer_tpu_torch import wavefront
from rust_pathtracer_tpu_torch.bvh import build_bvh_numpy as t_build_bvh_numpy
from rust_pathtracer_tpu_torch.camera import make_camera
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
from rust_pathtracer_tpu_torch.sampling import prng_key
from rust_pathtracer_tpu_torch.scene import SceneBuilder
from rust_pathtracer_tpu_torch.utils.image import (
    IMAGE_MEAN_RTOL,
    IMAGE_MIN_CLOSE,
    image_agreement,
)
from rust_pathtracer_tpu_torch.wavefront import _stripe_len, render_radiance_regen
from test_torch_materials_textures import _scene_simple

torch.set_num_threads(2)

KEY = 7
SMALL = (20, 20, 12, 10)  # tests/test_wavefront.py's width, height, spp, bounces
BIG = (16, 9, 4, 6)       # SphereField, the projected route
LANES = {"small": 1024, "big": 256}
IMAGE_CAM = ((0.0, 1.0, 2.0), (0.0, 0.5, -3.0), (0.0, 1.0, 0.0), 50.0, 1.0, 0.0, 10.0)
BG = {"CornellBox": (0.0, 0.0, 0.0), "LightTest": (0.0, 0.0, 0.0),
      "TwoSphereCheckers": (1.0, 1.0, 1.0), "image": (0.1, 0.1, 0.1),
      "SphereField": (1.0, 1.0, 1.0)}


@functools.lru_cache(maxsize=None)
def _scenes(name):
    """(JAX scene, JAX camera, port scene, port camera); SphereField on
    both builders' numpy BVH."""
    if name == "image":
        return (_scene_simple(JSceneBuilder), j_make_camera(*IMAGE_CAM),
                _scene_simple(SceneBuilder), make_camera(*IMAGE_CAM))
    if name == "SphereField":
        saved = j_builder.build_bvh, t_builder.build_bvh
        j_builder.build_bvh, t_builder.build_bvh = j_build_bvh_numpy, t_build_bvh_numpy
        try:
            jsd, sd = j_get_scene(name), get_scene(name)
            return jsd.build(), jsd.camera_at(0.0), sd.build(), sd.camera_at(0.0)
        finally:
            j_builder.build_bvh, t_builder.build_bvh = saved
    jsd, sd = j_get_scene(name), get_scene(name)
    return jsd.build(), jsd.camera_at(0.0), sd.build(), sd.camera_at(0.0)


def _shape(name):
    return BIG if name == "SphereField" else SMALL


def _lanes(name):
    return LANES["big" if name == "SphereField" else "small"]


def _settings(name, rr, cls=RenderSettings):
    return cls(*_shape(name), BG[name], russian_roulette_start=rr)


@functools.lru_cache(maxsize=None)
def _port_chunked(name, rr):
    _, _, scene, cam = _scenes(name)
    img, st = render_radiance(scene, cam, _settings(name, rr), prng_key(KEY), device="cpu")
    return img.numpy(), st


def _port_regen(name, rr, mode):
    _, _, scene, cam = _scenes(name)
    img, st = render_radiance_regen(scene, cam, _settings(name, rr), prng_key(KEY),
                                    lanes=_lanes(name), mode=mode, device="cpu")
    return img.numpy(), st


@functools.lru_cache(maxsize=None)
def _jax_chunked(name, rr):
    jscene, jcam, _, _ = _scenes(name)
    img, st = j_render_radiance(jscene, jcam, _settings(name, rr, JRenderSettings),
                                jax.random.PRNGKey(KEY))
    return np.asarray(img), st


def _jax_regen(name, rr, mode):
    jscene, jcam, _, _ = _scenes(name)
    img, st = j_render_regen(jscene, jcam, _settings(name, rr, JRenderSettings),
                             jax.random.PRNGKey(KEY), lanes=_lanes(name), mode=mode)
    return np.asarray(img), st


@pytest.fixture
def proj_interpret(monkeypatch):
    """JAX's forward takes its projected route on the CPU only so."""
    monkeypatch.setenv("RPT_PROJ_INTERPRET", "1")


CASES = ([(n, m, None) for n in ("CornellBox", "LightTest", "TwoSphereCheckers")
          for m in ("stripe", "queue")]
         + [("CornellBox", "queue", 3), ("LightTest", "stripe", 3)]
         + [(n, m, rr) for n in ("image", "SphereField") for m in ("stripe", "queue")
            for rr in (None, 3)])


@pytest.mark.parametrize("name,mode,rr", CASES)
def test_regen_matches_jax_regen(name, mode, rr, proj_interpret):
    """The fused route (CornellBox, LightTest, TwoSphereCheckers), the
    small generic route (the image scene) and the projected route
    (SphereField), both modes, with and without roulette from bounce 3."""
    img, st = _port_regen(name, rr, mode)
    jimg, jst = _jax_regen(name, rr, mode)
    cimg, _ = _port_chunked(name, rr)
    jcimg, _ = _jax_chunked(name, rr)
    a = image_agreement(img, jimg)
    assert a["ok"] and a["frac_close"] >= IMAGE_MIN_CLOSE and not a["has_nan"], a
    assert a["mean_rel"] <= IMAGE_MEAN_RTOL, a
    assert abs(float(st.segments) - float(jst.segments)) <= 0.05 * float(jst.segments)
    own = np.abs((img - jimg) - (cimg - jcimg))
    assert own.mean() < 1e-5 and own.max() < 5e-3, (own.mean(), own.max())
    occ, jocc = st.occupancy.numpy(), np.asarray(jst.occupancy)
    assert np.abs(occ - jocc).sum() <= 0.05 * jocc.sum()


@pytest.mark.parametrize("name", ["CornellBox", "LightTest", "TwoSphereCheckers",
                                  "image", "SphereField"])
@pytest.mark.parametrize("mode", ["stripe", "queue"])
def test_regen_matches_chunked(name, mode):
    """The same estimator as the chunked renderer, under JAX's own
    regen-vs-chunked bounds; the statistics agree too."""
    a, sa = _port_chunked(name, None)
    b, sb = _port_regen(name, None, mode)
    assert np.abs(a - b).mean() < 1e-5
    assert np.abs(a - b).max() < 5e-3
    assert abs(float(sa.segments) - float(sb.segments)) <= 0.001 * float(sa.segments)
    occ_a, occ_b = sa.occupancy.numpy(), sb.occupancy.numpy()
    assert np.abs(occ_a - occ_b).sum() <= 0.001 * occ_a.sum()


def test_regen_russian_roulette_matches_chunked():
    """Roulette from bounce 3 at each lane's own depth: the chunked
    renderer's estimator, and fewer segments than without roulette."""
    a, sa = _port_chunked("CornellBox", 3)
    b, sb = _port_regen("CornellBox", 3, "queue")
    assert np.abs(a - b).mean() < 1e-5 and np.abs(a - b).max() < 5e-3
    assert abs(float(sa.segments) - float(sb.segments)) <= 0.001 * float(sa.segments)
    _, sb0 = _port_regen("CornellBox", None, "queue")
    assert float(sb.segments) < float(sb0.segments)


@pytest.mark.parametrize("mode", ["stripe", "queue"])
def test_regen_occupancy_histogram(mode):
    """occupancy[b] = paths alive at bounce b: it sums to the segments,
    occupancy[0] is every path, and it matches the chunked renderer's."""
    _, sa = _port_chunked("CornellBox", None)
    _, sb = _port_regen("CornellBox", None, mode)
    occ = sb.occupancy.numpy()
    assert occ.sum() == float(sb.segments)
    assert occ[0] == 20 * 20 * 12
    occ_chunked = sa.occupancy.numpy()
    assert np.abs(occ - occ_chunked).sum() <= 0.001 * occ_chunked.sum()


def _cornell(w, h, spp, nb):
    sd = get_scene("CornellBox")
    return sd.build(), sd.camera_at(0.0), RenderSettings(w, h, spp, nb, (0.0, 0.0, 0.0))


def test_regen_small_pool_multiple_refills():
    """8x8, 32 spp through 128 lanes: every lane refills many times."""
    scene, cam, s = _cornell(8, 8, 32, 8)
    a, _ = render_radiance(scene, cam, s, prng_key(KEY), device="cpu")
    b, stats = render_radiance_regen(scene, cam, s, prng_key(KEY), lanes=128,
                                     device="cpu")
    assert np.abs(a.numpy() - b.numpy()).max() < 5e-3
    assert stats.bounces >= 16  # 2,048 paths through 128 lanes


def test_regen_pool_larger_than_queue():
    scene, cam, s = _cornell(6, 6, 2, 4)
    a, _ = render_radiance(scene, cam, s, prng_key(KEY), device="cpu")
    b, _ = render_radiance_regen(scene, cam, s, prng_key(KEY), lanes=4096, device="cpu")
    assert np.abs(a.numpy() - b.numpy()).max() < 5e-3


def test_stripe_len():
    """``tests/test_wavefront.py::test_regen_stripe_eligibility``'s values."""
    assert _stripe_len(512 * 512 * 256, 256, 1 << 20) == 64
    assert _stripe_len(20 * 20 * 12, 12, 1024) == 6
    assert _stripe_len(64 * 64 * 4, 4, 128) is None


def test_regen_errors():
    """JAX's errors (a non-positive pool, total >= 2**31, stripe without a
    pixel-aligned stripe), an unknown mode, and a differentiable
    setting; the default mode, with a pool smaller than the image, takes
    the queue."""
    scene, cam, s = _cornell(64, 64, 4, 6)
    key = prng_key(KEY)
    with pytest.raises(ValueError, match="stripe"):
        render_radiance_regen(scene, cam, s, key, lanes=128, mode="stripe", device="cpu")
    with pytest.raises(ValueError, match="positive"):
        render_radiance_regen(scene, cam, s, key, lanes=0, device="cpu")
    with pytest.raises(ValueError, match="int32"):
        render_radiance_regen(scene, cam, dataclasses.replace(
            s, width=65536, height=32768, samples_per_pixel=1), key, device="cpu")
    for mode in ("sorted", "auto"):
        with pytest.raises(ValueError, match="mode"):
            render_radiance_regen(scene, cam, s, key, mode=mode, device="cpu")
    with pytest.raises(NotImplementedError, match="forward only"):
        render_radiance_regen(scene, cam, dataclasses.replace(s, differentiable=True),
                              key, device="cpu")
    a, _ = render_radiance(scene, cam, s, key, device="cpu")
    b, _ = render_radiance_regen(scene, cam, s, key, lanes=128, device="cpu")
    assert np.abs(a.numpy() - b.numpy()).max() < 5e-3


@pytest.mark.parametrize("name", ["LightTest", "image"])
def test_regen_bitwise_repeatable(name):
    """Two renders on one key are equal bit for bit, in both modes, with
    the same statistics."""
    for mode in ("queue", "stripe"):
        a, sa = _port_regen(name, 3, mode)
        b, sb = _port_regen(name, 3, mode)
        np.testing.assert_array_equal(a.view(np.int32), b.view(np.int32))
        assert float(sa.segments) == float(sb.segments)
        assert torch.equal(sa.occupancy, sb.occupancy) and sa.bounces == sb.bounces


def test_regen_finished_lane_state_never_consumed(monkeypatch):
    """K1 commits o/d/thr for lanes the depth cap kills (JAX pins this at
    ``tests/test_wavefront.py::test_regen_fused_finished_lane_state_never_consumed``):
    with max_bounces=1 every scattering lane is capped, so the plain K1's
    committed o/d/thr poisoned with NaN on every lane must leave the image
    bitwise unchanged."""
    sd = get_scene("LightTest")
    scene, cam = sd.build(), sd.camera_at(0.0)
    s = RenderSettings(16, 10, 6, 1, (0.0, 0.0, 0.0))
    img0, st0 = render_radiance_regen(scene, cam, s, prng_key(KEY), lanes=256,
                                      device="cpu")
    real = wavefront.fused_bounce_keyed

    def poisoned(*args, **kwargs):
        out = real(*args, **kwargs)
        out[0:9] = float("nan")
        return out

    monkeypatch.setattr(wavefront, "fused_bounce_keyed", poisoned)
    img1, st1 = render_radiance_regen(scene, cam, s, prng_key(KEY), lanes=256,
                                      device="cpu")
    np.testing.assert_array_equal(img0.numpy().view(np.int32), img1.numpy().view(np.int32))
    assert float(st0.segments) == float(st1.segments)
    assert torch.isfinite(img0).all() and img0.sum() > 0


def test_regen_routes(monkeypatch):
    """The fused scenes launch K1 at per-lane depth and never the draw
    kernel's wrapper; the generic scenes draw at per-lane depth there."""
    calls = []
    for mod, fn in ((wavefront, "fused_bounce_keyed"), (wavefront, "bounce_draws")):
        orig = getattr(mod, fn)

        def spy(*a, _orig=orig, _fn=fn, **k):
            calls.append((_fn, a[5] if _fn == "fused_bounce_keyed" else a[1]))
            return _orig(*a, **k)

        monkeypatch.setattr(mod, fn, spy)
    for name, want in (("LightTest", "fused_bounce_keyed"), ("image", "bounce_draws")):
        calls.clear()
        _port_regen(name, 3, "queue")
        assert calls and {c[0] for c in calls} == {want}, name
        assert all(isinstance(c[1], torch.Tensor) and c[1].dtype == torch.int32
                   for c in calls)


def test_cli_regen_writes_png(tmp_path, capsys, monkeypatch):
    """``--regen`` / ``--lanes`` route to ``render_radiance_regen`` with the
    pool asked for, as the JAX CLI routes them (cli.py:278-282)."""
    from rust_pathtracer_tpu_torch import cli
    from test_torch_render import _read_png

    pools = []
    real = wavefront.render_radiance_regen

    def spy(*a, lanes=None, **k):
        pools.append(lanes)
        return real(*a, lanes=lanes, **k)

    monkeypatch.setattr(wavefront, "render_radiance_regen", spy)
    rc = cli.main(["--scene", "LightTest", "--width", "16", "--height", "10", "--spp", "4",
                   "--max-bounces", "6", "--regen", "--lanes", "64", "--device", "cpu",
                   "--output-dir", str(tmp_path)])
    assert rc == 0 and pools == [64]
    img = _read_png(str(tmp_path / "image_0000.png"))
    assert img.shape == (10, 16, 3) and img.max() > 0
    out = capsys.readouterr().out
    assert "regen on cpu" in out and "segments/s=" in out
