"""The cascade renderer (``render._render_chunk_cascaded``) on the CPU,
against the port's chunked renderer and against the JAX package's
cascade.

Scenes and sizes are ``tests/golden_utils.py``'s class: CornellBox (the
fused route, K1's plain version), the image-textured scene of
``test_torch_materials_textures.py`` (the generic route, K3's) and
SphereField (the projected route, K6 / K7 / K5's plain sweep; both
builders pinned to the numpy BVH).  Tolerances and why:

* port cascade against port chunked: EQUAL, bit for bit, on the image,
  the segments, the bounces and the occupancy histogram, with
  occupancy[-1] == 0.  Every lane traces the path it traces in the
  chunked render (its draws key on its lane key and the bounce), the
  finished lanes' radiance is banked at their caller index, and the
  per-pixel sums run in the chunked render's order;
* port cascade against JAX cascade: ``test_torch_wavefront.py``'s rule
  for regen, the image contract plus the disagreement of the cascades
  minus that of the chunked renders on the same key within JAX's own
  cascade-vs-chunked bounds (mean abs < 1e-5, max < 5e-3).  JAX sorts
  where the port partitions, so its sums run in another order;
* schedule strings: the parser, ``_cascade_static_schedule`` and
  ``_derive_cascade_schedule`` EQUAL to JAX's, by hypothesis; a derived
  schedule equals JAX's on the same scene and key.
"""

import dataclasses
import functools
import warnings
from fractions import Fraction

import jax
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import rust_pathtracer_tpu.scene.builder as j_builder
import rust_pathtracer_tpu_torch.scene.builder as t_builder
from rust_pathtracer_tpu import render as j_render
from rust_pathtracer_tpu.bvh import build_bvh_numpy as j_build_bvh_numpy
from rust_pathtracer_tpu.camera import make_camera as j_make_camera
from rust_pathtracer_tpu.models import get_scene as j_get_scene
from rust_pathtracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from rust_pathtracer_tpu_torch import render
from rust_pathtracer_tpu_torch.bvh import build_bvh_numpy as t_build_bvh_numpy
from rust_pathtracer_tpu_torch.camera import make_camera
from rust_pathtracer_tpu_torch.integrator import MAX_BOUNCE_STATS
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.render import (
    CascadeOverflowError,
    RenderSettings,
    derive_cascade_schedule,
    render_radiance,
)
from rust_pathtracer_tpu_torch.sampling import prng_key
from rust_pathtracer_tpu_torch.scene import SceneBuilder
from rust_pathtracer_tpu_torch.utils.image import IMAGE_MIN_CLOSE, image_agreement
from test_torch_materials_textures import _scene_simple

torch.set_num_threads(2)

KEY = 3
IMAGE_CAM = ((0.0, 1.0, 2.0), (0.0, 0.5, -3.0), (0.0, 1.0, 0.0), 50.0, 1.0, 0.0, 10.0)
# route -> (width, height, spp, bounces, background, spp_chunk): two
# chunks each, so every case is a multi-chunk frame
SHAPES = {
    "CornellBox": (24, 24, 8, 12, (0.0, 0.0, 0.0), 4),
    "image": (20, 16, 4, 8, (0.1, 0.1, 0.1), 2),
    "SphereField": (32, 18, 4, 10, (1.0, 1.0, 1.0), 2),
}
# explicit schedules with room on each route (CornellBox keeps 31% of
# its lanes alive at bounce 8; the others die faster)
SCHEDULES = {
    "CornellBox": ["8:2", "1:1", "2:8/7,8:2"],
    "image": ["2:2,4:4", "1:1", "1:8/7,3:2"],
    "SphereField": ["3:2,6:4", "1:8/7,6:4", "1:1,2:2"],
}


@functools.lru_cache(maxsize=None)
def _scenes(name):
    """(JAX scene, JAX camera, port scene, port camera); SphereField on
    both builders' numpy BVH."""
    if name == "image":
        return (_scene_simple(JSceneBuilder), j_make_camera(*IMAGE_CAM),
                _scene_simple(SceneBuilder), make_camera(*IMAGE_CAM))
    saved = j_builder.build_bvh, t_builder.build_bvh
    if name == "SphereField":
        j_builder.build_bvh, t_builder.build_bvh = j_build_bvh_numpy, t_build_bvh_numpy
    try:
        jsd, sd = j_get_scene(name), get_scene(name)
        return jsd.build(), jsd.camera_at(0.0), sd.build(), sd.camera_at(0.0)
    finally:
        j_builder.build_bvh, t_builder.build_bvh = saved


def _settings(name, cls=RenderSettings, **kw):
    w, h, spp, nb, bg, chunk = SHAPES[name]
    return cls(w, h, spp, nb, bg, spp_chunk=chunk, **kw)


@functools.lru_cache(maxsize=None)
def _port(name, cascade=False, schedule=None):
    _, _, scene, cam = _scenes(name)
    return render_radiance(scene, cam, _settings(name, cascade=cascade,
                                                 cascade_schedule=schedule),
                           prng_key(KEY), device="cpu")


def _jax(name, cascade=False, schedule=None):
    jscene, jcam, _, _ = _scenes(name)
    img, stats = j_render.render_radiance(
        jscene, jcam, _settings(name, j_render.RenderSettings, cascade=cascade,
                                cascade_schedule=schedule), jax.random.PRNGKey(KEY))
    return np.asarray(img), stats


def _assert_equal(got, want):
    (img, st), (img0, st0) = got, want
    assert torch.equal(img, img0)
    assert torch.equal(st.segments, st0.segments)
    assert torch.equal(st.occupancy, st0.occupancy)
    assert st.bounces == st0.bounces
    assert float(st.occupancy[-1]) == 0.0


CASES = [(n, None) for n in SHAPES] + [(n, "auto") for n in SHAPES] + [
    (n, s) for n in SHAPES for s in SCHEDULES[n]]


@pytest.mark.parametrize("name,schedule", CASES)
def test_cascade_equals_chunked(name, schedule):
    """Dynamic (``cascade=True``), "auto" and explicit schedules, integer
    and rational shrinks, "1:1", on the three routes: the chunked render
    bit for bit."""
    _assert_equal(_port(name, cascade=True, schedule=schedule), _port(name))


def test_padded_chunk():
    """A last chunk padded past spp_total: the padded lanes start dead, as
    in the JAX package, so the image is the chunked one bit for bit and
    the cascade counts only the real lanes' segments."""
    _, _, scene, cam = _scenes("CornellBox")
    s = RenderSettings(12, 12, 6, 8, (0.0, 0.0, 0.0), spp_chunk=4)
    img0, st0 = render_radiance(scene, cam, s, prng_key(KEY), device="cpu")
    for kw in ({"cascade": True}, {"cascade_schedule": "6:2"}):
        img, st = render_radiance(scene, cam, dataclasses.replace(s, **kw), prng_key(KEY),
                                  device="cpu")
        assert torch.equal(img, img0), kw
        assert float(st.occupancy[0]) == 12 * 12 * 6 < float(st0.occupancy[0])
        assert float(st.segments) < float(st0.segments)


@pytest.fixture
def proj_interpret(monkeypatch):
    """JAX's forward takes its projected route on the CPU only so."""
    monkeypatch.setenv("RPT_PROJ_INTERPRET", "1")


@pytest.mark.parametrize("name,schedule", [
    ("CornellBox", None), ("CornellBox", "8:2"), ("image", "2:2,4:4"),
    ("SphereField", "3:2,6:4"), ("SphereField", "auto")])
def test_cascade_matches_jax_cascade(name, schedule, proj_interpret):
    """The port's cascade against JAX's on the same key and schedule."""
    img, st = _port(name, cascade=True, schedule=schedule)
    jimg, jst = _jax(name, cascade=True, schedule=schedule)
    cimg, _ = _port(name)
    jcimg, _ = _jax(name)
    img, cimg = img.numpy(), cimg.numpy()
    a = image_agreement(img, jimg)
    assert a["ok"] and a["frac_close"] >= IMAGE_MIN_CLOSE and not a["has_nan"], a
    assert abs(float(st.segments) - float(jst.segments)) <= 0.05 * float(jst.segments)
    own = np.abs((img - jimg) - (cimg - jcimg))
    assert own.mean() < 1e-5 and own.max() < 5e-3, (own.mean(), own.max())
    assert float(jst.occupancy[-1]) == 0.0 == float(st.occupancy[-1])


@pytest.mark.parametrize("name", ["CornellBox", "SphereField"])
def test_derived_schedule_is_jax_schedule(name, proj_interpret):
    """The probe, the derivation and the "1:1" prefix give JAX's string."""
    jscene, jcam, scene, cam = _scenes(name)
    s = _settings(name)
    got = derive_cascade_schedule(scene, cam, s, prng_key(KEY), device="cpu")
    want = j_render.derive_cascade_schedule(
        jscene, jcam, _settings(name, j_render.RenderSettings), jax.random.PRNGKey(KEY))
    assert got == want and got is not None


def test_derive_schedule_deterministic():
    """A pure function of (scene, camera, settings, key): a resumed render
    derives the same schedule; another key's still parses."""
    _, _, scene, cam = _scenes("CornellBox")
    s = RenderSettings(32, 32, 16, 12, (0.0, 0.0, 0.0), spp_chunk=4)
    a = derive_cascade_schedule(scene, cam, s, prng_key(9), device="cpu")
    assert a == derive_cascade_schedule(scene, cam, s, prng_key(9), device="cpu")
    c = derive_cascade_schedule(scene, cam, s, prng_key(10), device="cpu")
    if c is not None:
        render.parse_cascade_schedule(c)
    with pytest.raises(ValueError, match="camera"):
        render.derive_cascade_schedule_multi(scene, [], s, prng_key(9), device="cpu")


def test_explicit_overflow_raises():
    """A too-tight explicit schedule raises instead of darkening."""
    _, _, scene, cam = _scenes("SphereField")
    with pytest.raises(CascadeOverflowError, match="dropped"):
        render_radiance(scene, cam, _settings("SphereField", cascade_schedule="1:16"),
                        prng_key(KEY), device="cpu")
    _, _, scene, cam = _scenes("CornellBox")
    with pytest.raises(CascadeOverflowError, match="dropped"):
        render_radiance(scene, cam, _settings("CornellBox", cascade_schedule="1:64"),
                        prng_key(KEY), device="cpu")


def test_auto_overflow_widens_then_falls_back(monkeypatch):
    """Widths derived too tight (AUTO_MARGIN forced to 0.3): the renderer
    warns, derives again at double the margin, and in the end renders
    the plain path; the image is the chunked one, never darkened."""
    _, _, scene, cam = _scenes("CornellBox")
    s = RenderSettings(24, 24, 8, 12, (0.0, 0.0, 0.0), spp_chunk=4)
    img0, st0 = render_radiance(scene, cam, s, prng_key(7), device="cpu")
    monkeypatch.setattr(render, "AUTO_MARGIN", 0.3)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        img1, st1 = render_radiance(scene, cam,
                                    dataclasses.replace(s, cascade_schedule="auto"),
                                    prng_key(7), device="cpu")
    assert any("dropped" in str(w.message) for w in caught), [str(w.message) for w in caught]
    assert torch.equal(img1, img0) and torch.equal(st1.segments, st0.segments)
    assert float(st1.occupancy[-1]) == 0.0


def test_auto_overflow_every_attempt_renders_plain(monkeypatch):
    """Three overflowing attempts, then the plain chunked path."""
    _, _, scene, cam = _scenes("CornellBox")
    s = RenderSettings(12, 12, 4, 8, (0.0, 0.0, 0.0), spp_chunk=4)
    img0, st0 = render_radiance(scene, cam, s, prng_key(7), device="cpu")
    calls = []

    def tight(*a, **k):
        calls.append(k["margin"])
        return "1:64"

    monkeypatch.setattr(render, "derive_cascade_schedule", tight)
    with pytest.warns(UserWarning, match="plain chunked path"):
        img, st = render_radiance(scene, cam, dataclasses.replace(s, cascade_schedule="auto"),
                                  prng_key(7), device="cpu")
    assert calls == [render.AUTO_MARGIN, 2 * render.AUTO_MARGIN, 4 * render.AUTO_MARGIN]
    _assert_equal((img, st), (img0, st0))


def test_static_schedule_needs_room_for_the_guard():
    """A static schedule does not apply (the dynamic cascade runs) where
    max_bounces reaches the guard slot, or the widths are not whole."""
    assert render._cascade_static_schedule(MAX_BOUNCE_STATS - 1, 1024, "2:2") == []
    assert render._cascade_static_schedule(10, 1000, "2:3") == []
    assert render._cascade_static_schedule(10, 1024, "2:2,4:8/3") == [(2, 512), (4, 384)]


# ---------------------------------------------------------------------------
# the schedule helpers against JAX's
# ---------------------------------------------------------------------------

def _same(fn_port, fn_jax, *args, **kw):
    """Both return the same value, or both raise ValueError."""
    try:
        want = fn_jax(*args, **kw)
    except ValueError:
        with pytest.raises(ValueError):
            fn_port(*args, **kw)
        return None
    assert fn_port(*args, **kw) == want
    return want


ENTRY = st.builds(lambda b, num, den, rat: f"{b}:{num}/{den}" if rat else f"{b}:{num}",
                  st.integers(-2, 70), st.integers(-1, 80), st.integers(-1, 9),
                  st.booleans())
SCHEDULE_STRINGS = st.one_of(
    st.lists(ENTRY, min_size=1, max_size=5).map(",".join),
    st.text(alphabet="0123456789:/,- ", max_size=16))


@settings(max_examples=300, deadline=None)
@given(SCHEDULE_STRINGS)
def test_parse_matches_jax(raw):
    got = _same(render.parse_cascade_schedule, j_render.parse_cascade_schedule, raw)
    if got is not None:
        assert all(isinstance(s, Fraction) for _, s in got)


@settings(max_examples=300, deadline=None)
@given(SCHEDULE_STRINGS, st.integers(1, 70), st.sampled_from([128, 1000, 1024, 2304, 4096,
                                                             1 << 20, 921600]))
def test_static_schedule_matches_jax(raw, max_bounces, n_lanes):
    assert render._cascade_static_schedule(max_bounces, n_lanes, raw) == \
        j_render._cascade_static_schedule(max_bounces, n_lanes, raw)


@settings(max_examples=300, deadline=None)
@given(st.lists(st.floats(0.0, 1.0), min_size=2, max_size=MAX_BOUNCE_STATS),
       st.sampled_from([1024, 2304, 65536, 1 << 20, 3_279_360]), st.integers(1, 70),
       st.floats(0.3, 4.0), st.integers(1, 6))
def test_derive_matches_jax(fracs, n_lanes, max_bounces, margin, max_stages):
    occ = np.sort(np.asarray(fracs))[::-1] * n_lanes
    assert render._derive_cascade_schedule(occ, n_lanes, max_bounces, margin=margin,
                                           max_stages=max_stages) == \
        j_render._derive_cascade_schedule(occ, n_lanes, max_bounces, margin=margin,
                                          max_stages=max_stages)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

CLI_SMALL = ["--scene", "CornellBox", "--width", "8", "--height", "8", "--spp", "4",
             "--max-bounces", "6", "--spp-chunk", "2", "--device", "cpu"]


@pytest.mark.parametrize("cascade", [[], ["--cascade"], ["--cascade", "auto"],
                                     ["--cascade", "3:2"]])
def test_cli_cascade_renders_the_chunked_png(tmp_path, capsys, cascade):
    """--cascade (bare: dynamic), "auto" and an explicit schedule write
    the PNG the chunked render writes."""
    from rust_pathtracer_tpu_torch import cli

    out = tmp_path / "out"
    assert cli.main(CLI_SMALL + cascade + ["--output-dir", str(out)]) == 0
    png = (out / "image_0000.png").read_bytes()
    if cascade:
        assert f"cascade={cascade[-1] if len(cascade) > 1 else 'dynamic'}" in \
            capsys.readouterr().out
    ref = tmp_path / "ref"
    assert cli.main(CLI_SMALL + ["--output-dir", str(ref)]) == 0
    assert (ref / "image_0000.png").read_bytes() == png


@pytest.mark.parametrize("argv,msg", [
    (["--cascade", "1:8/7,2:9/8"], "shrinks must increase"),
    (["--cascade", "5-8"], "bounce:shrink"),
    (["--cascade", "1:3/0"], "bounce:shrink"),
    (["--cascade", "--regen"], "mutually exclusive"),
    (["--regen", "--cascade", "auto"], "mutually exclusive"),
])
def test_cli_cascade_checked_at_parse_time(capsys, argv, msg):
    """A malformed schedule, or --cascade with --regen, exits 2 with
    argparse's message before anything renders."""
    from rust_pathtracer_tpu_torch import cli

    with pytest.raises(SystemExit) as e:
        cli.main(CLI_SMALL + argv)
    assert e.value.code == 2 and msg in capsys.readouterr().err
