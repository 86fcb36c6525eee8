"""The port's forward render against the JAX package, on the CPU.

Image contract (``rust_pathtracer_tpu_torch.utils.image.image_agreement``):
the image mean within 1% relative, at least 90% of pixels within
1e-4 * max(1, |reference|), no NaN.  The two renderers follow the same
random stream bit for bit; a pixel differs only where an ulp-level
difference (sin/cos, XLA's fused multiply-adds) flipped a discrete
choice on one of its samples.  The goldens are the JAX package's CPU
renders that ``tests/test_goldens.py`` pins (SphereField's and
ModelTest's by JAX's BVH walk; the port searches them with the plain
versions of the projected kernels).
"""

import ast
import dataclasses
import os
import struct
import zlib

import jax
import numpy as np
import pytest
import torch

from golden_utils import GOLDEN_CONFIGS, golden_path
from rust_pathtracer_tpu.models import get_scene as j_get_scene
from rust_pathtracer_tpu.render import RenderSettings as JRenderSettings
from rust_pathtracer_tpu.render import render_radiance as j_render_radiance
from rust_pathtracer_tpu.utils.image import to_rgb8 as j_to_rgb8
from rust_pathtracer_tpu_torch import cli
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.render import RenderSettings, render_image, render_radiance
from rust_pathtracer_tpu_torch.sampling import prng_key
from rust_pathtracer_tpu_torch.scene.obj_loader import write_benchmark_obj
from rust_pathtracer_tpu_torch.utils.image import image_agreement, to_rgb8, write_png

torch.set_num_threads(2)

PORTED_GOLDENS = ("CornellBox", "TriangleTest", "TwoSphereCheckers", "LightTest",
                  "SphereField", "ModelTest")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _render(name, w, h, spp, nb, seed, spp_chunk=None, **kw):
    sd = get_scene(name, **kw)
    settings = RenderSettings(w, h, spp, nb, sd.output.image.background,
                              spp_chunk=spp if spp_chunk is None else spp_chunk)
    return render_radiance(sd.build(), sd.camera_at(0.0), settings,
                           prng_key(seed), device="cpu")


@pytest.mark.parametrize("name", PORTED_GOLDENS)
def test_golden_config_matches(name, tmp_path):
    kw, w, h, spp, nb = GOLDEN_CONFIGS[name]
    if "obj_path" in kw:  # golden_utils.render_golden's asset
        kw = dict(kw, obj_path=str(tmp_path / "golden_model.obj"))
        write_benchmark_obj(kw["obj_path"])
    img, stats = _render(name, w, h, spp, nb, seed=1234, **kw)
    assert img.shape == (h, w, 3) and img.dtype == torch.float32
    a = image_agreement(img.numpy(), np.load(golden_path(name)))
    assert a["ok"], a
    assert 0 < stats.bounces <= nb


def test_render_matches_jax_render():
    """CornellBox 32x32, 4 spp, 8 bounces, both renderers, one key."""
    jsd = j_get_scene("CornellBox")
    jimg, jst = j_render_radiance(
        jsd.build(), jsd.camera_at(0.0),
        JRenderSettings(32, 32, 4, 8, (0.0, 0.0, 0.0)), jax.random.PRNGKey(3))
    img, st = _render("CornellBox", 32, 32, 4, 8, seed=3, spp_chunk=None)
    a = image_agreement(img.numpy(), np.asarray(jimg))
    assert a["ok"], a
    assert abs(float(st.segments) - float(jst.segments)) <= 0.05 * float(jst.segments)


def test_same_key_any_chunking():
    """The counter RNG makes the image independent of the chunking, up
    to the f32 order of the per-pixel sums."""
    a, _ = _render("CornellBox", 12, 10, 6, 6, seed=9, spp_chunk=6)
    b, _ = _render("CornellBox", 12, 10, 6, 6, seed=9, spp_chunk=4)  # padded
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6, atol=1e-7)
    c, _ = _render("CornellBox", 12, 10, 6, 6, seed=9, spp_chunk=6)
    assert torch.equal(a, c)


def test_to_rgb8_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(0.3, 0.5, (17, 9, 3)).astype(np.float32)
    x[0, 0] = np.nan
    x[1, 1] = 50.0
    np.testing.assert_array_equal(to_rgb8(x), j_to_rgb8(x))


def _read_png(path):
    """Decode an 8-bit RGB PNG with filter type 0 (what write_png writes)."""
    data = open(path, "rb").read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, idat, ihdr = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        crc = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])[0]
        assert crc == zlib.crc32(tag + body) & 0xFFFFFFFF
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h, depth, ctype = ihdr[:4]
    assert (depth, ctype) == (8, 2)
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()
    return raw[:, 1:].reshape(h, w, 3)


def test_write_png_round_trip(tmp_path):
    rgb = np.random.default_rng(1).integers(0, 256, (7, 5, 3), dtype=np.uint8)
    path = str(tmp_path / "x.png")
    write_png(path, rgb)
    np.testing.assert_array_equal(_read_png(path), rgb)
    pil = pytest.importorskip("PIL.Image")
    np.testing.assert_array_equal(np.asarray(pil.open(path).convert("RGB")), rgb)


def test_cli_cpu_writes_png(tmp_path, capsys):
    rc = cli.main(["--scene", "CornellBox", "--width", "16", "--height", "16",
                   "--spp", "2", "--max-bounces", "4", "--device", "cpu",
                   "--output-dir", str(tmp_path)])
    assert rc == 0
    img = _read_png(str(tmp_path / "image_0000.png"))
    assert img.shape == (16, 16, 3) and img.max() > 0
    out = capsys.readouterr().out
    assert "segments=" in out and "segments/s=" in out


def test_no_fallback_without_gpu(tmp_path):
    """Asking for the GPU where there is none raises or exits non-zero;
    nothing renders on the CPU instead."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a GPU")
    sd = get_scene("CornellBox")
    settings = RenderSettings(4, 4, 1, 2, (0.0, 0.0, 0.0))
    with pytest.raises(RuntimeError, match="cuda"):
        render_radiance(sd.build(), sd.camera_at(0.0), settings, prng_key(0),
                        device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        render_image(sd.build(), sd.camera_at(0.0), settings, prng_key(0),
                     device="cuda")
    rc = cli.main(["--scene", "CornellBox", "--width", "4", "--height", "4",
                   "--spp", "1", "--output-dir", str(tmp_path)])
    assert rc != 0
    assert not (tmp_path / "image_0000.png").exists()


def test_not_ported_settings_raise():
    """The remat mode the port lacks ("bf16") raises; the cascade, which
    raised before it was ported, renders the chunked image bit for bit
    (``tests/test_torch_cascade.py`` holds it at length); differentiable
    renders of CornellBox (fused route) and of a perlin scene
    (TwoSphereCheckers, generic route) run."""
    sd = get_scene("CornellBox")
    base = RenderSettings(4, 4, 1, 2, (0.0, 0.0, 0.0))
    want, st = render_radiance(sd.build(), sd.camera_at(0.0), base, prng_key(0),
                               device="cpu")
    for kw in ({"cascade": True}, {"cascade_schedule": "5:8"},
               {"cascade_schedule": "1:1"}):
        img, st2 = render_radiance(sd.build(), sd.camera_at(0.0),
                                   dataclasses.replace(base, **kw), prng_key(0),
                                   device="cpu")
        assert torch.equal(img, want) and torch.equal(st2.segments, st.segments), kw
    diff = dataclasses.replace(base, differentiable=True)
    img, _ = render_radiance(sd.build(), sd.camera_at(0.0), diff, prng_key(0),
                             device="cpu")
    assert img.shape == (4, 4, 3) and torch.isfinite(img).all()
    perlin = get_scene("TwoSphereCheckers")
    img, st = render_radiance(perlin.build(), perlin.camera_at(0.0), diff,
                              prng_key(0), device="cpu")
    assert torch.isfinite(img).all() and st.bounces == 2
    with pytest.raises(NotImplementedError, match="bf16"):
        render_radiance(perlin.build(), perlin.camera_at(0.0),
                        dataclasses.replace(diff, remat="bf16"), prng_key(0),
                        device="cpu")


@pytest.mark.parametrize("name", ["CornellBox", "TwoSphereCheckers"])
def test_cascade_ignored_when_differentiable(name):
    """A differentiable render ignores ``cascade`` and ``cascade_schedule``,
    as JAX's does (render.py:830-835): the image equals the differentiable
    render without them, bit for bit, on the fused route (CornellBox) and
    the generic one (TwoSphereCheckers' perlin marble); JAX's renders
    under the same settings too."""
    sd = get_scene(name)
    diff = RenderSettings(6, 4, 1, 3, (0.2, 0.3, 0.4), differentiable=True)
    want, st = render_radiance(sd.build(), sd.camera_at(0.0), diff, prng_key(3),
                               device="cpu")
    for kw in ({"cascade": True}, {"cascade_schedule": "5:8"},
               {"cascade": True, "cascade_schedule": "auto"}):
        img, st2 = render_radiance(sd.build(), sd.camera_at(0.0),
                                   dataclasses.replace(diff, **kw), prng_key(3),
                                   device="cpu")
        assert torch.equal(img, want) and float(st2.segments) == float(st.segments), kw
    jsd = j_get_scene(name)
    jimg, _ = j_render_radiance(jsd.build(), jsd.camera_at(0.0),
                                JRenderSettings(6, 4, 1, 3, (0.2, 0.3, 0.4),
                                                differentiable=True, cascade=True),
                                jax.random.PRNGKey(3))
    assert np.isfinite(np.asarray(jimg)).all()


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


def test_port_imports_no_jax():
    """No module of the port, nor the root scripts that run on the card
    (chip_smoke.py, profile_port.py, k2_variants.py, k34_variants.py),
    imports jax or the JAX package, not even its numpy-only modules (bvh,
    obj_loader): the machine with the card has neither.  The big-scene
    modules are among those checked."""
    files = [os.path.join(REPO, n) for n in ("chip_smoke.py", "profile_port.py",
                                            "k2_variants.py", "k34_variants.py")]
    for root, _, names in os.walk(os.path.join(REPO, "rust_pathtracer_tpu_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 20
    rel = {os.path.relpath(f, REPO) for f in files}
    for mod in ("bvh.py", "scene/obj_loader.py", "ops/projected.py",
                "ops/resident.py", "ops/worklist.py"):
        assert f"rust_pathtracer_tpu_torch/{mod}" in rel, mod
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "rust_pathtracer_tpu", "PIL"), (
                path, mod)
