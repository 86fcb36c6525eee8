"""The command-line surface of the port on the CPU: scene JSON
(``scene/json_io.py``), PNG input and GIF output (``utils/image.py``),
the metrics (``utils/metrics.py``) and the CLI's animation loop, against
the JAX package where it has a counterpart.

Tolerances: the JSON scene tables equal JAX's bit for bit, and a JSON
scene renders bit for bit as the built-in scene it spells out; the
orbit camera agrees with JAX's within 1e-6 (``test_torch_scene.py``'s
camera tolerance).  ``read_png`` equals Pillow's ``convert("RGB")``
exactly.  ``write_gif`` decodes (by Pillow) to the frame count, size,
delay and loop of the JAX package's GIF, and each frame's mean absolute
error against its input is at most 1.25x that of the JAX package's GIF
plus half a level (the palette and dithering are not Pillow's bits).
Each CLI frame equals, byte for byte, the PNG of ``render_radiance`` at
the frame's camera; against the JAX CLI's frames on the same arguments
the image contract of ``utils/image.py`` holds.
"""

import json
import os
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from rust_pathtracer_tpu.cli import main as j_main
from rust_pathtracer_tpu.models import get_scene as j_get_scene
from rust_pathtracer_tpu.render import OutputSettings as JOutputSettings
from rust_pathtracer_tpu.render import RenderSettings as JRenderSettings
from rust_pathtracer_tpu.render import render_radiance as j_render_radiance
from rust_pathtracer_tpu.scene.json_io import scene_def_from_dict as j_scene_def_from_dict
from rust_pathtracer_tpu.utils.image import write_gif as j_write_gif
from rust_pathtracer_tpu_torch import cli, render
from rust_pathtracer_tpu_torch.models import SCENES, get_scene
from rust_pathtracer_tpu_torch.render import OutputSettings, RenderSettings, render_radiance
from rust_pathtracer_tpu_torch.sampling import prng_key
from rust_pathtracer_tpu_torch.scene.json_io import (
    load_scene_json,
    save_scene_json,
    scene_def_from_dict,
)
from rust_pathtracer_tpu_torch.scene.obj_loader import write_test_obj
from rust_pathtracer_tpu_torch.utils.checkpoint import load_checkpoint
from rust_pathtracer_tpu_torch.utils.image import (
    image_agreement,
    lzw_encode,
    read_png,
    to_rgb8,
    write_gif,
    write_png,
)
from rust_pathtracer_tpu_torch.utils.metrics import RenderMetrics, StageTimer

from test_json_cli import CORNELL_DOC
from test_torch_scene import _assert_tables_equal
from torch_spawn import run_processes

torch.set_num_threads(2)


# ---------------------------------------------------------------------------
# scene JSON
# ---------------------------------------------------------------------------

def _textured_doc(tmp_path):
    """Checker, perlin and image textures (a PNG file and inline data),
    every material, every primitive kind and an OBJ ref."""
    write_test_obj(os.path.join(tmp_path, "m.obj"))
    rng = np.random.default_rng(3)
    write_png(os.path.join(tmp_path, "tex.png"),
              rng.integers(0, 256, (5, 7, 3), dtype=np.uint8))
    return {
        "perlin_seed": 7,
        "textures": [
            {"type": "solid", "color": [0.2, 0.3, 0.1]},
            {"type": "solid", "color": [0.9, 0.9, 0.9]},
            {"type": "checker", "odd": 0, "even": 1, "frequency": 4.0},
            {"type": "perlin", "scale": 4.0},
            {"type": "image", "path": "tex.png"},
            {"type": "image", "data": np.full((2, 3, 3), 0.5).tolist()},
            {"type": "solid", "color": [4.0, 4.0, 4.0]},
        ],
        "materials": [
            {"type": "lambertian", "texture": 2},
            {"type": "lambertian", "texture": 3},
            {"type": "metal", "texture": 4, "fuzz": 0.1},
            {"type": "lambertian", "texture": 5},
            {"type": "dielectric", "ir": 1.5},
            {"type": "light", "texture": 6},
        ],
        "primitives": [
            {"type": "sphere", "center": [0, -1000, 0], "radius": 1000, "material": 0},
            {"type": "sphere", "center": [0, 2, 0], "radius": 2, "material": 1},
            {"type": "sphere", "center": [3, 1, 0], "radius": 1, "material": 2},
            {"type": "sphere", "center": [-3, 1, 0], "radius": 1, "material": 4},
            {"type": "box", "start": [-1, 0, 3], "end": [1, 1, 4], "material": 3},
            {"type": "rect", "plane": "xz", "start": [-2, 6, -2], "end": [2, 6, 2],
             "direction": -1, "material": 5},
            {"type": "triangle", "p1": [0, 0, 0], "p2": [1, 0, 0], "p3": [0, 1, 0],
             "normal": [0, 0, 1], "material": 3},
            {"type": "obj", "path": "m.obj"},
        ],
        "camera": {"type": "static", "lookfrom": [13, 2, 3], "lookat": [0, 0, 0],
                   "up": [0, 1, 0], "vfov": 20.0},
        "image": {"width": 16, "height": 16, "samples_per_pixel": 2,
                  "max_bounces": 3, "background": [1, 1, 1]},
    }


def _orbit_doc():
    doc = dict(CORNELL_DOC)
    doc["camera"] = {"type": "orbit", "radius": 900.0, "lookat": [278, 278, 278],
                     "y_base": 278.0, "y_amp": 100.0, "vfov": 40.0}
    doc["animation"] = {"fps": 24.0, "duration": 2.5}
    return doc


@pytest.mark.parametrize("which", ["cornell", "textured", "orbit"])
def test_json_tables_match_jax(which, tmp_path):
    """Every table a JSON document builds equals the JAX package's, bit
    for bit; the image texture's texels (a PNG through read_png, and
    Pillow on the JAX side) too; the output settings and the camera at
    t in {0, 0.25, 0.5} agree."""
    doc = {"cornell": CORNELL_DOC, "textured": None, "orbit": _orbit_doc()}[which]
    if doc is None:
        doc = _textured_doc(tmp_path)
    path = os.path.join(tmp_path, "scene.json")
    save_scene_json(path, doc)
    sd = load_scene_json(path)
    jsd = j_scene_def_from_dict(json.load(open(path)), base_dir=str(tmp_path))
    _assert_tables_equal(jsd.build(), sd.build())
    assert sd.name == "scene"
    img, jimg = sd.output.image, jsd.output.image
    assert (img.width, img.height, img.samples_per_pixel, img.max_bounces,
            img.background) == (jimg.width, jimg.height, jimg.samples_per_pixel,
                                jimg.max_bounces, jimg.background)
    assert (sd.output.is_animation, sd.output.num_frames) == (
        jsd.output.is_animation, jsd.output.num_frames)
    for t in (0.0, 0.25, 0.5):
        cam, jcam = sd.camera_at(t), jsd.camera_at(t)
        for f in ("origin", "lower_left_corner", "horizontal", "vertical", "u", "v",
                  "lens_radius"):
            np.testing.assert_allclose(getattr(cam, f).numpy(),
                                       np.asarray(getattr(jcam, f)),
                                       rtol=1e-6, atol=1e-6, err_msg=f"{f} at t={t}")
    if which == "textured":
        img = np.asarray(Image.open(os.path.join(tmp_path, "tex.png")).convert("RGB"))
        texels = sd.build().textures.images[0, :5, :7].numpy()
        np.testing.assert_array_equal(texels, (img.astype(np.float32) / 255.0) ** 2.0)
    if which == "orbit":
        assert sd.output.num_frames == 60
        assert not np.allclose(sd.camera_at(0.0).origin.numpy(),
                               sd.camera_at(0.25).origin.numpy())


def test_json_cornell_renders_as_builtin():
    """The JSON CornellBox renders bit for bit as the built-in one (the
    same tables give the same bits), and within the image contract of
    the JAX package's JSON render."""
    sd_json = scene_def_from_dict(CORNELL_DOC, name="cornell_json")
    sd_code = get_scene("CornellBox")
    assert sd_json.output.image == sd_code.output.image
    s = RenderSettings(24, 24, 4, 5, (0.0, 0.0, 0.0))
    a, sa = render_radiance(sd_json.build(), sd_json.camera_at(0.0), s, prng_key(2),
                            device="cpu")
    b, sb = render_radiance(sd_code.build(), sd_code.camera_at(0.0), s, prng_key(2),
                            device="cpu")
    assert torch.equal(a, b) and float(sa.segments) == float(sb.segments)
    import jax

    jsd = j_scene_def_from_dict(CORNELL_DOC)
    jimg, _ = j_render_radiance(jsd.build(), jsd.camera_at(0.0),
                                JRenderSettings(24, 24, 4, 5, (0.0, 0.0, 0.0)),
                                jax.random.PRNGKey(2))
    agree = image_agreement(a.numpy(), np.asarray(jimg))
    assert agree["ok"], agree


def test_json_errors(tmp_path):
    for section, bad in (("textures", {"type": "marble"}), ("materials", {"type": "glow"}),
                         ("primitives", {"type": "cone"})):
        doc = dict(CORNELL_DOC, **{section: list(CORNELL_DOC[section]) + [bad]})
        with pytest.raises(ValueError, match="unknown"):
            scene_def_from_dict(doc).build()
    with pytest.raises(ValueError, match="camera"):
        scene_def_from_dict(dict(CORNELL_DOC, camera={"type": "fisheye"}))


@pytest.mark.parametrize("name", sorted(SCENES))
def test_num_frames_match_jax(name):
    out, jout = get_scene(name).output, j_get_scene(name).output
    assert (out.is_animation, out.num_frames, out.fps) == (
        jout.is_animation, jout.num_frames, jout.fps)


@pytest.mark.parametrize("fps,duration", [(30.0, 10.0), (24.0, 2.5), (0.0, 5.0),
                                          (30.0, 0.0), (29.97, 1.0)])
def test_output_settings_match_jax(fps, duration):
    img = RenderSettings(4, 4, 1, 1, (0.0, 0.0, 0.0))
    jimg = JRenderSettings(4, 4, 1, 1, (0.0, 0.0, 0.0))
    o, jo = OutputSettings(img, fps, duration), JOutputSettings(jimg, fps, duration)
    assert (o.is_animation, o.num_frames) == (jo.is_animation, jo.num_frames)


# ---------------------------------------------------------------------------
# PNG input
# ---------------------------------------------------------------------------

_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _filter_rows(px, bpp, ftypes):
    """Scanlines of ``px`` ((h, stride) uint8), row y filtered with
    ``ftypes[y % len(ftypes)]`` (PNG spec 9.2)."""
    h, stride = px.shape
    out, prior = [], np.zeros(stride, np.int64)
    for y in range(h):
        ft = ftypes[y % len(ftypes)]
        cur = px[y].astype(np.int64)
        left = np.concatenate([np.zeros(bpp, np.int64), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int64), prior[:-bpp]])
        if ft == 0:
            pred = np.zeros(stride, np.int64)
        elif ft == 1:
            pred = left
        elif ft == 2:
            pred = prior
        elif ft == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prior, upleft))
        out.append(bytes([ft]) + ((cur - pred) & 0xFF).astype(np.uint8).tobytes())
        prior = cur
    return b"".join(out)


def _chunk(tag, data):
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def _write_png(path, px, ctype, ftypes, depth=8, interlace=0, palette=None):
    h, w = px.shape[:2]
    body = _filter_rows(px.reshape(h, -1), max(1, _CHANNELS[ctype] * depth // 8), ftypes)
    chunks = [_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))]
    if palette is not None:
        chunks.append(_chunk(b"PLTE", palette.tobytes()))
        chunks.append(_chunk(b"tRNS", bytes(range(0, 256, 16))))
    chunks += [_chunk(b"IDAT", zlib.compress(body)[:40]),
               _chunk(b"IDAT", zlib.compress(body)[40:]), _chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + b"".join(chunks))


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
@pytest.mark.parametrize("ctype,ftypes", [
    (2, (0,)), (2, (1,)), (2, (2,)), (2, (3,)), (2, (4,)),
    (0, (0, 1, 2, 3, 4)), (3, (4, 3, 2, 1, 0)), (4, (1, 4, 3)), (6, (3, 2, 4, 1, 0)),
])
def test_read_png_matches_pillow(ctype, ftypes, tmp_path):
    """Each filter type on RGB rows, and every colour type with the five
    filters mixed: read_png equals Pillow's convert("RGB")."""
    rng = np.random.default_rng(ctype * 10 + ftypes[0])
    h, w, ch = 9, 11, _CHANNELS[ctype]
    ramp = np.add.outer(np.arange(h) * 20, np.arange(w) * 9)[..., None]
    px = ((ramp + rng.integers(0, 40, (h, w, ch))) % 256).astype(np.uint8)
    palette = None
    if ctype == 3:
        palette = rng.integers(0, 256, (60, 3), dtype=np.uint8)
        px = (px % 60).astype(np.uint8)
    path = str(tmp_path / "t.png")
    _write_png(path, px, ctype, ftypes, palette=palette)
    want = np.asarray(Image.open(path).convert("RGB"))
    got = read_png(path)
    assert got.dtype == np.uint8 and got.shape == (h, w, 3)
    np.testing.assert_array_equal(got, want)


def test_read_png_reads_write_png_and_pillow(tmp_path):
    """The port's own write_png, and Pillow's adaptive filters."""
    rgb = np.random.default_rng(1).integers(0, 256, (13, 17, 3), dtype=np.uint8)
    write_png(str(tmp_path / "a.png"), rgb)
    np.testing.assert_array_equal(read_png(str(tmp_path / "a.png")), rgb)
    smooth = np.add.outer(np.arange(40), np.arange(50))[..., None] * np.array([1, 2, 3])
    smooth = (smooth % 256).astype(np.uint8)
    for mode in ("RGB", "RGBA", "L", "LA", "P"):
        im = Image.fromarray(smooth, "RGB")
        im = im.quantize(32) if mode == "P" else im.convert(mode)
        im.save(str(tmp_path / f"{mode}.png"))
        np.testing.assert_array_equal(
            read_png(str(tmp_path / f"{mode}.png")),
            np.asarray(Image.open(str(tmp_path / f"{mode}.png")).convert("RGB")))


@pytest.mark.parametrize("kind", ["16-bit", "interlaced", "4-bit"])
def test_read_png_refuses(kind, tmp_path):
    path = str(tmp_path / "x.png")
    px = np.zeros((4, 4, 6 if kind == "16-bit" else 3), np.uint8)
    if kind == "16-bit":
        _write_png(path, px, 2, (0,), depth=16)
    elif kind == "interlaced":
        _write_png(path, px, 2, (0,), interlace=1)
    else:
        _write_png(path, np.zeros((4, 2, 1), np.uint8), 0, (0,), depth=4)
    with pytest.raises(ValueError, match="bit depth|interlaced"):
        read_png(path)


# ---------------------------------------------------------------------------
# GIF output
# ---------------------------------------------------------------------------

def _decode_gif(path):
    """(frames as (H, W, 3) float arrays, size, duration, loop) by Pillow."""
    im = Image.open(path)
    frames, durations = [], []
    for i in range(im.n_frames):
        im.seek(i)
        durations.append(im.info.get("duration"))
        frames.append(np.asarray(im.convert("RGB")).astype(np.float64))
    return frames, im.size, durations, im.info.get("loop")


def _smooth_frames(n, h, w, seed):
    """Gradients that move from frame to frame, with noise: more than 256
    colours, so the palette and the dithering matter."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = []
    for f in range(n):
        img = np.stack([127 + 120 * np.sin(xx / w * 6 + f), 127 + 120 * np.cos(yy / h * 4 - f),
                        (xx + yy + 20 * f) % 256], -1) + rng.normal(0, 8, (h, w, 3))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def _render_frames(n):
    """SphereField frames of an orbit, rendered by the port."""
    sd = get_scene("SphereField")
    scene, s = sd.build(), RenderSettings(40, 24, 2, 3, (1.0, 1.0, 1.0))
    return [to_rgb8(render_radiance(scene, sd.camera_at(f / n), s, prng_key(0),
                                    device="cpu")[0].numpy()) for f in range(n)]


@pytest.mark.parametrize("frames,fps", [("smooth", 30.0), ("render", 24.0),
                                        ("smooth1", 7.0)])
def test_write_gif_against_jax(frames, fps, tmp_path):
    """Decoded by Pillow: the frame count, size, delay and loop of JAX's
    GIF; each frame's mean absolute error against its input at most
    1.25x JAX's plus half a level."""
    imgs = {"smooth": lambda: _smooth_frames(5, 48, 64, 0),
            "render": lambda: _render_frames(4),
            "smooth1": lambda: _smooth_frames(1, 30, 20, 1)}[frames]()
    ours, theirs = str(tmp_path / "ours.gif"), str(tmp_path / "jax.gif")
    write_gif(ours, imgs, fps)
    j_write_gif(theirs, imgs, fps)
    got, want = _decode_gif(ours), _decode_gif(theirs)
    assert open(ours, "rb").read(6) == b"GIF89a"
    assert (len(got[0]), got[1], got[2], got[3]) == (len(want[0]), want[1], want[2],
                                                     want[3])
    assert got[3] == 0 and got[2][0] == int(int(1000 / fps) / 10) * 10
    for i, img in enumerate(imgs):
        mae = np.abs(got[0][i] - img).mean()
        jmae = np.abs(want[0][i] - img).mean()
        assert mae <= 1.25 * jmae + 0.5, (i, mae, jmae)


@pytest.mark.parametrize("n", [3, 18])
def test_write_gif_exact_under_256_colours(n, tmp_path):
    """Frames of at most 256 colours come back exactly (the palette holds
    them all, so dithering moves nothing); noise of 200 colours over
    100x90 pixels fills the LZW table many times over (clear codes);
    18 frames are dithered in two groups.  A StageTimer given to
    write_gif gains its three stages."""
    rng = np.random.default_rng(4)
    table = rng.integers(0, 256, (200, 3), dtype=np.uint8)
    imgs = [table[rng.integers(0, 200, (90, 100))] for _ in range(n - 1)]
    imgs.append(np.broadcast_to(table[7], (90, 100, 3)).copy())  # one long run
    path = str(tmp_path / "x.gif")
    timer = StageTimer()
    write_gif(path, imgs, 10.0, timer=timer)
    assert sorted(timer.stages) == ["gif dither", "gif lzw", "gif palette"]
    assert all(s > 0.0 for s in timer.stages.values())
    got, size, durations, loop = _decode_gif(path)
    assert size == (100, 90) and durations == [100] * n and loop == 0
    for g, want in zip(got, imgs):
        np.testing.assert_array_equal(g, want)


def _lzw_decode(data):
    """A plain GIF LZW decoder (the spec's) at the minimum code size 8
    that write_gif's image blocks declare, to hold lzw_encode to."""
    clear, end = 256, 257
    bits = int.from_bytes(data, "little")
    pos, out = 0, []
    width, table, prev = 9, None, None
    while True:
        code = (bits >> pos) & ((1 << width) - 1)
        pos += width
        if code == clear:
            table = {i: [i] for i in range(clear)}
            width, prev = 9, None
            continue
        if code == end:
            return out
        if prev is None:
            entry = table[code]
        else:
            entry = table[code] if code in table else prev + prev[:1]
            if len(table) + 2 < 4096:
                table[len(table) + 2] = prev + entry[:1]
                if len(table) + 2 == 1 << width and width < 12:
                    width += 1
        out += entry
        prev = entry


@pytest.mark.parametrize("n,colours", [(0, 1), (1, 1), (5000, 2), (20000, 256),
                                       (3000, 7)])
def test_lzw_round_trip(n, colours):
    data = np.random.default_rng(n).integers(0, colours, n).astype(np.uint8).tobytes()
    assert bytes(_lzw_decode(lzw_encode(data))) == data


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------

def test_metrics_report(capsys):
    m = RenderMetrics(width=4, height=2, spp=2)
    m.segments, m.wall_seconds, m.frames = 48.0, 2.0, 2
    m.add_occupancy([16, 8, 0])
    m.add_occupancy([16, 4, 0])
    assert m.rays_per_sec == 24.0 and m.avg_path_length == 1.5
    assert m.occupancy == [32.0, 12.0, 0.0]
    t = StageTimer()
    with t.stage("render"):
        pass
    with t.stage("render"):
        pass
    m.report()
    t.report()
    err = capsys.readouterr().err
    assert "avg path length 1.50" in err and "occupancy by bounce: 1.00 0.38" in err
    assert "[timing] render:" in err


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

SF = ["--scene", "SphereField", "--width", "16", "--height", "9", "--spp", "2",
      "--max-bounces", "3", "--device", "cpu"]


def _png(path):
    return open(path, "rb").read()


def _frame_pngs(out, frames):
    return {f: _png(os.path.join(out, f"image_{f:04d}.png")) for f in frames}


def _want_pngs(tmp_path, frames, n, spp=2, bounces=3, seed=0):
    """PNG bytes of render_radiance at each frame's camera t = f / n."""
    sd = get_scene("SphereField")
    scene = sd.build()
    s = RenderSettings(16, 9, spp, bounces, (1.0, 1.0, 1.0))
    out, segs = {}, {}
    for f in frames:
        img, st = render_radiance(scene, sd.camera_at(f / n), s, prng_key(seed),
                                  device="cpu")
        p = str(tmp_path / "want" / f"{f}.png")
        write_png(p, to_rgb8(img.numpy()))
        out[f], segs[f] = _png(p), float(st.segments)
    return out, segs


def test_cli_list_scenes(capsys):
    assert cli.main(["--list-scenes"]) == 0
    assert capsys.readouterr().out.split() == sorted(SCENES)
    with pytest.raises(SystemExit):
        cli.main(["--scene", "CornellBox", "--list-scenes"])


def test_cli_scene_json(tmp_path, capsys):
    """--scene-json renders the JSON CornellBox: the PNG of the built-in
    scene's render, byte for byte; the summary line names the scene."""
    path = str(tmp_path / "cornell.json")
    save_scene_json(path, CORNELL_DOC)
    out = str(tmp_path / "out")
    assert cli.main(["--scene-json", path, "--width", "16", "--height", "16", "--spp", "2",
                     "--max-bounces", "3", "--device", "cpu", "--output-dir", out,
                     "--quiet"]) == 0
    text = capsys.readouterr()
    assert "cornell 16x16 spp=2 bounces=3 frames=1" in text.out and text.err == ""
    sd = get_scene("CornellBox")
    img, _ = render_radiance(sd.build(), sd.camera_at(0.0),
                             RenderSettings(16, 16, 2, 3, (0.0, 0.0, 0.0)), prng_key(0),
                             device="cpu")
    write_png(str(tmp_path / "want.png"), to_rgb8(img.numpy()))
    assert _png(os.path.join(out, "image_0000.png")) == _png(str(tmp_path / "want.png"))


def test_cli_animation(tmp_path, capsys):
    """A 3-frame SphereField animation: every PNG is render_radiance's at
    t = f / 3, the timing log has a line a frame with its segments, the
    GIF decodes to 3 frames; --frame-start renders the rest only, and
    --rebuild-bvh the same bytes."""
    out, log = str(tmp_path / "anim"), str(tmp_path / "log" / "t.jsonl")
    want, segs = _want_pngs(tmp_path, range(3), 3)
    assert cli.main(SF + ["--frames", "3", "--gif", "--timing-log", log,
                          "--output-dir", out]) == 0
    text = capsys.readouterr()
    assert "frames=3" in text.out and "[metrics]" in text.err and "[timing] gif" in text.err
    assert _frame_pngs(out, range(3)) == want
    lines = [json.loads(x) for x in open(log)]
    assert [x["frame"] for x in lines] == [0, 1, 2]
    assert [x["segments"] for x in lines] == [segs[f] for f in range(3)]
    assert all(x["seconds"] >= 0 for x in lines)
    frames, size, durations, loop = _decode_gif(os.path.join(out, "animation.gif"))
    assert len(frames) == 3 and size == (16, 9) and loop == 0  # SphereField: 30 fps
    assert durations == [30] * 3
    rest = str(tmp_path / "rest")
    assert cli.main(SF + ["--frames", "3", "--frame-start", "1", "--rebuild-bvh",
                          "--output-dir", rest, "--quiet"]) == 0
    assert sorted(os.listdir(rest)) == ["image_0001.png", "image_0002.png"]
    assert _frame_pngs(rest, (1, 2)) == {f: want[f] for f in (1, 2)}
    with pytest.raises(SystemExit):
        cli.main(SF + ["--frames", "3", "--frame-start", "3", "--output-dir", rest])


def test_probe_frames_match_jax():
    """The sticky schedule's probe poses, the JAX CLI's formula
    (cli.py:212-219) for a first run and for resumed ranges."""
    for start, frames in ((0, 300), (297, 300), (0, 3), (1, 3), (5, 6), (0, 8), (2, 11)):
        n = min(8, frames - start)
        span = frames - start
        want = sorted({start + (i * (span - 1)) // max(1, n - 1) for i in range(n)})
        assert cli.probe_frames(start, frames) == want


def test_cli_sticky_auto(tmp_path, capsys):
    """--cascade auto over an animation: one schedule, printed once,
    derived from the probe of the frames to render; every frame the
    chunked frame's bytes; a second run over the same range derives the
    same schedule."""
    args = SF[:6] + ["--max-bounces", "8", "--spp", "4", "--device", "cpu",
                      "--frames", "3", "--cascade", "auto"]
    want, _ = _want_pngs(tmp_path, range(3), 3, spp=4, bounces=8)
    scheds = []
    for run in ("a", "b"):
        out = str(tmp_path / run)
        assert cli.main(args + ["--output-dir", out]) == 0
        err = capsys.readouterr().err
        lines = [x for x in err.splitlines() if x.startswith("auto cascade schedule")]
        assert len(lines) == 1, err
        scheds.append(lines[0])
        assert _frame_pngs(out, range(3)) == want
    assert scheds[0] == scheds[1] and "None" not in scheds[0], scheds


def test_cli_overflow_retry(tmp_path, capsys, monkeypatch):
    """A kept "auto" schedule that overflows on a frame is derived again
    at double the margin and the frame rendered again: the same bytes."""
    real = cli.AUTO_STICKY_SLACK
    monkeypatch.setattr(cli, "AUTO_STICKY_SLACK", 0.05 / render.AUTO_MARGIN * real)
    args = SF[:6] + ["--max-bounces", "8", "--spp", "4", "--device", "cpu",
                      "--frames", "2", "--cascade", "auto"]
    want, _ = _want_pngs(tmp_path, range(2), 2, spp=4, bounces=8)
    out = str(tmp_path / "out")
    assert cli.main(args + ["--output-dir", out]) == 0
    err = capsys.readouterr().err
    assert "deriving again at margin" in err, err
    assert _frame_pngs(out, range(2)) == want


class _Stop(Exception):
    pass


def test_cli_frame_checkpoints_resume(tmp_path, monkeypatch):
    """--checkpoint over an animation keeps FILE.frameNNNN a frame (the
    JAX CLI's names); stopped in the middle of frame 1, a second run
    resumes frame 1 from its file (it renders none of frame 0's chunks
    and only frame 1's last two) and writes the PNGs of the
    uninterrupted run."""
    args = SF + ["--frames", "3", "--spp", "4", "--spp-chunk", "1", "--quiet"]
    full = str(tmp_path / "full")
    assert cli.main(args + ["--output-dir", full]) == 0
    ckpt, out = str(tmp_path / "ck" / "anim.npz"), str(tmp_path / "out")
    real, calls = render._render_chunk, []

    def stopping(*a, **k):
        if len(calls) == 6:  # frame 0's 4 chunks, then 2 of frame 1's
            raise _Stop()
        calls.append(a[3])
        return real(*a, **k)

    monkeypatch.setattr(render, "_render_chunk", stopping)
    with pytest.raises(_Stop):
        cli.main(args + ["--checkpoint", ckpt, "--output-dir", out])
    monkeypatch.setattr(render, "_render_chunk", real)
    assert sorted(os.listdir(str(tmp_path / "ck"))) == ["anim.npz.frame0000",
                                                        "anim.npz.frame0001"]
    assert load_checkpoint(ckpt + ".frame0001").samples_done == 2
    sd = get_scene("SphereField")
    frame_of = {tuple(sd.camera_at(f / 3).origin.tolist()): f for f in range(3)}
    resumed = []

    def counting(*a, **k):
        resumed.append((frame_of.get(tuple(a[1].origin.tolist())), a[3]))
        return real(*a, **k)

    monkeypatch.setattr(render, "_render_chunk", counting)
    assert cli.main(args + ["--checkpoint", ckpt, "--output-dir", out]) == 0
    monkeypatch.setattr(render, "_render_chunk", real)
    assert resumed == [(1, 2), (1, 3), (2, 0), (2, 1), (2, 2), (2, 3)]
    assert load_checkpoint(ckpt + ".frame0002").samples_done == 4
    assert _frame_pngs(out, range(3)) == _frame_pngs(full, range(3))


def test_cli_debug_nans(tmp_path):
    """--debug-nans raises after the first frame whose image holds a NaN
    (a NaN white albedo); without it the frame is written."""
    doc = json.loads(json.dumps(CORNELL_DOC))
    doc["textures"][1]["color"] = [float("nan"), 0.73, 0.73]
    path = str(tmp_path / "nan.json")
    save_scene_json(path, doc)
    args = ["--scene-json", path, "--width", "8", "--height", "8", "--spp", "2",
            "--max-bounces", "3", "--device", "cpu", "--quiet"]
    with pytest.raises(FloatingPointError, match="frame 0"):
        cli.main(args + ["--debug-nans", "--output-dir", str(tmp_path / "a")])
    assert not os.path.exists(str(tmp_path / "a" / "image_0000.png"))
    assert cli.main(args + ["--output-dir", str(tmp_path / "b")]) == 0


def test_cli_profile_dir(tmp_path):
    trace = str(tmp_path / "prof")
    assert cli.main(["--scene", "CornellBox", "--width", "8", "--height", "8", "--spp",
                     "1", "--max-bounces", "2", "--device", "cpu", "--profile-dir", trace,
                     "--output-dir", str(tmp_path / "o"), "--quiet"]) == 0
    doc = json.load(open(os.path.join(trace, "trace.json")))
    assert len(doc["traceEvents"]) > 0


def test_cli_frames_match_jax_cli(tmp_path):
    """The port's CLI and the JAX CLI on the same arguments (SphereField,
    3 frames; --bvh left at its default, which the JAX CLI's --scene path
    ignores): every frame under the image contract."""
    args = ["--scene", "SphereField", "--width", "16", "--height", "9", "--spp", "2",
            "--max-bounces", "3", "--frames", "3", "--quiet"]
    ours, theirs = str(tmp_path / "ours"), str(tmp_path / "jax")
    assert cli.main(args + ["--device", "cpu", "--output-dir", ours]) == 0
    assert j_main(args + ["--output-dir", theirs]) == 0
    for f in range(3):
        name = f"image_{f:04d}.png"
        got = read_png(os.path.join(ours, name)) / 255.0
        want = np.asarray(Image.open(os.path.join(theirs, name)).convert("RGB")) / 255.0
        agree = image_agreement(got, want)
        assert agree["ok"], (f, agree)


def test_cli_scene_json_mesh_two_ranks(tmp_path):
    """--scene-json with --mesh 2x1 on two gloo ranks: rank 0 writes the
    single-process CLI's PNG, byte for byte."""
    path = str(tmp_path / "cornell.json")
    save_scene_json(path, CORNELL_DOC)
    small = ["--scene-json", path, "--width", "8", "--height", "8", "--spp", "2",
             "--max-bounces", "3", "--device", "cpu", "--quiet"]
    out = str(tmp_path / "mesh")
    os.makedirs(out)
    argv = [os.sys.executable, "-m", "rust_pathtracer_tpu_torch.cli", *small, "--mesh",
            "2x1", "--init-method", "file://" + os.path.join(out, "store"),
            "--output-dir", out]
    envs = [dict(RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r)) for r in range(2)]
    logs = run_processes([argv] * 2, envs, out, 120, "json-mesh")
    assert "mesh=2x1" in logs[0] and "wrote" not in logs[1]
    single = str(tmp_path / "single")
    assert cli.main(small + ["--output-dir", single]) == 0
    png = "image_0000.png"
    assert _png(os.path.join(out, png)) == _png(os.path.join(single, png))
