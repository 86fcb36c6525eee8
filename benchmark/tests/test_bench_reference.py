"""The plain reference: it imports nothing of the program or of JAX, its
random stream is threefry's, and at a toy size it agrees with the port
but where a path parts at a rounding."""

import ast
import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from benchmark import spec
from benchmark.reference import pathtracer as pt
from benchmark.reference import scene as rs
from benchmark.reference import threefry as tf

REF_DIR = os.path.join(spec.ROOT, "benchmark", "reference")
NOT_IMPORTED = {"rust_pathtracer_tpu_torch", "rust_pathtracer_tpu", "jax", "jaxlib", "flax"}


def _imported_tops(path):
    tree = ast.parse(open(path).read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("name", sorted(f for f in os.listdir(REF_DIR) if f.endswith(".py")))
def test_reference_sources_import_nothing_of_the_program(name):
    assert not (_imported_tops(os.path.join(REF_DIR, name)) & NOT_IMPORTED)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys, benchmark.reference.pathtracer, benchmark.reference.scene, "
            "benchmark.reference.threefry; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True).stdout
    loaded = set(eval(out))
    assert not (loaded & NOT_IMPORTED)


def test_threefry_known_answer():
    # Random123's known-answer vector for threefry2x32, 20 rounds
    z = torch.zeros(1, dtype=torch.int64)
    x0, x1 = tf.threefry2x32(z, z, z, z)
    assert (int(x0), int(x1)) == (0x6B200159, 0x99BA4EFE)
    m = torch.full((1,), tf.M32, dtype=torch.int64)
    x0, x1 = tf.threefry2x32(m, m, m, m)
    assert (int(x0), int(x1)) == (0x1CB996FC, 0xBB002BE7)


def test_frame_keys_differ_by_seed_and_index():
    keys = {tuple(tf.frame_key(s, i)) for s in (0, 1, 2**31 + 5, 2**40 + 1) for i in range(4)}
    assert len(keys) == 16
    assert all(0 <= w <= tf.M32 for k in keys for w in k)


@pytest.mark.parametrize("config, t", [("cornellbox", 0.0), ("spherefield", 0.37)])
def test_reference_matches_the_port_at_a_toy_size(config, t):
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import render_radiance

    cfg = spec.config(config)
    W, H, spp, chunk = 14, 9, 4, 2
    sd = get_scene(cfg["scene"])
    settings = dataclasses.replace(sd.output.image, width=W, height=H, samples_per_pixel=spp,
                                   spp_chunk=chunk)
    key = tf.frame_key(3000000123, 5)
    img, _ = render_radiance(sd.build("cpu"), sd.camera_at(t), settings, torch.tensor(key),
                             device="cpu")
    ref = pt.render_pixels(rs.scene_tensors(cfg, "cpu"),
                           rs.camera_frame(rs.camera_params(cfg, t), "cpu"), key,
                           torch.arange(W * H), width=W, height=H, spp=spp, spp_chunk=chunk,
                           max_bounces=cfg["max_bounces"], background=cfg["background"])
    # the reference rounds one way, the port's routes their own (the projected
    # search rounds a sphere's root before it divides), so a path may part
    # at an ulp: at most one pixel in a hundred, the rest to 1e-6
    off = ((img.reshape(-1, 3) - ref).abs() > 1e-6).any(dim=1)
    assert int(off.sum()) <= off.numel() // 100


def test_reference_scene_counts():
    # CornellBox: 6 walls and light, two boxes of 6 rects, two spheres
    assert len(rs.scene_lists(spec.config("cornellbox")).prims) == 20
    sf = rs.scene_lists(spec.config("spherefield")).prims
    assert all(p["kind"] == "sphere" for p in sf) and len(sf) > 128
