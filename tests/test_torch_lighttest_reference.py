"""The port's regen wavefront on LightTest against the benchmark's plain
reference, on the CPU.

``wavefront.render_radiance_regen`` renders LightTest (a perlin marble
ground and sphere, three rect lights, black background) at 16x9, 8 spp,
50 bounces, on the configuration the benchmark's ``lighttest-regen``
cell runs (``benchmark/configs/lighttest.json``), over pools that
refill many times: the queue at 256 and 37 lanes; the stripe mode at 256
and 300 lanes (one lane a pixel-aligned stripe: 144 lanes of 8 samples
and 288 of 4; 37 lanes cannot hold a stripe a pixel at this size).
``benchmark/reference`` (plain PyTorch: no JAX, no kernel of the port)
renders every pixel from the configuration's own data with the same
keys, and the two are compared by the check's numbers: ``pixel_mae``
(the mean absolute gap over the reference's mean absolute value) and
``pixel_max`` (the widest gap of one channel).

Tolerance: ``cornell-render``'s lower readings on the card
(``benchmark/limits/cornell-render.json``: the worst of 13 sound seeds,
``pixel_mae`` 2.96e-5, ``pixel_max`` 0.01095).  The reference and the
port round a sphere's roots in their own order, so a path can part at
an ulp now and then; such a parted path is what those readings allow.
Here no path parts: the gaps read 0.  A parted path of one light (4)
over 8 samples would move a pixel by up to 0.5, over the tolerance, so
the tolerance does not hide one.

Two planted faults must fail it: the marble computed in bfloat16 (its
inputs and result rounded to bfloat16 inside K1's plain twin), and the
depth row dropped, so that every lane of a launch draws at the launch's
bounce instead of its own path depth.
"""

import dataclasses
import itertools
import json
import os

import pytest
import torch

from benchmark.reference import pathtracer as pt
from benchmark.reference import scene as rs
from benchmark.reference.threefry import frame_key
from rust_pathtracer_tpu_torch import wavefront
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.ops import fused_bounce

torch.set_num_threads(2)

CONFIG = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "benchmark", "configs", "lighttest.json")
WIDTH, HEIGHT, SPP, BOUNCES = 16, 9, 8, 50
SEEDS = (3000000017, 11, 2 ** 31 + 5)
POOLS = [("queue", 256), ("queue", 37), ("stripe", 256), ("stripe", 300)]
MAE_TOL = 2.96e-5  # cornell-render's worst sound pixel_mae (13 seeds, H100)
MAX_TOL = 0.01095  # and its worst pixel_max


def _config():
    with open(CONFIG) as f:
        return json.load(f)


def _port(seed, mode, lanes):
    cfg = _config()
    sd = get_scene(cfg["scene"])
    settings = dataclasses.replace(
        sd.output.image, width=WIDTH, height=HEIGHT, samples_per_pixel=SPP,
        max_bounces=BOUNCES, rng_scheme=cfg["rng_scheme"],
        russian_roulette_start=cfg["russian_roulette_start"])
    key = torch.tensor(frame_key(seed, 0), dtype=torch.int64)
    img, stats = wavefront.render_radiance_regen(
        sd.build(device="cpu"), sd.camera_at(0.0, device="cpu"), settings, key,
        lanes=lanes, mode=mode, device="cpu")
    return img.reshape(-1, 3), stats


def _reference(seed):
    cfg = _config()
    with torch.no_grad():
        return pt.render_pixels(
            rs.scene_tensors(cfg, "cpu"), rs.camera_frame(rs.camera_params(cfg), "cpu"),
            frame_key(seed, 0), torch.arange(WIDTH * HEIGHT), width=WIDTH, height=HEIGHT,
            spp=SPP, spp_chunk=SPP, max_bounces=BOUNCES, background=cfg["background"])


def _numbers(got, want):
    gap = (got - want).abs()
    return float(gap.sum() / want.abs().sum()), float(gap.max())


def test_the_configuration_is_the_ports_lighttest():
    """The reference renders the scene the port builds: the same counts,
    the marble and the published settings."""
    cfg = _config()
    sd = get_scene(cfg["scene"])
    image = sd.output.image
    assert (image.width, image.height, image.samples_per_pixel, image.max_bounces) == (
        cfg["width"], cfg["height"], cfg["samples_per_pixel"], cfg["max_bounces"])
    assert tuple(image.background) == tuple(cfg["background"])
    lists = rs.scene_lists(cfg)
    assert len(lists.prims) == sd.build(device="cpu").prims.data.shape[0] == 5
    assert rs.scene_tensors(cfg, "cpu")["tex_kind"].tolist() == [rs.TEX_PERLIN, rs.TEX_SOLID]
    assert cfg["reduced"] == []


@pytest.mark.parametrize("mode, lanes", POOLS)
@pytest.mark.parametrize("seed", SEEDS)
def test_regen_lighttest_matches_the_reference(seed, mode, lanes):
    got, stats = _port(seed, mode, lanes)
    want = _reference(seed)
    mae, worst = _numbers(got, want)
    assert mae <= MAE_TOL and worst <= MAX_TOL, (mae, worst)
    assert float(want.abs().sum()) > 0.0  # the lights reach the camera
    # every one of the frame's paths was traced, by a pool 4-31 times smaller
    assert float(stats.occupancy[0]) == WIDTH * HEIGHT * SPP


def _bf16_marble(monkeypatch):
    real = fused_bounce.marble_planes

    def marble_planes(px, py, pz, seed, scale):
        def b(x):
            return x.to(torch.bfloat16).to(torch.float32)
        return b(real(b(px), b(py), b(pz), seed, b(scale)))
    monkeypatch.setattr(fused_bounce, "marble_planes", marble_planes)


def _no_depth_row(monkeypatch):
    real = wavefront.fused_bounce_keyed
    launch = itertools.count()

    def fused_bounce_keyed(table, bg, seed, state, keys, depth, **kw):
        assert isinstance(depth, torch.Tensor)  # the regen's per-lane form
        return real(table, bg, seed, state, keys, next(launch), **kw)
    monkeypatch.setattr(wavefront, "fused_bounce_keyed", fused_bounce_keyed)


FAULTS = {"bf16_marble": _bf16_marble, "no_depth_row": _no_depth_row}


@pytest.mark.parametrize("mode, lanes", [("queue", 37), ("stripe", 256)])
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_planted_fault_fails_the_tolerance(fault, mode, lanes, monkeypatch):
    FAULTS[fault](monkeypatch)
    got, _ = _port(SEEDS[0], mode, lanes)
    mae, worst = _numbers(got, _reference(SEEDS[0]))
    assert mae > MAE_TOL and worst > MAX_TOL, (mae, worst)
