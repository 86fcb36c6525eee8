#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Drives ``rust_pathtracer_tpu_torch`` (never JAX) through its main path,
the non-differentiable forward render, and checks it:

1. device: a CUDA GPU must be present (no CPU fallback); prints the
   card's name and power limit and the torch and nvcc versions;
2. build: builds K1 (``ops/csrc/fused_bounce.cu``) with nvcc for sm_90a;
3. K1 against its plain PyTorch version on 1,000,000 random lanes of a
   scene that covers every branch: alive mask, hit mask and winning
   primitive equal on every lane, floats within 1e-5 relative + 1e-6
   absolute, apart from at most 10 checker lanes whose sin-product lies
   within 1e-6 of 0 (sin differs by ulps between the CPU and the card);
4. the four golden configurations rendered on the card against
   ``tests/goldens/*.npy`` (the JAX package's renders) under the image
   contract of ``utils/image.py``;
5. the serving render at full size: CornellBox 400x400, 20 bounces,
   960,000 lanes a chunk, 60 spp; finite, >= 0, deterministic, and every
   bounce launched K1; then the bench-shaped forward (512^2, 4 spp, 20
   bounces) and K1's time beside the plain version's at 960,000 lanes.

Any failed check exits non-zero.  On success the last two lines are a
JSON object of the kernels' numbers and the JSON verdict
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "output", "chip_smoke")  # git-ignored

K1_LANES = 1_000_000
K1_RTOL, K1_ATOL = 1e-5, 1e-6
CHECKER_SINES_EPS = 1e-6
MAX_EXPLAINED_FLIPS = 10

# tests/golden_utils.py GOLDEN_CONFIGS: name -> (width, height, spp, bounces)
GOLDEN_CONFIGS = {
    "TwoSphereCheckers": (64, 36, 16, 8),
    "LightTest": (64, 36, 16, 12),
    "CornellBox": (64, 64, 16, 12),
    "TriangleTest": (64, 64, 16, 12),
}
GOLDEN_SEED = 1234

SERVE = dict(width=400, height=400, spp=60, spp_chunk=6, bounces=20, seed=0)
BENCH = dict(width=512, height=512, spp=4, bounces=20, runs=5)


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def log(msg: str):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(torch):
    log("== phase 1: device")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    from rust_pathtracer_tpu_torch.ops._build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60)
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"device {torch.cuda.get_device_name(0)}; "
        f"device_count {torch.cuda.device_count()}; "
        f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    return card


def phase_build():
    log("== phase 2: build K1")
    from rust_pathtracer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.load_library("fused_bounce")
    info = _build.build_info["fused_bounce"]
    log(f"built {_build.CSRC / 'fused_bounce.cu'} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc {info['seconds']:.2f} s)")
    log(f"command: {info['command']}")
    for line in info["log"].splitlines():
        if "registers" in line or "spill" in line or "error" in line:
            log(f"  ptxas: {line.strip()}")


def full_scene(device):
    """Every primitive kind, every material (metal with fuzz, dielectric,
    a hollow shell, a light) and solid / checker / perlin textures
    (tests/test_fused_bounce.py::_full_scene)."""
    from rust_pathtracer_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    checker = b.checker_texture(
        b.solid_texture((0.2, 0.3, 0.1)), b.solid_texture((0.9, 0.9, 0.9))
    )
    perlin = b.perlin_texture(4.0)
    b.add_sphere((0, -100.5, -3), 100.0, b.lambertian(checker))
    b.add_sphere((0, 0.5, -3), 0.5, b.lambertian(perlin))
    b.add_sphere((1.2, 0.5, -3), 0.5, b.metal((0.8, 0.7, 0.6), fuzz=0.2))
    b.add_sphere((-1.2, 0.5, -3), 0.5, b.dielectric(1.5))
    b.add_sphere((-1.2, 0.5, -3), -0.4, b.dielectric(1.5))  # hollow shell
    b.add_rect("xz", (-2, 3.0, -5), (2, 3.0, -1), -1.0,
               b.diffuse_light((4, 4, 4)))
    b.add_triangle((2.2, 0.0, -4), (3.2, 0.0, -4), (2.7, 1.2, -4),
                   b.lambertian((0.6, 0.2, 0.2)))
    return b.build(use_bvh=False, device=device)


def random_lanes(n: int, seed: int = 20261016):
    """Rays, throughputs, radiance, alive flags and uniforms from numpy:
    80% from a viewpoint in front of the scene, 10% from inside the glass
    shell, 10% from under the light looking up."""
    rng = np.random.default_rng(seed)
    o = np.array([0.0, 0.8, 1.5]) + rng.normal(0.0, 0.3, (n, 3))
    ang = rng.uniform(-0.6, 0.6, n)
    d = np.stack([np.sin(ang), rng.uniform(-0.9, 0.5, n), -np.cos(ang)], 1)
    d *= rng.uniform(0.5, 2.0, n)[:, None]  # directions are unnormalized
    idx = rng.permutation(n)
    shell, light = idx[: n // 10], idx[n // 10: n // 5]
    o[shell] = np.array([-1.2, 0.5, -3.0]) + rng.uniform(-0.3, 0.3, (len(shell), 3))
    d[shell] = rng.normal(0.0, 1.0, (len(shell), 3))
    o[light] = np.array([0.0, 1.5, -3.0]) + rng.uniform(-1.5, 1.5, (len(light), 3))
    d[light] = np.array([0.0, 1.0, 0.0]) + rng.normal(0.0, 0.4, (len(light), 3))
    thr = rng.uniform(0.2, 1.0, (n, 3))
    rad = rng.uniform(0.0, 0.5, (n, 3))
    alive = (rng.random(n) < 0.9).astype(np.float64)
    cols = np.concatenate([o, d, thr, rad, alive[:, None]], 1).T  # (13, n)
    uni = rng.random((6, n))
    return cols.astype(np.float32), uni.astype(np.float32)


def _cols_on(torch, cols_np, uni_np, device):
    from rust_pathtracer_tpu_torch.ops.fused_bounce import _COL_KEYS

    c = torch.as_tensor(cols_np, device=device)
    u = torch.as_tensor(uni_np, device=device)
    return dict(zip(_COL_KEYS, c.unbind(0))), u.unbind(0)


def phase_kernel_vs_plain(torch, device, n_lanes):
    log(f"== phase 3: K1 vs plain on {n_lanes} lanes")
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
    from rust_pathtracer_tpu_torch.integrator import T_MIN

    cols_np, uni_np = random_lanes(n_lanes)
    bg = (0.2, 0.1, 0.05)
    runs = {}
    for where in ("kernel", "plain"):
        dev = device if where == "kernel" else "cpu"
        scene = full_scene(dev)
        table = fb.pack_prims_shaded(scene)
        cols, uni = _cols_on(torch, cols_np, uni_np, dev)
        win = torch.empty(n_lanes, dtype=torch.int32, device=dev)
        kw = dict(kinds=scene.kinds_static, mat_types=scene.mat_types,
                  tex_types=scene.tex_types, t_min=T_MIN, winner_out=win)
        bgt = torch.tensor(bg, dtype=torch.float32, device=dev)
        fn = fb.fused_bounce_cols if where == "kernel" else fb.fused_bounce_cols_plain
        out = fn(table, bgt, scene.textures.perlin_seed, cols, *uni, **kw)
        if dev != "cpu":
            torch.cuda.synchronize()
        runs[where] = (
            torch.stack([out[k] for k in fb._COL_KEYS]).cpu().numpy(),
            win.cpu().numpy(),
        )
    (k_out, k_win), (p_out, p_win) = runs["kernel"], runs["plain"]
    table = fb.pack_prims_shaded(full_scene("cpu")).numpy()

    alive_in = cols_np[12] > 0.5
    alive_bad = (k_out[12] > 0.5) != (p_out[12] > 0.5)
    win_bad = k_win != p_win
    err = np.abs(k_out.astype(np.float64) - p_out)
    float_bad = (err > K1_ATOL + K1_RTOL * np.abs(p_out)).any(axis=0)

    # the one discrete flip allowed: a checker pick at sin-product ~ 0
    w = np.maximum(p_win, 0)
    is_ck = (p_win >= 0) & (table[fb.PAY_TKIND, w] == 1.0)
    ts = table[fb.PAY_TSCALE, w].astype(np.float64)
    hp = p_out[0:3].astype(np.float64)  # a checker lane continues from its hit point
    sines = np.sin(ts * hp[0]) * np.sin(ts * hp[1]) * np.sin(ts * hp[2])
    explained = float_bad & is_ck & (np.abs(sines) < CHECKER_SINES_EPS)
    unexplained = float_bad & ~explained
    max_abs = float(err[:, ~explained].max()) if (~explained).any() else 0.0

    hits = (p_win >= 0)
    log(f"lanes {n_lanes}: alive in {int(alive_in.sum())}, hits "
        f"{int(hits.sum())}, misses {int((alive_in & ~hits).sum())}, alive out "
        f"{int((p_out[12] > 0.5).sum())}")
    log("winner histogram (prim: lanes): " + ", ".join(
        f"{p}: {int((p_win == p).sum())}" for p in range(table.shape[1])))
    log(f"alive-out mismatches {int(alive_bad.sum())}, winner/hit mismatches "
        f"{int(win_bad.sum())}, float mismatches {int(float_bad.sum())} "
        f"(checker sines ~ 0: {int(explained.sum())}, unexplained "
        f"{int(unexplained.sum())}), max abs err {max_abs:.3e}")
    for i in np.nonzero(win_bad | alive_bad | unexplained)[0][:5]:
        log(f"  lane {i}: winner kernel {k_win[i]} plain {p_win[i]}; "
            f"kernel {k_out[:, i].tolist()}; plain {p_out[:, i].tolist()}")
    check(not alive_bad.any(), "alive-out masks differ")
    check(not win_bad.any(), "hit masks or winning primitives differ")
    check(not unexplained.any(), "floats differ beyond 1e-5 rel + 1e-6 abs")
    check(int(explained.sum()) <= MAX_EXPLAINED_FLIPS,
          f"{int(explained.sum())} checker flips > {MAX_EXPLAINED_FLIPS}")
    return max_abs


def _golden_path(name):
    return os.path.join(REPO, "tests", "goldens", f"{name}.npy")


def phase_goldens(torch, device):
    log("== phase 4: golden configurations on the card")
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.image import image_agreement

    for name, (w, h, spp, nb) in GOLDEN_CONFIGS.items():
        sd = get_scene(name)
        settings = RenderSettings(w, h, spp, nb, sd.output.image.background,
                                  spp_chunk=spp)
        img, _ = render_radiance(sd.build(device=device),
                                 sd.camera_at(0.0, device=device), settings,
                                 prng_key(GOLDEN_SEED, device=device),
                                 device=device)
        got = img.cpu().numpy()
        want = np.load(_golden_path(name))
        a = image_agreement(got, want)
        log(f"{name} {w}x{h} spp={spp} bounces={nb}: mean {got.mean():.6f} vs "
            f"golden {want.mean():.6f} (rel {a['mean_rel']:.2e}), pixels close "
            f"{a['frac_close']:.4f}, nan {a['has_nan']}")
        check(a["ok"], f"{name} breaks the image contract")


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_serve(torch, device, card, serve, bench, time_reps):
    log("== phase 5: serving render at full size")
    from rust_pathtracer_tpu_torch.integrator import T_MIN, _precompute_draws
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
    from rust_pathtracer_tpu_torch.render import (
        RenderSettings, _make_lanes, _render_chunk, render_radiance,
    )
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.image import to_rgb8, write_png

    sd = get_scene("CornellBox")
    scene = sd.build(device=device)
    cam = sd.camera_at(0.0, device=device)
    key = prng_key(serve["seed"], device=device)
    W, H = serve["width"], serve["height"]
    settings = RenderSettings(W, H, serve["spp"], serve["bounces"],
                              sd.output.image.background,
                              spp_chunk=serve["spp_chunk"])
    lanes = W * H * serve["spp_chunk"]

    _sync(torch, device)
    fb.launches = 0
    t0 = time.perf_counter()
    img, stats = render_radiance(scene, cam, settings, key, device=device)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    k1_launches = fb.launches

    img_np = img.cpu().numpy()
    segments = float(stats.segments)
    n_chunks = -(-serve["spp"] // serve["spp_chunk"])
    log(f"CornellBox {W}x{H} spp={serve['spp']} bounces={serve['bounces']} "
        f"({n_chunks} chunks of {lanes} lanes) on {card}: wall {wall:.3f} s, "
        f"segments {segments:.0f}, segments/s {segments / wall:.4e}, mean depth "
        f"{segments / (W * H * serve['spp']):.4f}, bounces {stats.bounces}, "
        f"K1 launches {k1_launches}, image mean {img_np.mean():.6f}")
    check(np.isfinite(img_np).all(), "serving render has non-finite pixels")
    check((img_np >= 0).all(), "serving render has negative pixels")
    if torch.device(device).type == "cuda":
        check(k1_launches > 0, "the serving render launched K1 no time")
        check(k1_launches == stats.bounces,
              f"K1 launches {k1_launches} != bounces run {stats.bounces}")
    os.makedirs(OUT_DIR, exist_ok=True)
    png = os.path.join(OUT_DIR, f"CornellBox_{W}x{H}_{serve['spp']}spp.png")
    write_png(png, to_rgb8(img_np))
    log(f"wrote {png}")

    bg = torch.tensor(sd.output.image.background, dtype=torch.float32,
                      device=device)
    chunk_args = dict(width=W, height=H, spp_chunk=serve["spp_chunk"],
                      spp_total=serve["spp"], max_bounces=serve["bounces"],
                      rr_start=None)
    c0 = _render_chunk(scene, cam, key, 0, bg, **chunk_args)[0].cpu().numpy()
    c1 = _render_chunk(scene, cam, key, 0, bg, **chunk_args)[0].cpu().numpy()
    check(np.array_equal(c0, c1), "chunk 0 rendered twice differs")
    log("chunk 0 rendered twice: bitwise equal")

    # bench-shaped forward: bench.py's step without the backward
    bs = RenderSettings(bench["width"], bench["height"], bench["spp"],
                        bench["bounces"], (0.0, 0.0, 0.0), spp_chunk=bench["spp"])
    times = []
    for rep in range(bench["runs"] + 1):
        _sync(torch, device)
        t0 = time.perf_counter()
        bimg, bstats = render_radiance(scene, cam, bs, key, device=device)
        bimg.sum().item()
        times.append(time.perf_counter() - t0)
    med = statistics.median(times[1:])
    bseg = float(bstats.segments)
    log(f"bench-shaped forward {bench['width']}^2 spp={bench['spp']} "
        f"bounces={bench['bounces']} on {card}: median of {bench['runs']} "
        f"{med * 1e3:.2f} ms (runs {[round(t * 1e3, 2) for t in times[1:]]}), "
        f"segments {bseg:.0f}, segments/s {bseg / med:.4e}")

    # one K1 launch against the plain version at the serving width: the
    # first bounce of chunk 0 (camera rays, bounce-0 draws)
    pix = torch.arange(W * H, dtype=torch.int64, device=device)
    lk, o, d, _ = _make_lanes(cam, key, pix, 0, width=W, height=H,
                              spp_chunk=serve["spp_chunk"],
                              spp_total=serve["spp"])
    dr = _precompute_draws(lk, 1, 2)
    ones = torch.ones(lanes, device=device)
    zeros = torch.zeros(lanes, device=device)
    cols = dict(zip(fb._COL_KEYS, (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1],
                                   d[:, 2], ones, ones, ones, zeros, zeros,
                                   zeros, ones)))
    uni = (dr["sphere_u"][0, :, 0], dr["sphere_u"][0, :, 1],
           dr["ball_u"][0, :, 0], dr["ball_u"][0, :, 1], dr["ball_u"][0, :, 2],
           dr["coin"][0])
    table = fb.pack_prims_shaded(scene)
    kw = dict(kinds=scene.kinds_static, mat_types=scene.mat_types,
              tex_types=scene.tex_types, t_min=T_MIN)

    def k1():
        return fb.fused_bounce_cols(table, bg, scene.textures.perlin_seed,
                                    cols, *uni, **kw)

    def plain():
        return fb.fused_bounce_cols_plain(table, bg, scene.textures.perlin_seed,
                                          cols, *uni, **kw)

    res = {}
    for name, fn in (("plain", plain), ("kernel", k1), ("kernel", k1),
                     ("plain", plain)):
        res.setdefault(name, []).append(_time_ms(torch, device, fn, time_reps))
    k_ms, p_ms = statistics.mean(res["kernel"]), statistics.mean(res["plain"])
    log(f"K1 at {lanes} lanes on {card}: {k_ms:.4f} ms per launch "
        f"(blocks {[round(x, 4) for x in res['kernel']]}); plain version on the "
        f"same CUDA tensors {p_ms:.4f} ms ({[round(x, 4) for x in res['plain']]})")
    return k1_launches, k_ms, p_ms


def _time_ms(torch, device, fn, reps):
    """Mean ms per call over ``reps`` calls after one warm-up call:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def main() -> int:
    if not os.path.isdir(os.path.join(REPO, "rust_pathtracer_tpu_torch")):
        print("FAIL: run chip_smoke.py from a checkout of the repository: "
              "rust_pathtracer_tpu_torch/ is not beside it", flush=True)
        return 2
    sys.path.insert(0, REPO)
    import torch

    device = "cuda"
    card = phase_device(torch)
    phase_build()
    max_abs = phase_kernel_vs_plain(torch, device, K1_LANES)
    phase_goldens(torch, device)
    launches, k_ms, p_ms = phase_serve(torch, device, card, SERVE, BENCH,
                                       time_reps=20)

    kernels = {"kernels": [{
        "name": "fused_bounce (K1)",
        "route": "cuda",
        "source": "rust_pathtracer_tpu_torch/ops/csrc/fused_bounce.cu",
        "replaces": "rust_pathtracer_tpu/ops/fused_bounce.py:169",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
