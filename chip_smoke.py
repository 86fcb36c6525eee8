#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Drives ``rust_pathtracer_tpu_torch`` (never JAX) through its two main
paths, the forward render and the differentiable step of ``bench.py``'s
shape, and checks them:

1. device: a CUDA GPU must be present (no CPU fallback); prints the
   card's name and power limit and the torch and nvcc versions;
2. build: builds K1 (``ops/csrc/fused_bounce.cu``) and K2
   (``ops/csrc/fused_bounce_bwd.cu``) with nvcc for sm_90a, in parallel;
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
   bounces) and K1's time beside the plain version's at 960,000 lanes;
6. K1 with residuals against its plain version on the same 1,000,000
   lanes: flags exact apart from the checker flips of phase 3, residual
   floats within 1e-5 relative + 1e-6 absolute, and the 13 columns bit
   for bit those of K1 without residuals;
7. K2 against its plain version on those lanes, with numpy cotangents:
   the 9 cotangent columns and the (9P + 3) texture and background
   reductions within a stated tolerance, and the reductions bitwise equal
   between two runs;
8. the differentiable step on the card against the same step on the CPU
   (CornellBox 64x64, 4 spp, 8 bounces, roulette from bounce 4): loss and
   every gradient leaf;
9. the bench-shaped step at full width (CornellBox 512x512, 4 spp, 20
   bounces, one chunk of 1,048,576 lanes, loss = mean(img), backward):
   median time over batches as bench.py takes it, segments/s, finite
   gradients, K1 with residuals and K2 launched 20 times a step; the
   step's split by CUDA events; K1-with-residuals and K2 per launch
   beside K1 and the plain versions at 1,048,576 lanes.

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
# K2 vs plain: the same IEEE expressions on the same inputs, so the
# cotangent columns agree to rounding (1e-5 rel + 1e-5 of the largest);
# the reductions sum 1M lanes in another order (1e-5 of the largest)
K2_RTOL, K2_ATOL_REL = 1e-5, 1e-5
# card vs CPU step (tests/test_torch_grad.py's tolerance vs JAX): an ulp
# of sin/cos can reroute a lane, so loss 2e-3 rel, gradients rtol 0.05
# and 2e-3 of the largest gradient
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_GRAD_ATOL_REL = 2e-3, 0.05, 2e-3

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
SMALL_STEP = dict(width=64, height=64, spp=4, bounces=8, rr_start=4)
# bench.py's protocol: batches of REPS steps, the median batch, more
# batches while the spread (max - min) / median exceeds SPREAD_TOL
STEP = dict(reps=5, batches=5, max_batches=12, spread_tol=0.10)
CORNELL_CAM = ((278.0, 278.0, -800.0), (278.0, 278.0, 0.0), (0.0, 1.0, 0.0),
               40.0, 1.0, 0.0, 10.0)
KERNELS = ("fused_bounce", "fused_bounce_bwd")


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
    log("== phase 2: build K1 and K2")
    from concurrent.futures import ThreadPoolExecutor

    from rust_pathtracer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        for fut in [pool.submit(_build.load_library, n) for n in KERNELS]:
            fut.result()  # one nvcc a source, all at once; raises on failure
    log(f"built {', '.join(KERNELS)} in {time.perf_counter() - t0:.2f} s")
    for name in KERNELS:
        info = _build.build_info[name]
        log(f"{_build.CSRC / (name + '.cu')}: nvcc {info['seconds']:.2f} s")
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
    fb.launches = fb.residual_launches = 0
    t0 = time.perf_counter()
    img, stats = render_radiance(scene, cam, settings, key, device=device)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    k1_launches = fb.launches
    check(fb.residual_launches == 0, "the serving render wrote residuals")

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


def _checker_near_zero(np_flags, t, cols_np, table, fb):
    """Lanes whose winning checker's sin-product, at the hit point
    o + t d, lies within CHECKER_SINES_EPS of 0: there an ulp of sin
    on the card may pick the other child."""
    w = np_flags >> fb.FLG_BESTI_SHIFT
    hp = cols_np[0:3].astype(np.float64) + t.astype(np.float64) * cols_np[3:6]
    ts = table[fb.PAY_TSCALE, w].astype(np.float64)
    sines = np.sin(ts * hp[0]) * np.sin(ts * hp[1]) * np.sin(ts * hp[2])
    return ((np_flags & fb.FLG_IS_CK) != 0) & (np.abs(sines) < CHECKER_SINES_EPS)


def phase_residuals(torch, device, n_lanes):
    log(f"== phase 6: K1 with residuals vs plain on {n_lanes} lanes")
    from rust_pathtracer_tpu_torch.integrator import T_MIN
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb

    cols_np, uni_np = random_lanes(n_lanes)
    bg = (0.2, 0.1, 0.05)
    runs = {}
    for where, dev in (("kernel", device), ("plain", "cpu")):
        scene = full_scene(dev)
        cols, uni = _cols_on(torch, cols_np, uni_np, dev)
        args = (fb.pack_prims_shaded(scene),
                torch.tensor(bg, dtype=torch.float32, device=dev),
                scene.textures.perlin_seed, cols, *uni)
        kw = dict(kinds=scene.kinds_static, mat_types=scene.mat_types,
                  tex_types=scene.tex_types, t_min=T_MIN)
        fn = fb.fused_bounce_cols if where == "kernel" else fb.fused_bounce_cols_plain
        out, res = fn(*args, **kw, want_residuals=True)
        run = {"cols": torch.stack([out[k] for k in fb._COL_KEYS]).cpu().numpy(),
               "res": {k: v.cpu().numpy() for k, v in res.items()}}
        if where == "kernel":
            out0 = fb.fused_bounce_cols(*args, **kw)
            run["cols0"] = torch.stack([out0[k] for k in fb._COL_KEYS]).cpu().numpy()
        _sync(torch, dev)
        runs[where] = run
    k, p = runs["kernel"], runs["plain"]
    check(np.array_equal(k["cols"].view(np.uint32), k["cols0"].view(np.uint32)),
          "K1's 13 columns differ between residuals on and off")
    log("K1's 13 columns with residuals on: bit for bit those with residuals off")

    table = fb.pack_prims_shaded(full_scene("cpu")).numpy()
    kf, pf = k["res"]["flags"], p["res"]["flags"]
    near = _checker_near_zero(pf, p["res"]["t"], cols_np, table, fb)
    keys = fb._RES_KEYS[:-1]
    kr = np.stack([k["res"][n] for n in keys]).astype(np.float64)
    pr = np.stack([p["res"][n] for n in keys]).astype(np.float64)
    err = np.abs(kr - pr)
    float_bad = (err > K1_ATOL + K1_RTOL * np.abs(pr)).any(axis=0)
    flag_bad = kf != pf
    bad = flag_bad | float_bad
    explained = bad & near
    unexplained = bad & ~near
    max_abs = float(err[:, ~explained].max()) if (~explained).any() else 0.0
    bits = {n: int(((pf & getattr(fb, n)) != 0).sum()) for n in (
        "FLG_HIT", "FLG_CONT", "FLG_ALIVE", "FLG_REFLECT", "FLG_SINES_NEG",
        "FLG_LIGHT_ON", "FLG_COS_CLAMP", "FLG_REFR_ZERO", "FLG_L_NEG")}
    log(f"flags set (plain): {bits}")
    log(f"flag mismatches {int(flag_bad.sum())}, float mismatches "
        f"{int(float_bad.sum())} (checker sines ~ 0: {int(explained.sum())}, "
        f"unexplained {int(unexplained.sum())}), max abs err {max_abs:.3e}")
    for i in np.nonzero(unexplained)[0][:5]:
        log(f"  lane {i}: flags kernel {kf[i]:#x} plain {pf[i]:#x}; kernel "
            f"{kr[:, i].tolist()}; plain {pr[:, i].tolist()}")
    check(not unexplained.any(),
          "residuals differ beyond 1e-5 rel + 1e-6 abs or in a flag")
    check(int(explained.sum()) <= MAX_EXPLAINED_FLIPS,
          f"{int(explained.sum())} checker flips > {MAX_EXPLAINED_FLIPS}")
    return max_abs, cols_np, p["res"]


def _bwd_args(torch, res_np, cols_np, cot, bg, device):
    """K2's arguments on ``device``: residuals, the incoming d and thr
    of ``cols_np``, the (12, n) cotangents ``cot``, the background."""
    from rust_pathtracer_tpu_torch.ops import fused_bounce_bwd as fbb

    def t(x):
        return torch.tensor(np.ascontiguousarray(x), device=device)

    return ({k: t(v) for k, v in res_np.items()},
            tuple(t(cols_np[3 + c]) for c in range(3)),
            tuple(t(cols_np[6 + c]) for c in range(3)),
            dict(zip(fbb._COT_KEYS, (t(c) for c in cot))),
            torch.tensor(bg, dtype=torch.float32, device=device))


def phase_bwd_vs_plain(torch, device, cols_np, res_np):
    n = cols_np.shape[1]
    log(f"== phase 7: K2 vs plain on {n} lanes")
    from rust_pathtracer_tpu_torch.ops import fused_bounce_bwd as fbb

    scene = full_scene("cpu")
    kw = dict(mat_types=scene.mat_types, n_prims=scene.num_prims)
    cot = np.random.default_rng(7).normal(size=(12, n)).astype(np.float32)
    bg = (0.2, 0.1, 0.05)
    p_g, p_tex, p_bg = fbb.fused_bounce_bwd_plain(
        *_bwd_args(torch, res_np, cols_np, cot, bg, "cpu"), **kw)
    args = _bwd_args(torch, res_np, cols_np, cot, bg, device)
    k_g, k_tex, k_bg = fbb.fused_bounce_bwd(*args, **kw)
    _, k_tex2, k_bg2 = fbb.fused_bounce_bwd(*args, **kw)
    _sync(torch, device)

    got = np.stack([k_g[k].cpu().numpy() for k in fbb._GRAD_KEYS]).astype(np.float64)
    want = np.stack([p_g[k].numpy() for k in fbb._GRAD_KEYS]).astype(np.float64)
    err = np.abs(got - want)
    bad = err > K2_RTOL * np.abs(want) + K2_ATOL_REL * np.abs(want).max()
    red = np.concatenate([p_tex.numpy().ravel(), p_bg.numpy()]).astype(np.float64)
    k_red = np.concatenate([k_tex.cpu().numpy().ravel(), k_bg.cpu().numpy()])
    red_err = np.abs(k_red - red)
    red_bad = red_err > K2_RTOL * np.abs(red) + K2_ATOL_REL * np.abs(red).max()
    same = torch.equal(k_tex, k_tex2) and torch.equal(k_bg, k_bg2)
    log(f"cotangent columns: max abs err {err.max():.3e} (largest value "
        f"{np.abs(want).max():.3e}), {int(bad.any(axis=0).sum())} lanes out of "
        f"tolerance; reductions ({red.size} = 9 x {scene.num_prims} + 3): max abs "
        f"err {red_err.max():.3e} (largest {np.abs(red).max():.3e}), "
        f"{int(red_bad.sum())} out of tolerance; second run bitwise equal: {same}")
    for i in np.nonzero(bad.any(axis=0))[0][:5]:
        log(f"  lane {i}: kernel {got[:, i].tolist()} plain {want[:, i].tolist()}")
    check(not bad.any(), "K2's cotangent columns differ from the plain version")
    check(not red_bad.any(), "K2's reductions differ from the plain version")
    check(same, "K2's reductions differ between two runs")
    return float(max(err.max(), red_err.max()))


def _grad_leaves(g):
    return [x.detach().cpu().numpy().astype(np.float64).ravel() for x in g.leaves()]


def phase_small_step(torch, device):
    cfg = SMALL_STEP
    log(f"== phase 8: differentiable step on the card vs the CPU "
        f"({cfg['width']}x{cfg['height']}, {cfg['spp']} spp, {cfg['bounces']} "
        f"bounces, roulette from {cfg['rr_start']})")
    from rust_pathtracer_tpu_torch.grad import (
        CameraParams, DiffParams, render_loss_and_grad,
    )
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
    from rust_pathtracer_tpu_torch.ops import fused_bounce_bwd as fbb
    from rust_pathtracer_tpu_torch.render import RenderSettings
    from rust_pathtracer_tpu_torch.sampling import prng_key

    scene = get_scene("CornellBox").build()
    settings = RenderSettings(cfg["width"], cfg["height"], cfg["spp"],
                              cfg["bounces"], (0.5, 0.5, 0.5),
                              spp_chunk=cfg["spp"],
                              russian_roulette_start=cfg["rr_start"])
    params = DiffParams.from_scene(scene, CameraParams.create(*CORNELL_CAM),
                                   settings.background)
    target = torch.zeros(cfg["height"], cfg["width"], 3)
    out = {}
    for dev in ("cpu", device):
        fb.residual_launches = fbb.launches = 0
        t0 = time.perf_counter()
        loss, g = render_loss_and_grad(params, scene, settings, prng_key(7),
                                       target, device=dev)
        _sync(torch, dev)
        log(f"{dev}: loss {float(loss):.7f} in {time.perf_counter() - t0:.3f} s, "
            f"K1-res launches {fb.residual_launches}, K2 launches {fbb.launches}")
        if dev != "cpu":
            check(fb.residual_launches == fbb.launches == cfg["bounces"],
                  "the card's step did not launch K1-res and K2 once a bounce")
        out[dev] = (float(loss), _grad_leaves(g))
    (l0, g0), (l1, g1) = out["cpu"], out[device]
    scale = max(np.abs(x).max() for x in g0)
    names = ("tex_color", "background", "lookfrom", "lookat", "up", "vfov_deg",
             "aspect", "aperture", "focus_dist")
    for name, a, b in zip(names, g1, g0):
        err = np.abs(a - b)
        log(f"  {name}: max |grad| {np.abs(b).max():.4e}, max abs diff {err.max():.3e}")
        check(np.isfinite(a).all(), f"non-finite gradient of {name} on the card")
        check((err <= STEP_GRAD_ATOL_REL * scale + STEP_GRAD_RTOL * np.abs(b)).all(),
              f"the card's gradient of {name} differs from the CPU's")
    check(scale > 0, "the CPU step's gradients are all zero")
    check(abs(l1 - l0) <= STEP_LOSS_RTOL * abs(l0), "the card's loss differs")


def phase_bench_step(torch, device, card, time_reps):
    W, H, spp, nb = BENCH["width"], BENCH["height"], BENCH["spp"], BENCH["bounces"]
    lanes = W * H * spp
    log(f"== phase 9: bench-shaped differentiable step, CornellBox {W}x{H}, "
        f"{spp} spp, {nb} bounces, {lanes} lanes, loss = mean(img)")
    from rust_pathtracer_tpu_torch.grad import CameraParams, DiffParams, apply_params
    from rust_pathtracer_tpu_torch.integrator import T_MIN, _precompute_draws
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
    from rust_pathtracer_tpu_torch.ops import fused_bounce_bwd as fbb
    from rust_pathtracer_tpu_torch.render import (
        RenderSettings, _make_lanes, render_radiance,
    )
    from rust_pathtracer_tpu_torch.sampling import prng_key

    scene = get_scene("CornellBox").build(device=device)
    settings = RenderSettings(W, H, spp, nb, (0.0, 0.0, 0.0), spp_chunk=spp,
                              differentiable=True)
    params = DiffParams.from_scene(
        scene, CameraParams.create(*CORNELL_CAM, device=device), settings.background)
    key = prng_key(0, device=device)
    leaves = [x.detach().clone().requires_grad_(True) for x in params.leaves()]

    def forward():
        p = DiffParams.from_leaves(leaves)
        img, stats = render_radiance(apply_params(scene, p), p.camera.build(),
                                     settings, key, background=p.background,
                                     device=device)
        return img.mean(), stats

    def step():
        for x in leaves:
            x.grad = None
        loss, stats = forward()
        loss.backward()
        return loss, stats

    step()  # warm-up
    _sync(torch, device)
    torch.cuda.reset_peak_memory_stats()
    fb.launches = fb.residual_launches = fbb.launches = 0
    loss, stats = step()
    _sync(torch, device)
    counts = (fb.launches, fb.residual_launches, fbb.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    grads = [x.grad.detach().cpu().numpy() for x in leaves]
    segments = float(stats.segments)
    log(f"one step: loss {float(loss.detach()):.7f}, segments {segments:.0f} (mean depth "
        f"{segments / lanes:.4f}), launches K1 {counts[0]}, K1-res {counts[1]}, "
        f"K2 {counts[2]}, peak memory {peak_gb:.3f} GB")
    log("gradients: " + ", ".join(f"|{n}| {np.abs(g).sum():.6e}" for n, g in zip(
        ("tex_color", "background", "camera"), (grads[0], grads[1],
                                               np.concatenate([g.ravel() for g in grads[2:]])))))
    check(counts[1] == nb and counts[2] == nb and counts[0] == nb,
          f"a step launched K1 {counts[0]}, K1-res {counts[1]}, K2 {counts[2]} "
          f"times, want {nb} each")
    check(all(np.isfinite(g).all() for g in grads), "non-finite gradients")
    check(np.abs(grads[0]).sum() > 0, "tex_color's gradient is zero")

    def batch():
        t0 = time.perf_counter()
        for _ in range(STEP["reps"]):
            loss, _ = step()
        sum(float(x.grad.abs().sum()) for x in leaves)  # device -> host
        float(loss.detach())
        return (time.perf_counter() - t0) / STEP["reps"]

    times = sorted(batch() for _ in range(STEP["batches"]))
    while ((times[-1] - times[0]) / times[len(times) // 2] > STEP["spread_tol"]
           and len(times) < STEP["max_batches"]):
        times.append(batch())
        times.sort()
    med = times[len(times) // 2]
    spread = (times[-1] - times[0]) / med
    log(f"bench-shaped step on {card}: median {med * 1e3:.2f} ms over "
        f"{len(times)} batches of {STEP['reps']} (spread {spread:.3f}; batches "
        f"{[round(t * 1e3, 2) for t in times]} ms), segments/s {segments / med:.4e}")

    # the step's split, CUDA events, median of 3
    def events_ms(fn):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return a.elapsed_time(b), out

    cam = DiffParams.from_leaves(leaves).camera.build()
    pix = torch.arange(W * H, dtype=torch.int64, device=device)

    def lanes_fn():
        return _make_lanes(cam, key, pix, 0, width=W, height=H, spp_chunk=spp,
                           spp_total=spp)

    split = {"lanes": [], "draws": [], "forward": [], "backward": []}
    for _ in range(3):
        ms, lk = events_ms(lanes_fn)
        split["lanes"].append(ms)
        split["draws"].append(events_ms(lambda: _precompute_draws(lk[0], nb, nb + 1))[0])
        for x in leaves:
            x.grad = None
        ms, (loss, _) = events_ms(forward)
        split["forward"].append(ms)
        split["backward"].append(events_ms(loss.backward)[0])
    split = {k: statistics.median(v) for k, v in split.items()}
    scan = split["forward"] - split["lanes"] - split["draws"]
    log(f"step split on {card} (CUDA events, median of 3): forward "
        f"{split['forward']:.2f} ms = lanes {split['lanes']:.2f} + RNG draws "
        f"{split['draws']:.2f} + bounce loop with residuals and the rest "
        f"{scan:.2f}; backward {split['backward']:.2f} ms")

    # K1, K1 with residuals, K2 and the plain versions at the step's width:
    # the first bounce of the bench chunk
    with torch.no_grad():
        lk, o, d, _ = lanes_fn()
        dr = _precompute_draws(lk, 1, 2)
    ones = torch.ones(lanes, device=device)
    zeros = torch.zeros(lanes, device=device)
    # contiguous columns, so that the timed calls launch the kernel alone
    cols = dict(zip(fb._COL_KEYS, [x.contiguous() for x in (
        o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], ones, ones, ones,
        zeros, zeros, zeros, ones)]))
    uni = [x.contiguous() for x in (
        dr["sphere_u"][0, :, 0], dr["sphere_u"][0, :, 1], dr["ball_u"][0, :, 0],
        dr["ball_u"][0, :, 1], dr["ball_u"][0, :, 2], dr["coin"][0])]
    table = fb.pack_prims_shaded(scene)
    bg = torch.zeros(3, device=device)
    kw = dict(kinds=scene.kinds_static, mat_types=scene.mat_types,
              tex_types=scene.tex_types, t_min=T_MIN)
    fns = {
        "K1": lambda: fb.fused_bounce_cols(table, bg, 0, cols, *uni, **kw),
        "K1-res": lambda: fb.fused_bounce_cols(table, bg, 0, cols, *uni, **kw,
                                               want_residuals=True),
        "K1-res plain": lambda: fb.fused_bounce_cols_plain(
            table, bg, 0, cols, *uni, **kw, want_residuals=True),
    }
    _, res = fns["K1-res"]()
    cot = torch.tensor(np.random.default_rng(3).normal(size=(12, lanes)).astype(np.float32),
                       device=device)
    bwd_args = (res, (cols["d0"], cols["d1"], cols["d2"]), (ones, ones, ones),
                dict(zip(fbb._COT_KEYS, cot.unbind(0))), bg)
    bkw = dict(mat_types=scene.mat_types, n_prims=scene.num_prims)
    fns["K2"] = lambda: fbb.fused_bounce_bwd(*bwd_args, **bkw)
    fns["K2 plain"] = lambda: fbb.fused_bounce_bwd_plain(*bwd_args, **bkw)
    order = ("K1-res plain", "K1", "K1-res", "K2 plain", "K2",
             "K2", "K2 plain", "K1-res", "K1", "K1-res plain")
    ms = {}
    for name in order:
        ms.setdefault(name, []).append(_time_ms(torch, device, fns[name], time_reps))
    for name, v in ms.items():
        log(f"{name} at {lanes} lanes on {card}: {statistics.mean(v):.4f} ms per "
            f"launch (blocks {[round(x, 4) for x in v]})")
    return dict(k1res_launches=counts[1], k2_launches=counts[2],
                ms={k: statistics.mean(v) for k, v in ms.items()})


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
    res_err, cols_np, res_np = phase_residuals(torch, device, K1_LANES)
    k2_err = phase_bwd_vs_plain(torch, device, cols_np, res_np)
    phase_small_step(torch, device)
    step = phase_bench_step(torch, device, card, time_reps=20)

    k1_src = "rust_pathtracer_tpu_torch/ops/csrc/fused_bounce.cu"
    kernels = {"kernels": [{
        "name": "fused_bounce (K1)",
        "route": "cuda",
        "source": k1_src,
        "replaces": "rust_pathtracer_tpu/ops/fused_bounce.py:169",
        "launches": launches,
        "max_abs_err": max_abs,
        "ms": k_ms,
        "plain_ms": p_ms,
    }, {
        "name": "fused_bounce with residuals (K1-res)",
        "route": "cuda",
        "source": k1_src,
        "replaces": "rust_pathtracer_tpu/ops/fused_bounce.py:464",
        "launches": step["k1res_launches"],
        "max_abs_err": res_err,
        "ms": step["ms"]["K1-res"],
        "plain_ms": step["ms"]["K1-res plain"],
    }, {
        "name": "fused_bounce_bwd (K2)",
        "route": "cuda",
        "source": "rust_pathtracer_tpu_torch/ops/csrc/fused_bounce_bwd.cu",
        "replaces": "rust_pathtracer_tpu/ops/fused_bounce.py:618",
        "launches": step["k2_launches"],
        "max_abs_err": k2_err,
        "ms": step["ms"]["K2"],
        "plain_ms": step["ms"]["K2 plain"],
    }]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
