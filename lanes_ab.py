#!/usr/bin/env python3
"""The camera lanes' and K1's cost on the main paths of two or more checkouts, in turns on one GPU.

    python3 lanes_ab.py --tree parent=output/parent --tree change=. \
        [--kernel fused_bounce_kernel] [--k1-only]

Each ``--tree LABEL=DIR`` is a checkout (e.g. a parent commit unpacked
with ``git archive`` under ``output/``).  Each runs in a process of its
own that imports ``rust_pathtracer_tpu_torch`` from that tree and the
measurements from this checkout's ``chip_smoke.py``, in the order given
and then back (A B ... B A).  A run builds the tree's kernels, then:

* serving CornellBox (400x400, 60 spp in chunks of 6, 20 bounces): the
  wall of a render closed by a device sync, median of 3 after a warm-up,
  the device's idle share, and the lanes of one chunk by CUDA events;
* the bench step (CornellBox 512x512, 4 spp, 20 bounces, loss =
  mean(img), backward): the median step over batches as bench.py takes
  it, and its split into lanes, bounce loop and backward;
* LightTest regen (854x480, 16 spp, 50 bounces) and SphereField regen
  (854x480, 8 spp, 20 bounces): the wall (median of 3) and the split
  into bounces, spawns and window ends;
* the SphereField frame (854x480, 2 spp, 20 bounces): the wall, median
  of 3;
* the launches of every kernel on each of those paths;
* K1 (the fused bounce, ``ops/csrc/fused_bounce.cu``) on its lane sets
  (``K1_SETS``): chip_smoke.py phase 19's 1M random lanes at per-lane
  depth, phase 38's under the packed scheme (K1, K1-res, per-lane), the
  serving chunk's and the bench step's first bounce (K1, K1-res), and the
  pool of a LightTest regen bounce: CUDA events over ``K1_REPS``
  launches, the profiler's device time, and, on the phase 19 set, the
  profiler's trace of an event window (the wrapper's host time a call,
  the kernels' own time, the device's gaps between them);
* the SASS of the kernel named by ``--kernel`` (``camera_lanes_kernel``
  of ``ops/csrc/lanes.cu`` by default, or ``fused_bounce_kernel``): by
  ``cuobjdump -sass`` the instructions of each instantiation by opcode,
  by ``cuobjdump -res-usage`` its registers, stack, shared and local
  memory, and ptxas's register and spill lines.

Each run keeps the serving image, the bench step's loss and gradients,
the two regen and the SphereField images and K1's outputs on every lane
set; the script then holds every run's arrays to the first run's, bit
for bit (the same key on every tree), and fails where one differs.
With ``--k1-only`` a run times K1 and reads the SASS and nothing else,
and the comparison is printed but not enforced: that mode times
throwaway variants of the kernel (copies of the package with one piece
of work taken out), whose bits differ by design.  Prints the card's
name and power limit, one JSON line a run, the comparison, and writes
the runs to ``output/lanes_ab/runs.json``.  Exits non-zero without a
GPU or when a check fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "output", "lanes_ab")  # git-ignored
# the kernels whose SASS a run can read, by the source that holds them
KERNEL_SOURCES = {"camera_lanes_kernel": "lanes", "fused_bounce_kernel": "fused_bounce"}
K1_REPS = 20
K1_KERNEL = "fused_bounce_kernel"
SF_FRAME = dict(width=854, height=480, spp=2, bounces=20, seed=0)
WALL_RUNS = 3
# a SASS line of cuobjdump: /*0a40*/   @!P0 BRA 0x220 ;
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _load(name):
    """This checkout's ``name``.py as module ``name``, whatever the tree holds."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


# a template instantiation's arguments in a mangled name: ILb0ELb1EE
TEMPLATE_ARGS = re.compile(r"I((?:Lb[01]E)+)E")


def instantiation(mangled: str) -> str:
    """A kernel's template arguments as a label (``<0,1>``), or ``""``."""
    m = TEMPLATE_ARGS.search(mangled)
    return "<" + ",".join(re.findall(r"Lb([01])E", m.group(1))) + ">" if m else ""


def sass_ops(sass: str, kernel: str):
    """The SASS of each function whose name holds ``kernel``:
    {instantiation: {"instructions": n, "ops": {opcode: count}}}."""
    out = {}
    for part in sass.split("Function : ")[1:]:
        name = part.split(None, 1)[0]
        if kernel not in name:
            continue
        ops = {}
        for _, op, _ in SASS_LINE.findall(part):
            ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
        out[instantiation(name)] = {
            "instructions": sum(ops.values()),
            "ops": dict(sorted(ops.items(), key=lambda kv: -kv[1]))}
    return out


def res_usage(text: str, kernel: str):
    """``cuobjdump -res-usage``'s line of each function whose name holds
    ``kernel``: {instantiation: "REG:.. STACK:.. SHARED:.. LOCAL:.. ..."}."""
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function (\S+):", line)
        if m:
            name = m.group(1)
            rest = line.split(":", 1)[1].strip()
            if rest and kernel in name:
                out[instantiation(name)] = rest
        elif name and kernel in name and "REG:" in line:
            out[instantiation(name)] = line.strip()
    return out


def read_sass(_build, kernel, label):
    """The SASS, resources and ptxas lines of ``kernel`` as the tree builds it
    (ptxas's only where this process built the library)."""
    src = KERNEL_SOURCES[kernel]
    log = _build.build_info.get(src, {}).get("log", "")
    so = _build.build(src)
    cuobjdump = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    usage = subprocess.run([cuobjdump, "-res-usage", str(so)], capture_output=True,
                           text=True, check=True).stdout
    os.makedirs(OUT, exist_ok=True)
    Path(OUT, f"{label}.sass").write_text(sass)
    Path(OUT, f"{label}.res-usage").write_text(usage)
    return dict(kernel=kernel, sass=sass_ops(sass, kernel), res_usage=res_usage(usage, kernel),
                ptxas=[ln.strip() for ln in log.splitlines()
                       if "registers" in ln or "spill" in ln or "stack" in ln])


def k1_sets(torch, smoke, dev):
    """K1's lane sets: {name: (args, kwargs)} of ``fused_bounce_keyed``
    calls at the shapes chip_smoke.py's phases and the paths give it."""
    from rust_pathtracer_tpu_torch.integrator import T_MIN
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
    from rust_pathtracer_tpu_torch.render import RenderSettings, _make_lanes
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.wavefront import render_radiance_regen

    sets = {}
    scene = smoke.full_scene(dev)
    kw0 = dict(kinds=scene.kinds_static, mat_types=scene.mat_types,
               tex_types=scene.tex_types, t_min=T_MIN)
    bg = torch.tensor((0.2, 0.1, 0.05), device=dev)
    table = fb.pack_prims_shaded(scene)
    for phase, seed in ((19, 20261016), (38, 38)):  # random_lanes' seeds there
        cols_np, keys_np = smoke.random_lanes(smoke.K1_LANES, seed=seed)
        state, keys = smoke._keyed_on(torch, cols_np, keys_np, dev)
        depth = torch.as_tensor(np.random.default_rng(phase).integers(
            0, smoke.REGEN_DEPTHS, smoke.K1_LANES).astype(np.int32), device=dev)
        base = (table, bg, scene.textures.perlin_seed, state, keys)
        lane = dict(kw0, with_roulette=True, rr_start=smoke.REGEN_RR_START)
        if phase == 19:
            sets["K1 per-lane, phase 19"] = (base + (depth,), lane)
            continue
        packed = dict(kw0, with_roulette=True, rng_scheme=smoke.PACKED)
        sets["K1 packed, phase 38"] = (base + (7,), packed)
        sets["K1-res packed, phase 38"] = (base + (7,), dict(packed, want_residuals=True))
        sets["K1 packed per-lane, phase 38"] = (base + (depth,),
                                                dict(lane, rng_scheme=smoke.PACKED))
    sd = get_scene("CornellBox")
    cb, cam = sd.build(device=dev), sd.camera_at(0.0, device=dev)
    for path, cfg, res in (("serving", smoke.SERVE, False), ("bench", smoke.BENCH, True)):
        W, H = cfg["width"], cfg["height"]
        chunk = cfg.get("spp_chunk", cfg["spp"])
        pix = torch.arange(W * H, dtype=torch.int64, device=dev)
        lk, o, d, _ = _make_lanes(cam, prng_key(cfg.get("seed", 0), device=dev), pix, 0,
                                  width=W, height=H, spp_chunk=chunk, spp_total=cfg["spp"])
        st, keys = smoke.first_bounce_state(torch, o, d, lk)
        cbg = torch.tensor(sd.output.image.background if path == "serving"
                           else (0.0, 0.0, 0.0), dtype=torch.float32, device=dev)
        sets[f"{'K1-res' if res else 'K1'} {path}, first bounce"] = (
            (fb.pack_prims_shaded(cb), cbg, cb.textures.perlin_seed, st, keys, 0),
            dict(kinds=cb.kinds_static, mat_types=cb.mat_types, tex_types=cb.tex_types,
                 t_min=T_MIN, with_roulette=False, want_residuals=res))
    rd, cfg = get_scene("LightTest"), smoke.REGEN
    rs = RenderSettings(cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"],
                        rd.output.image.background)
    with smoke.capture_calls(torch, "fused_bounce_keyed", {5}) as calls:
        render_radiance_regen(rd.build(device=dev), rd.camera_at(0.0, device=dev), rs,
                              prng_key(cfg["seed"], device=dev), device=dev)
    sets["K1 per-lane, LightTest regen pool"] = calls[5]
    return sets


def event_window(torch, fn, reps):
    """The profiler's trace (host and device) of an event window of
    ``reps`` calls: the events' ms a call, the wrapper's host ms a call
    (a ``record_function`` span around each), the kernels' own ms a
    launch, and the device's mean gap between one launch's end and the
    next one's start."""
    from torch.profiler import ProfilerActivity, profile, record_function

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        a.record()
        for _ in range(reps):
            with record_function("k1_call"):
                fn()
        b.record()
        b.synchronize()
    ev = prof.events()
    host = [e.time_range.end - e.time_range.start for e in ev if e.name == "k1_call"]
    kern = sorted((e.time_range.start, e.time_range.end) for e in ev
                  if e.device_type.name == "CUDA" and K1_KERNEL in e.name)
    gaps = [s1 - e0 for (_, e0), (s1, _) in zip(kern, kern[1:])]
    other = {}  # the device's other work in the window, by kernel or copy
    for e in ev:
        if e.device_type.name == "CUDA" and K1_KERNEL not in e.name:
            other[e.name] = other.get(e.name, 0.0) + (e.time_range.end - e.time_range.start)
    return dict(events_ms=a.elapsed_time(b) / reps,
                other_device_ms={k: v / 1e3 / reps for k, v in other.items()},
                host_ms=statistics.mean(host) / 1e3 if host else None,
                kernel_ms=statistics.mean(e - s for s, e in kern) / 1e3 if kern else None,
                gap_ms=statistics.mean(gaps) / 1e3 if gaps else None,
                kernels_in_trace=len(kern), calls=reps)


def time_k1(torch, smoke, dev, keep):
    """K1 on each of its lane sets: events and device ms a launch; its
    outputs (int32 views) go into ``keep``."""
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb

    out = {}
    for name, (args, kw) in k1_sets(torch, smoke, dev).items():
        def fn(args=args, kw=kw):
            return fb.fused_bounce_keyed(*args, **kw)

        win = torch.empty(args[3].shape[1], dtype=torch.int32, device=dev)
        res = fb.fused_bounce_keyed(*args, **kw, winner_out=win)
        st, planes = res if kw.get("want_residuals") else (res, {})
        tag = "k1_" + re.sub(r"\W+", "_", name)
        keep[f"{tag}_state"] = st.cpu().numpy().view(np.int32)
        keep[f"{tag}_winner"] = win.cpu().numpy()
        for k, v in planes.items():
            keep[f"{tag}_{k}"] = v.cpu().numpy().view(np.int32)
        ev = [smoke._time_ms(torch, dev, fn, K1_REPS) for _ in range(2)]
        dev_ms, held = smoke._device_ms(torch, fn, K1_REPS, (K1_KERNEL,))
        work = smoke.k1_work(torch, args, kw,
                             residual_planes=10 if kw.get("want_residuals") else 0)
        b_ms, b_by = smoke.bound(*work)
        out[name] = dict(lanes=int(args[3].shape[1]), events_ms=ev, device_ms=dev_ms,
                         device_launches_held=held, bound_ms=b_ms, bound_by=b_by,
                         ops_ms=smoke.bound(0, *work[1:])[0],
                         work=dict(zip(("bytes", "f32", "int32", "f64"), work)))
        if name.startswith("K1 per-lane, phase 19"):
            out[name]["event_window"] = event_window(torch, fn, K1_REPS)
    return out


def one(label, tree, kernel, k1_only):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    smoke = _load("chip_smoke")
    _load("profile_port")
    import torch

    from rust_pathtracer_tpu_torch.grad import CameraParams, DiffParams, apply_params
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops import _build
    from rust_pathtracer_tpu_torch.render import RenderSettings, _make_lanes, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.wavefront import render_radiance_regen

    if not _build.__file__.startswith(tree):
        raise SystemExit(f"FAIL: imported {_build.__file__}, not the package under {tree}")
    if not (_build.CSRC / "lanes.cu").exists():
        # a tree from before the lanes kernel: chip_smoke's counters read 0 for it
        sys.modules["rust_pathtracer_tpu_torch.ops.lanes"] = types.SimpleNamespace(launches=0)
    dev = "cuda"
    card = smoke.phase_device(torch)
    names = [n for n in smoke.KERNELS if (_build.CSRC / f"{n}.cu").exists()]
    t0 = time.perf_counter()
    for n in names:
        _build.load_library(n)
    run = dict(label=label, tree=tree, card=card, kernels=names,
               build_s=time.perf_counter() - t0)
    if KERNEL_SOURCES[kernel] in names:
        run["sass"] = read_sass(_build, kernel, label)
    keep = {}
    run["k1"] = time_k1(torch, smoke, dev, keep)
    if k1_only:
        os.makedirs(OUT, exist_ok=True)
        np.savez(os.path.join(OUT, f"{label}.npz"), **keep)
        print("RUN " + json.dumps(run), flush=True)
        return

    def wall(fn):
        """(median wall s of WALL_RUNS after a warm-up, launches of the last)."""
        fn()
        walls = []
        for _ in range(WALL_RUNS):
            secs, out, counts = smoke._timed_render(torch, dev, fn)
            walls.append(secs)
        return statistics.median(walls), walls, out, counts

    # serving CornellBox
    sd = get_scene("CornellBox")
    scene, cam = sd.build(device=dev), sd.camera_at(0.0, device=dev)
    cfg = smoke.SERVE
    key = prng_key(cfg["seed"], device=dev)
    s = RenderSettings(cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"],
                       sd.output.image.background, spp_chunk=cfg["spp_chunk"])
    med, walls, (img, _), counts = wall(
        lambda: render_radiance(scene, cam, s, key, device=dev))
    keep["serving"] = img.cpu().numpy()
    pix = torch.arange(cfg["width"] * cfg["height"], dtype=torch.int64, device=dev)
    lanes_ms = statistics.median(smoke._events_ms(torch, lambda: _make_lanes(
        cam, key, pix, 0, width=cfg["width"], height=cfg["height"],
        spp_chunk=cfg["spp_chunk"], spp_total=cfg["spp"]))[0] for _ in range(5))
    _, busy, idle = smoke.idle_share(torch, lambda: render_radiance(scene, cam, s, key,
                                                                    device=dev))
    run["serving"] = dict(wall_s=med, walls=walls, launches=counts,
                          lanes_ms_a_chunk=lanes_ms, busy_ms=busy, idle_share=idle)

    # the bench step
    cfg = smoke.BENCH
    bs = RenderSettings(cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"],
                        (0.0, 0.0, 0.0), spp_chunk=cfg["spp"], differentiable=True)
    params = DiffParams.from_scene(
        scene, CameraParams.create(*smoke.CORNELL_CAM, device=dev), bs.background)
    bkey = prng_key(0, device=dev)
    leaves = [x.detach().clone().requires_grad_(True) for x in params.leaves()]

    def forward():
        p = DiffParams.from_leaves(leaves)
        img, stats = render_radiance(apply_params(scene, p), p.camera.build(), bs, bkey,
                                     background=p.background, device=dev)
        return img.mean(), stats

    def step():
        smoke._zero_grads(leaves)
        loss, stats = forward()
        loss.backward()
        return loss, stats

    step()
    smoke._sync(torch, dev)
    smoke.reset_counts()
    loss, _ = step()
    smoke._sync(torch, dev)
    counts = smoke.read_counts()
    keep["bench_loss"] = loss.detach().cpu().numpy()
    for n, g in zip(smoke.LEAF_NAMES, smoke._leaf_grads(leaves)):
        keep[f"bench_grad_{n}"] = g
    med, spread, times = smoke._batch_median(step, leaves, smoke.STEP)
    bpix = torch.arange(cfg["width"] * cfg["height"], dtype=torch.int64, device=dev)
    bcam = DiffParams.from_leaves(leaves).camera.build()
    split = smoke._step_split(torch, leaves, forward, lambda: _make_lanes(
        bcam, bkey, bpix, 0, width=cfg["width"], height=cfg["height"],
        spp_chunk=cfg["spp"], spp_total=cfg["spp"]))
    run["bench_step"] = dict(median_ms=med * 1e3, spread=spread,
                             batches_ms=[t * 1e3 for t in times], split_ms=split,
                             launches=counts)

    # the two regen frames
    for name, cfg, bg in (("LightTest", smoke.REGEN, None),
                          ("SphereField", smoke.SF_REGEN, smoke.SF_BG)):
        rd = get_scene(name)
        rscene, rcam = rd.build(device=dev), rd.camera_at(0.0, device=dev)
        rs = RenderSettings(cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"],
                            bg or rd.output.image.background)
        rkey = prng_key(cfg["seed"], device=dev)

        def regen(rscene=rscene, rcam=rcam, rs=rs, rkey=rkey):
            return render_radiance_regen(rscene, rcam, rs, rkey, device=dev)

        med, walls, (img, _), counts = wall(regen)
        keep[f"{name}_regen"] = img.cpu().numpy()
        with smoke.regen_events(torch) as spans:
            regen()
        run[f"{name}_regen"] = dict(wall_s=med, walls=walls, launches=counts,
                                    split_ms=smoke.regen_split(torch, spans))

    # the SphereField frame
    cfg = SF_FRAME
    fd = get_scene("SphereField")
    fscene, fcam = fd.build(device=dev), fd.camera_at(0.0, device=dev)
    fs = RenderSettings(cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"], smoke.SF_BG)
    fkey = prng_key(cfg["seed"], device=dev)
    med, walls, (img, _), counts = wall(
        lambda: render_radiance(fscene, fcam, fs, fkey, device=dev))
    keep["SphereField_frame"] = img.cpu().numpy()
    run["SphereField_frame"] = dict(wall_s=med, walls=walls, launches=counts)

    os.makedirs(OUT, exist_ok=True)
    np.savez(os.path.join(OUT, f"{label}.npz"), **keep)
    print("RUN " + json.dumps(run), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True, metavar="LABEL=DIR")
    ap.add_argument("--kernel", default="camera_lanes_kernel", choices=sorted(KERNEL_SOURCES),
                    help="the kernel whose SASS and resources each run reads")
    ap.add_argument("--k1-only", action="store_true",
                    help="time K1 on its lane sets and read the SASS, nothing else; "
                         "report, not enforce, bit equality across trees")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        label, tree = args.one.split("=", 1)
        one(label, tree, args.kernel, args.k1_only)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no GPU (torch.cuda.is_available() is False)", flush=True)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    trees = [t.split("=", 1) for t in args.tree]
    runs, arrays = [], []
    os.makedirs(OUT, exist_ok=True)
    for label, tree in trees + trees[::-1]:
        cmd = [sys.executable, os.path.abspath(__file__), "--tree", f"{label}={tree}",
               "--kernel", args.kernel, "--one", f"{label}={tree}"]
        if args.k1_only:
            cmd.append("--k1-only")
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RUN ")]
        log = os.path.join(OUT, f"{label}_{len(runs)}.log")
        Path(log).write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0 or not lines:
            print(f"FAIL: {label} ({tree}) exited {proc.returncode}; see {log}\n"
                  f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}", flush=True)
            return 1
        runs.append(json.loads(lines[-1][4:]))
        with np.load(os.path.join(OUT, f"{label}.npz")) as z:
            arrays.append({k: z[k] for k in z.files})
        print(lines[-1][4:], flush=True)
    Path(OUT, "runs.json").write_text(json.dumps(runs, indent=1))
    first, ok = arrays[0], True
    for run, arr in zip(runs[1:], arrays[1:]):
        differ = sorted(k for k in first
                        if k not in arr or first[k].shape != arr[k].shape
                        or first[k].dtype != arr[k].dtype
                        or first[k].tobytes() != arr[k].tobytes())
        print(f"{run['label']} against {runs[0]['label']}: "
              + (f"differ in {differ}" if differ else
                 f"bit for bit in all {len(first)} arrays ({', '.join(sorted(first))})"),
              flush=True)
        ok &= not differ
    if not ok and not args.k1_only:
        print("FAIL: an image, loss, gradient or K1 output differs between the trees",
              flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
