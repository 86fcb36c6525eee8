#!/usr/bin/env python3
"""The camera lanes' cost on the main paths of two or more checkouts, in turns on one GPU.

    python3 lanes_ab.py --tree parent=output/parent --tree change=.

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
* where the tree has the lanes kernel (``ops/csrc/lanes.cu``): its SASS
  (``cuobjdump -sass``), the instructions of ``camera_lanes_kernel`` by
  opcode, and ptxas's register line.

Each run keeps the serving image, the bench step's loss and gradients
and the two regen and the SphereField images; the script then holds
every run's arrays to the first run's, bit for bit (the same key on
every tree), and fails where one differs.  Prints the card's name and
power limit, one JSON line a run, the comparison, and writes the runs
to ``output/lanes_ab/runs.json``.  Exits non-zero without a GPU or when
a check fails.
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
KERNEL = "camera_lanes_kernel"
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


def sass_ops(sass: str):
    """The instructions of ``camera_lanes_kernel``'s SASS: (count, {opcode: count})."""
    text = sass.split(KERNEL, 1)[-1].split("Function :", 1)[0]
    ops = {}
    for _, op, _ in SASS_LINE.findall(text):
        ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
    return sum(ops.values()), dict(sorted(ops.items(), key=lambda kv: -kv[1]))


def one(label, tree):
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
    if "lanes" in names:
        so = _build.build("lanes")
        run["ptxas"] = [ln.strip() for ln in _build.build_info["lanes"]["log"].splitlines()
                        if "registers" in ln or "spill" in ln]
        cuobjdump = str(Path(_build.nvcc_path()).parent / "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                              check=True).stdout
        os.makedirs(OUT, exist_ok=True)
        Path(OUT, f"{label}.sass").write_text(sass)
        run["sass_instructions"], run["sass_ops"] = sass_ops(sass)
    keep = {}

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
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        label, tree = args.one.split("=", 1)
        one(label, tree)
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
               "--one", f"{label}={tree}"]
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
    if not ok:
        print("FAIL: an image, loss or gradient differs between the trees", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
