#!/usr/bin/env python3
"""The pass-set key kernel of two or more checkouts, timed in turns on one GPU.

    python3 passset_ab.py --tree parent=output/parent --tree change=. [--frames]

Each ``--tree LABEL=DIR`` is a checkout (e.g. a parent commit unpacked
with ``git archive`` under ``output/``).  Each runs in a process of its
own that imports ``rust_pathtracer_tpu_torch`` from that tree and the
measurements from this checkout's ``chip_smoke.py``, in the order given
and then back (A B ... B A).  A run:

* builds the tree's ``ops/csrc/passset.cu`` with the tree's own flags,
  keeps ptxas's register and spill lines, and reads the kernel's SASS
  with ``cuobjdump -sass``: for each innermost loop (a backward branch
  with no other inside), its instructions by opcode and the lane and
  cluster tests it holds (its FMULs over the 6 a slab test takes, one a
  face and axis; ``--fmad=false`` keeps every product an FMUL), so the
  instructions a lane and cluster;
* runs ``chip_smoke.py``'s phase 42 (the kernel against its plain
  version on 1M lanes, a fifth dead, of the SphereField, 10k and 20k
  tables: bit for bit; events, device time, the bound and
  ``passset_perm``'s time);
* with ``--frames``, phase 43 (the SphereField, 10k, 20k and 8-spp
  SphereField frames with the reorder off, on, on, off: bit for bit,
  walls, the key kernel's and the search's device time a frame, the
  reorder's own device cost a reordered bounce).

Prints the card's name and power limit, then one JSON line a run, and
writes them to ``output/passset_ab/runs.json``.  Exits non-zero
without a GPU or when a check fails.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import re
import subprocess
import sys
from pathlib import Path

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "output", "passset_ab")  # git-ignored
KERNEL = "passset_keys_kernel"
# a SASS line of cuobjdump: /*0a40*/   @!P0 BRA 0x220 ;
SASS_LINE = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);")


def _load(name):
    """This checkout's ``name``.py as module ``name``, whatever the tree holds."""
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def sass_loops(sass: str):
    """The innermost loops of the kernel's SASS: [{start, end, instructions,
    ops: {opcode: count}, tests, per_test}], ``tests`` the FMULs over 6."""
    text = sass.split(KERNEL, 1)[-1]
    code = [(int(a, 16), op, rest) for a, op, rest in SASS_LINE.findall(text)]
    loops = []
    for addr, op, rest in code:
        m = re.search(r"0x([0-9a-f]+)", rest)
        if op.startswith("BRA") and m and int(m.group(1), 16) < addr:
            loops.append((int(m.group(1), 16), addr))
    inner = [(s, e) for s, e in loops
             if not any((s2, e2) != (s, e) and s <= s2 and e2 <= e for s2, e2 in loops)]
    out = []
    for s, e in sorted(set(inner)):
        ops = {}
        for addr, op, _ in code:
            if s <= addr <= e:
                ops[op.split(".")[0]] = ops.get(op.split(".")[0], 0) + 1
        n = sum(ops.values())
        tests = ops.get("FMUL", 0) / 6
        out.append(dict(start=hex(s), end=hex(e), instructions=n, tests=tests,
                        per_test=n / tests if tests else None,
                        ops=dict(sorted(ops.items(), key=lambda kv: -kv[1]))))
    return out, len(code)


def one(label, tree, frames):
    tree = os.path.abspath(tree)
    sys.path.insert(0, tree)
    smoke = _load("chip_smoke")
    _load("profile_port")
    import torch

    from rust_pathtracer_tpu_torch.ops import _build

    if not _build.__file__.startswith(tree):
        raise SystemExit(f"FAIL: imported {_build.__file__}, not the package under {tree}")
    card = smoke.phase_device(torch)
    so = _build.build("passset")
    info = _build.build_info["passset"]
    ptxas = [ln.strip() for ln in info["log"].splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    cuobjdump = str(Path(_build.nvcc_path()).parent / "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", str(so)], capture_output=True, text=True,
                          check=True).stdout
    loops, total = sass_loops(sass)
    os.makedirs(OUT, exist_ok=True)
    Path(OUT, f"{label}.sass").write_text(sass)
    smoke.phase_build()
    scenes = smoke.big_scenes("cuda")
    keys = smoke.phase_passset_kernel(torch, "cuda", card, scenes, reps=20)
    run = dict(label=label, tree=tree, card=card, flags=" ".join(_build.NVCC_FLAGS),
               ptxas=ptxas, sass_instructions=total, sass_inner_loops=loops,
               phase42={n: {**v, "device_ms": v["device_ms"][0]} for n, v in keys.items()})
    if frames:
        f43 = smoke.phase_reorder_frames(torch, "cuda", card, scenes)
        run["phase43"] = {n: {k: v for k, v in f.items() if k not in ("img", "stats")}
                          for n, f in f43.items()}
    print("RUN " + json.dumps(run), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True, metavar="LABEL=DIR")
    ap.add_argument("--frames", action="store_true", help="phase 43 as well")
    ap.add_argument("--one", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.one:
        label, tree = args.one.split("=", 1)
        one(label, tree, args.frames)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no GPU (torch.cuda.is_available() is False)", flush=True)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)
    trees = [t.split("=", 1) for t in args.tree]
    runs = []
    for label, tree in trees + trees[::-1]:
        cmd = [sys.executable, os.path.abspath(__file__), "--tree", f"{label}={tree}",
               "--one", f"{label}={tree}"] + (["--frames"] if args.frames else [])
        proc = subprocess.run(cmd, capture_output=True, text=True, cwd=REPO)
        lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("RUN ")]
        log = os.path.join(OUT, f"{label}_{len(runs)}.log")
        os.makedirs(OUT, exist_ok=True)
        Path(log).write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0 or not lines:
            print(f"FAIL: {label} ({tree}) exited {proc.returncode}; see {log}\n"
                  f"{proc.stdout[-3000:]}{proc.stderr[-3000:]}", flush=True)
            return 1
        runs.append(json.loads(lines[-1][4:]))
        print(lines[-1][4:], flush=True)
    Path(OUT, "runs.json").write_text(json.dumps(runs, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
