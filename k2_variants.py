#!/usr/bin/env python3
"""K2's design choices, timed on one GPU: its grid and its reduction.

    python3 k2_variants.py [--parent DIR]

K2 (``ops/csrc/fused_bounce_bwd.cu``) reduces per warp and sizes its grid
from the card: WAVES times the blocks the card holds at once (MIN_BLOCKS
an SM by its launch bounds), and a __shfl_xor_sync tree where a whole
warp holds one key.  This script
copies ``rust_pathtracer_tpu_torch`` under ``output/k2_variants/`` once
a variant, with the source rewritten:

* ``waves1``, ``waves2``, ``waves4``: WAVES = 1, 2, 4;
* ``tile_a_block``: one block a tile of 256 lanes (4,096 at 1M lanes);
* ``no_tree``: WAVES as committed, the leader loop for every warp;
* ``min_blocks1``: MIN_BLOCKS = 1 (the compiler's own register count:
  74 a thread, 3 blocks an SM);

and, with ``--parent``, a checkout of another commit as it is (e.g. one
unpacked with ``git archive`` under ``output/``).  Each runs in its own
process, in the order given and then back (A B ... B A), on bench.py's
step shape (CornellBox 512x512, 4 spp: 1,048,576 lanes) at the first
bounce and at the sixth (a later bounce's keys are less coherent): K2
against its plain version on the same CUDA tensors (cotangent columns
bit for bit, the reductions within chip_smoke.py's K2 tolerance, two
runs bit-equal), its blocks, its time by CUDA events (two blocks of 20
launches) and its two kernels' device time (``torch.profiler``).  Prints
one JSON line a run and writes them to ``output/k2_variants/runs.json``.
Exits non-zero without a GPU or when a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "output", "k2_variants")
PKG = "rust_pathtracer_tpu_torch"
SRC = os.path.join("ops", "csrc", "fused_bounce_bwd.cu")
VARIANTS = {"waves1": dict(waves=1), "waves2": dict(waves=2), "waves4": dict(waves=4),
            "tile_a_block": dict(waves=1 << 20), "no_tree": dict(tree=False),
            "min_blocks1": dict(min_blocks=1)}
LATER_BOUNCE = 5


def make_variant(name, waves=None, tree=True, min_blocks=None):
    """A copy of the package with K2's source rewritten; returns its root."""
    root = os.path.join(OUT, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, PKG), os.path.join(root, PKG),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    path = os.path.join(root, PKG, SRC)
    with open(path) as f:
        src = f.read()
    n = 1
    if waves is not None:
        src, n = re.subn(r"constexpr int WAVES = \d+;", f"constexpr int WAVES = {waves};",
                         src)
    m = 1
    if not tree:
        src, m = re.subn(r"if \(peers == FULL\) \{", "if (false) {", src)
    if min_blocks is not None:
        src, m = re.subn(r"constexpr int MIN_BLOCKS = \d+;",
                         f"constexpr int MIN_BLOCKS = {min_blocks};", src)
    if n != 1 or m != 1:
        raise SystemExit(f"k2_variants: the source no longer has what {name} rewrites")
    with open(path, "w") as f:
        f.write(src)
    return root


def worker(root, label):
    """Times K2 of the package under ``root``; prints one JSON line."""
    import importlib.util

    sys.path.insert(0, root)
    import numpy as np
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from rust_pathtracer_tpu_torch.grad import CameraParams
    from rust_pathtracer_tpu_torch.integrator import T_MIN
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
    from rust_pathtracer_tpu_torch.ops import fused_bounce_bwd as fbb
    from rust_pathtracer_tpu_torch.render import _make_lanes
    from rust_pathtracer_tpu_torch.sampling import prng_key

    assert fbb.__file__.startswith(root), fbb.__file__
    dev = "cuda"
    W, H, spp = cs.BENCH["width"], cs.BENCH["height"], cs.BENCH["spp"]
    scene = get_scene("CornellBox").build(device=dev)
    cam = CameraParams.create(*cs.CORNELL_CAM, device=dev).build()
    with torch.no_grad():
        lk, o, d, _ = _make_lanes(cam, prng_key(0, device=dev),
                                  torch.arange(W * H, device=dev), 0, width=W, height=H,
                                  spp_chunk=spp, spp_total=spp)
    state, keys = cs.first_bounce_state(torch, o, d, lk)
    table = fb.pack_prims_shaded(scene)
    bg = torch.zeros(3, device=dev)
    kw = dict(with_roulette=False, kinds=scene.kinds_static, mat_types=scene.mat_types,
              tex_types=scene.tex_types, t_min=T_MIN)
    bkw = dict(mat_types=scene.mat_types, n_prims=scene.num_prims)
    lanes = state.shape[1]
    cot = torch.tensor(np.random.default_rng(3).normal(size=(12, lanes)).astype(np.float32),
                       device=dev)
    cots = dict(zip(fbb._COT_KEYS, cot.unbind(0)))
    out = {"label": label, "root": os.path.relpath(root, REPO), "lanes": lanes}
    for b in range(LATER_BOUNCE + 1):
        if b in (0, LATER_BOUNCE):
            _, res = fb.fused_bounce_keyed(table, bg, 0, state, keys, b, **kw,
                                           want_residuals=True)
            args = (res, tuple(state[3:6]), tuple(state[6:9]), cots, bg)
            g, tex, bgr = fbb.fused_bounce_bwd(*args, **bkw)
            _, tex2, bgr2 = fbb.fused_bounce_bwd(*args, **bkw)
            pg, ptex, pbg = fbb.fused_bounce_bwd_plain(*args, **bkw)
            torch.cuda.synchronize()
            cols_equal = all(torch.equal(g[k], pg[k]) for k in fbb._GRAD_KEYS)
            red = torch.cat([tex.reshape(-1), bgr]).double()
            want = torch.cat([ptex.reshape(-1), pbg]).double()
            tol = cs.K2_RTOL * want.abs() + cs.K2_ATOL_REL * want.abs().max()
            err = float((red - want).abs().max())
            fn = lambda: fbb.fused_bounce_bwd(*args, **bkw)  # noqa: E731
            ms = [cs._time_ms(torch, dev, fn, 20) for _ in range(2)]
            dev_ms, held = cs._device_ms(torch, fn, 20, cs.K2_KERNELS)
            hit = (res["flags"] & fb.FLG_HIT) != 0
            out[f"bounce{b + 1}"] = dict(
                ms=ms, device_ms=dev_ms, device_launches=held, hit_lanes=int(hit.sum()),
                cols_equal=cols_equal, red_max_abs_err=err,
                red_ok=bool(((red - want).abs() <= tol).all()),
                runs_equal=bool(torch.equal(tex, tex2) and torch.equal(bgr, bgr2)))
        state = fb.fused_bounce_keyed(table, bg, 0, state, keys, b, **kw)
    from rust_pathtracer_tpu_torch.ops._build import load_library

    blocks = load_library("fused_bounce_bwd").fused_bounce_bwd_blocks
    out["blocks"] = blocks(*(lanes, scene.num_prims)[:len(blocks.argtypes)])
    print(json.dumps(out), flush=True)
    ok = all(out[k]["cols_equal"] and out[k]["red_ok"] and out[k]["runs_equal"]
             for k in ("bounce1", f"bounce{LATER_BOUNCE + 1}"))
    return 0 if ok else 1


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--parent", help="another checkout's root, timed as it is")
    p.add_argument("--worker", nargs=2, metavar=("ROOT", "LABEL"), help=argparse.SUPPRESS)
    a = p.parse_args()
    if a.worker:
        return worker(*a.worker)
    import torch

    if not torch.cuda.is_available():
        print("FAIL: no CUDA device", flush=True)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    roots = {name: make_variant(name, **kw) for name, kw in VARIANTS.items()}
    if a.parent:
        roots = {"parent": os.path.abspath(a.parent), **roots}
    order = list(roots) + list(reversed(roots))
    runs, rc = [], 0
    for label in order:
        proc = subprocess.run([sys.executable, __file__, "--worker", roots[label], label],
                              capture_output=True, text=True)
        lines = [x for x in proc.stdout.splitlines() if x.startswith("{")]
        if proc.returncode or not lines:
            print(f"FAIL: {label} (rc {proc.returncode})\n{proc.stdout[-3000:]}"
                  f"{proc.stderr[-3000:]}", flush=True)
            rc = 1
            continue
        print(lines[-1], flush=True)
        runs.append(json.loads(lines[-1]))
    with open(os.path.join(OUT, "runs.json"), "w") as f:
        json.dump(runs, f, indent=1)
    return rc


if __name__ == "__main__":
    sys.exit(main())
