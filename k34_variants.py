#!/usr/bin/env python3
"""K3's and K4's design choices, timed on one GPU: grid, staging, wrapper.

    python3 k34_variants.py [--tree LABEL=DIR ...]

K3 and K4 (``ops/csrc/closest_hit.cu``) load each lane's rays and store
its outputs from the thread, and walk 256-lane tiles in a grid of
BLOCKS_PER_SM blocks on each SM.  This script copies
``rust_pathtracer_tpu_torch`` under ``output/k34_variants/`` once a
variant, with the source rewritten:

* ``committed``: the source as it is (16 blocks an SM);
* ``sm6``, ``sm8``, ``sm32``: 6, 8, 32 blocks an SM (the card holds 6 of
  K4's blocks an SM at once and 5 of K3's, so 6 is about one resident
  wave that loops over tiles);
* ``tile_a_block``: one block a tile of 256 lanes (no grid stride);

and, with ``--tree LABEL=DIR`` (repeatable), other checkouts as they are
(e.g. a parent commit unpacked with ``git archive`` under ``output/``).
Each runs in its own process, in the order given and then back (A B ...
B A), on three lane sets: chip_smoke.py's 1,000,000 random lanes of the
every-kind scene (7 primitives), the image scene's first bounce (phase
11: 819,840 lanes, 3 primitives, K3's path) and TwoSphereCheckers' first
bounce (phase 12: 819,840 lanes, 2 primitives, K4's path).  On each, K3
and K4 are held against their plain versions on the same CUDA tensors
(``chip_smoke.compare_hits``) and timed: CUDA events around the wrapper
(two blocks of 20 launches), the kernel's device time
(``torch.profiler``, 20 launches) and the wrapper's host time a call
(the host clock over 200 calls that are not waited for, the least of
three runs).  Prints one JSON line a run and writes them to
``output/k34_variants/runs.json``.  Exits non-zero without a GPU or when
a check fails.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
OUT = os.path.join(REPO, "output", "k34_variants")
PKG = "rust_pathtracer_tpu_torch"
SRC = os.path.join("ops", "csrc", "closest_hit.cu")
VARIANTS = {"committed": {}, "sm6": dict(blocks_per_sm=6), "sm8": dict(blocks_per_sm=8),
            "sm32": dict(blocks_per_sm=32), "tile_a_block": dict(blocks_per_sm=1 << 20)}
REPS = 20
HOST_CALLS = 200


def make_variant(name, blocks_per_sm=None):
    """A copy of the package with K3/K4's source rewritten; returns its root."""
    root = os.path.join(OUT, name)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(os.path.join(REPO, PKG), os.path.join(root, PKG),
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    path = os.path.join(root, PKG, SRC)
    with open(path) as f:
        src = f.read()
    if blocks_per_sm is not None:
        src, n = re.subn(r"constexpr int BLOCKS_PER_SM = \d+;",
                         f"constexpr int BLOCKS_PER_SM = {blocks_per_sm};", src)
        if n != 1:
            raise SystemExit(f"k34_variants: the source no longer has what {name} "
                             "rewrites")
    with open(path, "w") as f:
        f.write(src)
    return root


def host_ms(torch, fn):
    """The host's ms a call of ``fn`` over HOST_CALLS calls that are not
    waited for, the least of three runs: the wrapper's work, where the
    device keeps up with it."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        best = min(best, (time.perf_counter() - t0) * 1e3 / HOST_CALLS)
        torch.cuda.synchronize()
    return best


def lane_sets(cs, torch, dev):
    """name -> (scene, o, d): the three lane sets the module note names."""
    from rust_pathtracer_tpu_torch.camera import make_camera
    from rust_pathtracer_tpu_torch.grad import CameraParams
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.sampling import prng_key

    cols, _ = cs.random_lanes(cs.K1_LANES)
    rand = (cs.full_scene(dev),
            torch.tensor(cols[0:3].T.copy(), device=dev),
            torch.tensor(cols[3:6].T.copy(), device=dev))
    image = (cs.simple_scene(dev),
             *cs._first_bounce(torch, dev, make_camera(*cs.SIMPLE_CAM, device=dev),
                               prng_key(cs.GENERIC["seed"], device=dev), cs.GENERIC))
    tsc_cam = CameraParams.create(*cs.TSC_CAM, device=dev).build()
    tsc = (get_scene("TwoSphereCheckers").build(device=dev),
           *cs._first_bounce(torch, dev, tsc_cam, prng_key(cs.MAIN["seed"], device=dev),
                             cs.MAIN))
    return {"random_1M_7prims": rand, "image_scene_bounce1": image,
            "TwoSphereCheckers_bounce1": tsc}


def worker(root, label):
    """Times K3 and K4 of the package under ``root``; prints one JSON line."""
    import importlib.util

    sys.path.insert(0, root)
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from rust_pathtracer_tpu_torch.integrator import T_MIN
    from rust_pathtracer_tpu_torch.ops import _build
    from rust_pathtracer_tpu_torch.ops import closest_hit as ch

    assert ch.__file__.startswith(root), ch.__file__
    dev = "cuda"
    _build.load_library("closest_hit")
    ptxas = [x.strip() for x in _build.build_info["closest_hit"]["log"].splitlines()
             if "registers" in x]
    out = {"label": label, "root": os.path.relpath(root, REPO), "ptxas": ptxas}
    for name, (scene, o, d) in lane_sets(cs, torch, dev).items():
        args = (ch.pack_prims(scene.prims), o, d)
        kw = dict(kinds=scene.kinds_static, t_min=T_MIN)
        kinds = scene.prims.kind.cpu().numpy()
        res = {"lanes": o.shape[0], "prims": scene.num_prims}
        for k, kernel, plain in (("K4", ch.closest_hit, ch.closest_hit_plain),
                                 ("K3", ch.closest_hit_record, ch.closest_hit_record_plain)):
            err = cs.compare_hits(f"{label} {name} {k}", kernel(*args, **kw),
                                  plain(*args, **kw), kinds)

            def fn(kernel=kernel):
                return kernel(*args, **kw)

            ms = [cs._time_ms(torch, dev, fn, REPS) for _ in range(2)]
            dev_ms, held = cs._device_ms(torch, fn, REPS, ("closest_hit_kernel",))
            res[k] = dict(ms=ms, device_ms=dev_ms, device_launches=held,
                          host_ms=host_ms(torch, fn), max_abs_err=err)
        out[name] = res
    print(json.dumps(out), flush=True)
    return 0


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--tree", action="append", default=[], metavar="LABEL=DIR",
                   help="another checkout's root, timed as it is (repeatable)")
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
    trees = dict(x.split("=", 1) for x in a.tree)
    roots = {label: os.path.abspath(d) for label, d in trees.items()}
    roots.update({name: make_variant(name, **kw) for name, kw in VARIANTS.items()})
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
