#!/usr/bin/env python3
"""Walls of a process's sharded renders across cards, beside one card's.

    python3 sharded_timing.py --build     # the kernels and the BVH builder, once
    python3 -m torch.distributed.run --nproc-per-node 4 sharded_timing.py --mesh 4x1
    python3 -m torch.distributed.run --nproc-per-node 4 sharded_timing.py --mesh 2x2
    python3 -m torch.distributed.run --nproc-per-node 4 sharded_timing.py --mesh 2x2 \\
        --device cpu --tiny          # a rehearsal on the CPU over gloo

Runs ``rust_pathtracer_tpu_torch`` (never JAX).  Every rank joins the
process group (``--backend``: NCCL by default on the card, a card a
rank; gloo on the CPU), builds the (tiles, samples) grid (``make_mesh``
runs one collective on each of its groups, which sets up NCCL's
communicators) and loads the kernels (``--build`` builds them first, in
one process, one compiler a source: the ranks only load them).  Then, for each case, every rank renders it
``--reps`` times through ``render_radiance_sharded`` and rank 0 prints
each render's wall: its clock from a barrier to a barrier after the
image reached the host, so the first render's wall holds whatever a
process sets up on its first render and the later ones do not.  Rank 0
then renders the same key ``--reps`` times alone on its card
(``render_radiance``, the single process; the other ranks wait at a
barrier).  The sharded image must equal the single one bit for bit
where the samples axis is 1, else within atol 2e-6 plus spp ulps of the
pixel (``chip_smoke.shard_bound``); a failed check exits non-zero.

The cases: serving CornellBox (400x400, 60 spp in chunks of 6, 20
bounces: the fused route, K1) and the SphereField frame (854x480, 8 spp
in chunks of 2, 20 bounces, cascade "3:2,5:4,7:16": K6 and the draw
kernel), chip_smoke.py's phases 31 and 33.  ``--tiny`` cuts both to
32x24 and 4 spp.  Rank 0 prints the card's name and power limit.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# name -> (scene, width, height, spp, bounces, spp a chunk, cascade schedule)
CASES = {"serving": ("CornellBox", 400, 400, 60, 20, 6, None),
         "frame": ("SphereField", 854, 480, 8, 20, 2, "3:2,5:4,7:16")}
SHARD_ATOL = 2e-6
KERNELS = ("fused_bounce", "fused_bounce_bwd", "closest_hit", "projected", "draws")


def card(torch):
    """The card's name and power limit as nvidia-smi gives them."""
    if not torch.cuda.is_available():
        return "cpu"
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i",
             str(torch.cuda.current_device())], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name()


def timed(torch, barrier, fn):
    """(rank 0's wall s, result) of ``fn``, opened by a barrier and
    closed by the image on the host and a barrier."""
    barrier()
    t0 = time.perf_counter()
    img, stats = fn()
    img = img.cpu()
    barrier()
    return time.perf_counter() - t0, (img, stats)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--build", action="store_true",
                   help="build the kernel libraries and the BVH builder, then exit")
    p.add_argument("--mesh", metavar="TILESxSAMPLES")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="default: nccl on cuda, gloo on cpu")
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--tiny", action="store_true", help="32x24, 4 spp: a rehearsal")
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    import torch

    from rust_pathtracer_tpu_torch.cli import parse_mesh
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.parallel import (
        distributed_init,
        make_mesh,
        render_radiance_sharded,
    )
    from rust_pathtracer_tpu_torch.render import render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if args.build:
        from concurrent.futures import ThreadPoolExecutor

        from rust_pathtracer_tpu_torch import native
        from rust_pathtracer_tpu_torch.ops._build import load_library

        with ThreadPoolExecutor(max_workers=len(KERNELS) + 1) as pool:
            futs = [pool.submit(native.build)] + [pool.submit(load_library, n)
                                                  for n in KERNELS]
            for fut in futs:
                fut.result()
        return 0
    if args.mesh is None:
        p.error("--mesh is required (or --build)")
    tiles, samples = parse_mesh(args.mesh)
    if int(os.environ.get("WORLD_SIZE", 1)) != tiles * samples:
        print(f"error: --mesh {args.mesh} needs {tiles * samples} ranks",
              file=sys.stderr)
        return 2
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    t0 = time.perf_counter()
    dev = distributed_init(backend, device=args.device)
    mesh = make_mesh(tiles, samples, device=dev)
    set_up = time.perf_counter() - t0
    rank = mesh.rank
    if dev.type == "cuda":
        from rust_pathtracer_tpu_torch.ops._build import load_library

        for name in KERNELS:
            load_library(name)

    def barrier():
        if dev.type == "cuda":
            torch.cuda.synchronize()
        mesh.barrier()

    if rank == 0:
        print(f"card: {card(torch)}; mesh {tiles}x{samples} over {backend}, "
              f"{torch.cuda.device_count() if dev.type == 'cuda' else 0} card(s); "
              f"process group and grid set up in {set_up:.3f} s", flush=True)
    failed = False
    for name, (scene_name, w, h, spp, bounces, chunk, sched) in CASES.items():
        if args.tiny:
            w, h, spp = 32, 24, 4
        sd = get_scene(scene_name)
        settings = dataclasses.replace(
            sd.output.image, width=w, height=h, samples_per_pixel=spp,
            max_bounces=bounces, spp_chunk=chunk, cascade=sched is not None,
            cascade_schedule=sched)
        scene, cam = sd.build(device=dev), sd.camera_at(0.0, device=dev)
        key = prng_key(args.seed, device=dev)
        walls = []
        for _ in range(args.reps):
            wall, (img, stats) = timed(torch, barrier, lambda: render_radiance_sharded(
                scene, cam, settings, key, mesh))
            walls.append(wall)
        singles = []
        if rank == 0:
            for _ in range(args.reps):
                wall, (ref, ref_stats) = timed(torch, lambda: (
                    torch.cuda.synchronize() if dev.type == "cuda" else None),
                    lambda: render_radiance(scene, cam, settings, key, device=args.device))
                singles.append(wall)
        mesh.barrier()
        if rank != 0:
            continue
        diff = (img - ref).abs()
        err = float(diff.max())
        if samples == 1:
            ok = torch.equal(img, ref)
            tol = "bit for bit"
        else:
            rtol = spp * 2.0 ** -24
            ok = bool((diff <= SHARD_ATOL + rtol * ref.abs()).all())
            tol = f"within {SHARD_ATOL:g} + {rtol:.3g} of the pixel"
        failed |= not ok
        print(f"{name} ({scene_name} {w}x{h}, {spp} spp, {bounces} bounces"
              f"{'' if sched is None else ', cascade ' + sched}) on {card(torch)}: "
              f"mesh {tiles}x{samples} walls {walls} s "
              f"(first, then later renders of the process); single process "
              f"{singles} s; segments {float(stats.segments):.0f} "
              f"vs {float(ref_stats.segments):.0f}; max abs err {err:.3e} "
              f"({tol}: {'ok' if ok else 'FAILED'})", flush=True)
    mesh.barrier()
    torch.distributed.destroy_process_group()
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
