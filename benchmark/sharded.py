"""A cell over a (tiles, samples) grid of ranks, one process a rank.

``launch`` (the run's own process) starts one process a rank, each
``run.py`` with ``--rank``, joined over a file store under TMPDIR (NCCL on
the cards, gloo on the CPU), and waits for them all.  Rank 0 prints the
result line; ``launch`` passes it on.  ``rank_main`` is a rank: the grid
(``parallel.make_mesh``), the kernels, the scene, one warm-up frame, then
the window, every rank rendering the same frames through
``render_radiance_sharded``.  Whether a frame follows is rank 0's
decision, broadcast over a gloo group on the host, so no rank waits on a
collective that another skips.  After the window rank 0 checks the
frames it holds (every rank holds the whole image) while the others
wait; the peak is the fullest rank's, the busy time the ranks' mean,
and each rank's busy time outside NCCL's kernels goes to rank 0 for
``rank_skew.mesh``.  Every rank then looks for JAX in its own modules
and fails the run where it finds it.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import torch

from benchmark import harness, loops, profiling

RANK_TIMEOUT_S = 1200


def launch(cell, seed, seconds, trace, device, toy, t0_epoch) -> dict:
    tiles, samples = cell.traffic["mesh"]
    world = tiles * samples
    store = os.path.join(tempfile.gettempdir(), f"benchmark-store-{os.getpid()}")
    if os.path.exists(store):
        os.remove(store)
    run_py = os.path.join(os.path.dirname(os.path.abspath(__file__)), "run.py")
    procs = []
    try:
        for r in range(world):
            cmd = [sys.executable, run_py, "--workload", cell.name, "--seed", str(seed),
                   "--seconds", str(seconds), "--trace", str(int(trace)), "--rank", str(r),
                   "--world", str(world), "--store", store, "--t0", repr(t0_epoch),
                   "--device", str(torch.device(device).type)]
            if toy:
                cmd.append("--toy")
            env = dict(os.environ, LOCAL_RANK=str(r), RANK=str(r), WORLD_SIZE=str(world))
            procs.append(subprocess.Popen(cmd, env=env, text=True,
                                          stdout=subprocess.PIPE if r == 0 else None))
        deadline = time.time() + RANK_TIMEOUT_S
        codes = [None] * world
        while time.time() < deadline:  # until every rank ends, or one fails
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes) or any(c not in (None, 0) for c in codes):
                break
            time.sleep(0.2)
        out = procs[0].stdout.read() if codes[0] == 0 else ""
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        if os.path.exists(store):
            os.remove(store)
    if any(c != 0 for c in codes):
        raise RuntimeError(f"ranks ended with {codes} (None: still running, killed)")
    lines = [ln for ln in out.splitlines() if ln.strip()]
    return json.loads(lines[-1])


def rank_main(args) -> int:
    from rust_pathtracer_tpu_torch.parallel.mesh import distributed_init, make_mesh

    import torch.distributed as dist

    from benchmark.spec import Cell

    cell = Cell(args.workload)
    tiles, samples = cell.traffic["mesh"]
    backend = "nccl" if args.device == "cuda" else "gloo"
    dev = distributed_init(backend, init_method=f"file://{args.store}",
                           world_size=args.world, rank=args.rank, device=args.device)
    mesh = make_mesh(tiles, samples, device=dev)
    host = dist.new_group(backend="gloo")
    rank = mesh.rank
    if rank == 0:
        harness.log(f"grid of {args.world} ranks ready at {time.time() - args.t0:.3f} s")

    def decide(more: bool) -> bool:
        flag = torch.tensor([int(more)], dtype=torch.int32)
        dist.broadcast(flag, src=0, group=host)
        return bool(flag.item())

    loop = loops.FrameLoop(cell, args.seed, dev, args.toy, mesh=mesh)
    loop.warm()
    dist.barrier(group=host)
    if rank == 0:
        harness.log(f"warm-up frame done at {time.time() - args.t0:.3f} s")
    setup_s = time.time() - args.t0
    win, tr = harness.frame_window(loop, args.trace, args.seconds, args.toy, go_on=decide)
    stats = torch.tensor([float(harness.peak_bytes(dev)), tr.busy_s if tr else 0.0],
                         dtype=torch.float64)
    peak = stats[:1].clone()
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=host)
    busy = stats[1:].clone()
    dist.all_reduce(busy, group=host)
    own = torch.tensor([tr.busy_s_of(lambda n: not n.startswith(profiling.COLLECTIVES))
                        if tr else 0.0], dtype=torch.float64)
    rank_busy = [torch.zeros(1, dtype=torch.float64) for _ in range(args.world)]
    dist.all_gather(rank_busy, own, group=host)
    result = None
    if rank == 0:
        peak = int(peak.item())
        harness.log(f"window: {len(loop.answers)} frames in {win.seconds_to_last:.3f} s; "
                    f"peak {peak} B")
        result = harness.frame_result(loop, win, tr, setup_s, peak, args.world,
                                      rank_busy_s=[float(b.item()) for b in rank_busy])
        result = harness.check_frames(cell, args.seed, loop.answers, loop.pixels, dev,
                                      args.toy, result, args.world, peak, tr)
        if tr is not None:
            result["device"]["busy_s"] = float(busy.item()) / args.world
    dist.barrier(group=host)
    dist.destroy_process_group()
    found = harness.forbidden_modules()
    if found:
        print(f"error: modules loaded in rank {rank} once the window closed: {found}",
              file=sys.stderr)
        return 3
    if result is not None:
        print(json.dumps(harness.ordered(result)), flush=True)
    return 0
