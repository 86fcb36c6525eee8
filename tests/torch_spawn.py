"""Run a case of the port on a group of ``torch.distributed`` ranks.

The tests of the sharded renderer start each rank as a process of its
own (``python tests/torch_spawn.py CASE RANK WORLD INIT OUT ARGS``): the
ranks meet through a ``file://`` store in the test's temporary
directory (no ports, so parallel test workers cannot collide), join a
gloo group on the CPU (or on ``cuda:0``), run ``CASES[CASE]`` and write
what it returns to ``OUT/rank{RANK}.pt``.  ``run_ranks`` starts them,
joins them under its own time limit, kills them all on expiry, and
fails the test where any rank failed, with its output.  The module
imports neither jax nor the JAX package, so a rank starts in seconds.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(case: str, world: int, tmp_path, timeout: float = 120.0,
              device: str = "cpu", **kwargs):
    """Start ``world`` ranks of ``case`` and return their results, rank
    by rank.  A rank that fails, or the group not done within
    ``timeout`` seconds, fails the calling test (every rank killed)."""
    import torch

    out = _out_dir(tmp_path, case)
    init = "file://" + os.path.join(out, "store")
    args = json.dumps(dict(kwargs, device=device))
    run_processes(
        [[sys.executable, os.path.abspath(__file__), case, str(r), str(world), init, out,
          args] for r in range(world)], [{}] * world, out, timeout, case)
    return [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
            for r in range(world)]


def _out_dir(tmp_path, name):
    out = os.path.join(str(tmp_path), f"{name}-{time.monotonic_ns()}")
    os.makedirs(out)
    return out


def run_processes(argvs, envs, out, timeout: float, name: str):
    """Run one process an argv (its environment updated with the dict of
    ``envs`` beside it), output to ``out/rank{r}.log``; all must exit 0
    within ``timeout`` seconds.  Where one fails or time runs out, the
    others are killed (they would wait in a collective) and the calling
    test fails with their output.  Returns the logs."""
    import pytest

    procs = []
    for r, (argv, extra) in enumerate(zip(argvs, envs)):
        env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1", **extra)
        with open(os.path.join(out, f"rank{r}.log"), "w") as log:
            procs.append(subprocess.Popen(argv, stdout=log, stderr=subprocess.STDOUT,
                                          env=env, cwd=out))
    deadline = time.monotonic() + timeout
    while any(p.poll() is None for p in procs):
        failed = any(p.returncode not in (None, 0) for p in procs)
        if failed or time.monotonic() > deadline:
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()
            if not failed:
                pytest.fail(f"{name}: {len(procs)} processes not done within {timeout} "
                            "s\n" + _logs(out, range(len(procs))))
            break
        time.sleep(0.05)
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        pytest.fail(f"{name}: process(es) {bad} failed\n" + _logs(out, range(len(procs))))
    return [_log(out, r) for r in range(len(procs))]


def _log(out, r):
    with open(os.path.join(out, f"rank{r}.log")) as f:
        return f.read()


def _logs(out, ranks):
    return "\n".join(f"--- rank {r}\n{_log(out, r)[-4000:]}" for r in ranks)


# ---------------------------------------------------------------------------
# the cases, run on every rank; each returns a dict of plain values and
# CPU tensors
# ---------------------------------------------------------------------------


def _settings(cfg):
    from rust_pathtracer_tpu_torch.render import RenderSettings

    cfg = dict(cfg)
    cfg["background"] = tuple(cfg["background"])
    return RenderSettings(**cfg)


def _scene(name, device):
    from rust_pathtracer_tpu_torch.models import get_scene

    sd = get_scene(name)
    return sd.build(device=device), sd.camera_at(0.0, device=device)


def case_render(device, jobs):
    """Each job: {"mesh": [T, S], "scene", "settings", "key", optional
    "margin" (the auto cascade's first margin)}.  Every rank builds every
    job's mesh, in order.  Records the image, segments, bounces,
    occupancy, the warnings, or the CascadeOverflowError's message."""
    import torch

    from rust_pathtracer_tpu_torch.parallel import make_mesh, render_radiance_sharded
    from rust_pathtracer_tpu_torch.parallel import shard
    from rust_pathtracer_tpu_torch.render import AUTO_MARGIN, CascadeOverflowError
    from rust_pathtracer_tpu_torch.sampling import prng_key

    out = []
    for job in jobs:
        mesh = make_mesh(*job["mesh"], device=device)
        scene, cam = _scene(job["scene"], device)
        shard.AUTO_MARGIN = job.get("margin", AUTO_MARGIN)
        rec = {"coord": mesh.coord}
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                img, st = render_radiance_sharded(scene, cam, _settings(job["settings"]),
                                                  prng_key(job["key"], device=device), mesh)
                rec.update(img=img.cpu(), segments=float(st.segments), bounces=st.bounces,
                           occupancy=st.occupancy.cpu())
            except CascadeOverflowError as e:
                rec["raised"] = str(e)
        rec["warnings"] = [str(w.message) for w in caught]
        out.append(rec)
    return {"jobs": out}


def case_grad(device, jobs, dryrun=None):
    """Each job: {"mesh", "scene", "settings", "key", "camera" (the seven
    CameraParams values)}: ``render_loss_and_grad_sharded`` against a
    zero target.  Records the loss and every DiffParams leaf's
    gradient; then, given a mesh ``dryrun``, ``dryrun_multichip`` on it."""
    from rust_pathtracer_tpu_torch.grad import CameraParams, DiffParams
    from rust_pathtracer_tpu_torch.parallel import make_mesh, render_loss_and_grad_sharded
    from rust_pathtracer_tpu_torch.sampling import prng_key

    import torch

    out = []
    for job in jobs:
        mesh = make_mesh(*job["mesh"], device=device)
        scene, _ = _scene(job["scene"], device)
        s = _settings(job["settings"])
        params = DiffParams.from_scene(scene, CameraParams.create(*job["camera"],
                                                                  device=device),
                                       s.background)
        loss, g = render_loss_and_grad_sharded(
            params, scene, s, prng_key(job["key"], device=device),
            torch.zeros((s.height, s.width, 3)), mesh)
        out.append({"loss": float(loss), "grads": [x.cpu() for x in g.leaves()]})
    result = {"jobs": out}
    if dryrun is not None:
        from rust_pathtracer_tpu_torch.parallel.dryrun import dryrun_multichip

        result["dryrun"] = dryrun_multichip(*dryrun, device=device)
    return result


def case_checkpoint(device, jobs):
    """Each job: {"mesh", "scene", "settings", "key", "path", "every",
    optional "stop_at", optional "flushes"}: ``render_radiance_sharded_checkpointed``;
    with ``stop_at``, every rank raises as it starts that chunk (a fault in
    every rank at the same chunk), and the job records "stopped"; with
    ``flushes``, ``render_radiance_sharded`` of the same render follows
    at each of those ``FLUSH_CHUNKS``, its images and segments recorded
    under "renders"."""
    from rust_pathtracer_tpu_torch.parallel import make_mesh, render_radiance_sharded
    from rust_pathtracer_tpu_torch.parallel import shard
    from rust_pathtracer_tpu_torch.parallel.shard import ShardedChunkPlan
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.checkpoint import (
        render_radiance_sharded_checkpointed,
    )

    run_chunk = ShardedChunkPlan.run_chunk
    out = []
    for job in jobs:
        mesh = make_mesh(*job["mesh"], device=device)
        scene, cam = _scene(job["scene"], device)
        ran = []

        def chunk(plan, c, _stop=job.get("stop_at")):
            if c == _stop:
                raise KeyboardInterrupt(f"stopped at chunk {c}")
            ran.append(c)
            return run_chunk(plan, c)

        ShardedChunkPlan.run_chunk = chunk
        try:
            img, st = render_radiance_sharded_checkpointed(
                scene, cam, _settings(job["settings"]), prng_key(job["key"], device=device),
                mesh, job["path"], checkpoint_every=job.get("every", 1))
            out.append({"img": img.cpu(), "segments": float(st.segments), "ran": ran})
        except KeyboardInterrupt:
            out.append({"stopped": True, "ran": ran})
        finally:
            ShardedChunkPlan.run_chunk = run_chunk
        renders, flush = [], shard.FLUSH_CHUNKS
        for n in job.get("flushes", ()):
            shard.FLUSH_CHUNKS = n
            try:
                img, st = render_radiance_sharded(
                    scene, cam, _settings(job["settings"]),
                    prng_key(job["key"], device=device), mesh)
            finally:
                shard.FLUSH_CHUNKS = flush
            renders.append({"img": img.cpu(), "segments": float(st.segments)})
        if renders:
            out[-1]["renders"] = renders
    return {"jobs": out}


CASES = {"render": case_render, "grad": case_grad, "checkpoint": case_checkpoint}


def main(argv):
    case, rank, world, init, out, args = argv[1:7]
    rank, world, args = int(rank), int(world), json.loads(args)
    sys.path.insert(0, REPO)
    import torch

    torch.set_num_threads(1)
    from rust_pathtracer_tpu_torch.parallel import distributed_init

    device = distributed_init("gloo", init, world, rank, device=args.pop("device"))
    try:
        result = CASES[case](device, **args)
    except BaseException:
        traceback.print_exc()
        sys.stdout.flush()
        os._exit(1)  # the other ranks' collectives time out; never hang here
    torch.save(result, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
