"""One sharded training step on CornellBox, on the fused route.

Counterpart of ``__graft_entry__.dryrun_multichip`` in the JAX package,
whose dryrun ran the generic route only; this one runs K1 with
residuals and K2 (CornellBox's textures are solid, so the
differentiable trace takes the fused route).

    torchrun --nproc-per-node 4 -m rust_pathtracer_tpu_torch.parallel.dryrun \\
        --mesh 2x2 --device cpu

Every rank prints its line; the step's loss and gradients are the same
on every rank.
"""

from __future__ import annotations

import argparse
import sys

import torch


def dryrun_multichip(tiles: int, samples: int, *, device):
    """One SGD step (lr 0.1) of every ``DiffParams`` leaf over a (tiles,
    samples) mesh of the joined ranks; asserts what the JAX dryrun
    asserts (finite parameters after the step, loss > 0, some leaf
    changed) and returns {"loss", "changed", "size", "mesh"}.  A white
    background (not the scene's black), so rays that leave the open face
    of the box carry radiance and the backward runs on real cotangents."""
    from rust_pathtracer_tpu_torch.grad import CameraParams, DiffParams
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops.fused_bounce import fused_bounce_diff_ok
    from rust_pathtracer_tpu_torch.parallel.mesh import make_mesh
    from rust_pathtracer_tpu_torch.parallel.shard import render_loss_and_grad_sharded
    from rust_pathtracer_tpu_torch.render import RenderSettings
    from rust_pathtracer_tpu_torch.sampling import prng_key

    dev = torch.device(device)
    mesh = make_mesh(tiles, samples, device=dev)
    scene = get_scene("CornellBox").build(device=dev)
    assert fused_bounce_diff_ok(scene), "the dryrun must take the fused route"
    settings = RenderSettings(8, 8, 2, 3, (1.0, 1.0, 1.0), spp_chunk=2,
                              differentiable=True)
    cam = CameraParams.create((278.0, 278.0, -800.0), (278.0, 278.0, 0.0),
                              (0.0, 1.0, 0.0), 40.0, 1.0, 0.0, 10.0, device=dev)
    params = DiffParams.from_scene(scene, cam, settings.background)
    target = torch.zeros((settings.height, settings.width, 3), device=dev)
    loss, grads = render_loss_and_grad_sharded(params, scene, settings,
                                               prng_key(0, device=dev), target, mesh)
    old = torch.cat([x.detach().reshape(-1) for x in params.leaves()])
    new = torch.cat([(x.detach() - 0.1 * g).reshape(-1)
                     for x, g in zip(params.leaves(), grads.leaves())])
    assert bool(torch.isfinite(new).all()), "non-finite params after the step"
    assert float(loss) > 0.0, (f"vacuous dryrun: loss={float(loss)}, the backward "
                               "ran on all-zero cotangents")
    changed = int((new != old).sum())
    assert changed > 0, "the SGD step changed no parameter leaf"
    return {"loss": float(loss), "changed": changed, "size": new.numel(),
            "mesh": mesh.shape}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rust_pathtracer_tpu_torch.parallel.dryrun")
    p.add_argument("--mesh", default="2x2", metavar="TILESxSAMPLES")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    p.add_argument("--backend", choices=["nccl", "gloo"], default=None,
                   help="default: nccl on cuda, gloo on cpu")
    args = p.parse_args(argv)
    from rust_pathtracer_tpu_torch.cli import parse_mesh
    from rust_pathtracer_tpu_torch.parallel.mesh import distributed_init

    tiles, samples = parse_mesh(args.mesh)
    backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
    dev = distributed_init(backend, device=args.device)
    out = dryrun_multichip(tiles, samples, device=dev)
    print(f"dryrun_multichip OK: rank {torch.distributed.get_rank()} mesh={out['mesh']} "
          f"loss={out['loss']:.6f} changed_params={out['changed']}/{out['size']}")
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
