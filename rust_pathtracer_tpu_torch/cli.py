"""Command-line entry point: render one frame of a named scene to a PNG.

Counterpart of ``rust_pathtracer_tpu/cli.py``; plain host code.

    python -m rust_pathtracer_tpu_torch.cli --scene CornellBox \\
        --width 256 --height 256 --spp 64 --output-dir ./output

    python -m rust_pathtracer_tpu_torch.cli --scene ModelTest \
        --obj-path ./model.obj --spp 4

    python -m rust_pathtracer_tpu_torch.cli --scene LightTest --spp 16 --regen

    python -m rust_pathtracer_tpu_torch.cli --scene SphereField --cascade auto \
        --checkpoint ./output/frame.ckpt --checkpoint-every 4

    torchrun --nproc-per-node 4 -m rust_pathtracer_tpu_torch.cli \
        --scene SphereField --mesh 2x2 --backend gloo

The default device is ``cuda``; ``--device cuda`` where there is no GPU
exits non-zero (there is no CPU fallback).  One frame, the camera at
t = 0.  Prints the ray segments traced, the wall seconds of the render
(the kernels' first-use builds are done before the clock starts) and
segments per second.  ``--regen`` renders with the regeneration
wavefront (``wavefront.render_radiance_regen``, a pool of ``--lanes``
lanes), as the JAX CLI routes it.  ``--cascade`` renders with the
cascade: bare, the dynamic one; ``auto``, a schedule derived from a
probe; or an explicit schedule such as ``3:2,6:4``, checked when the
arguments are parsed.  ``--checkpoint FILE`` saves the frame's progress
every ``--checkpoint-every`` sample chunks and resumes from FILE where
it matches the job (``utils/checkpoint.py``).

``--mesh TILESxSAMPLES`` renders over a grid of ``torch.distributed``
ranks (``parallel/shard.py``), one process a rank, started by
``torchrun --nproc-per-node TILES*SAMPLES``; a world size that is not
TILES*SAMPLES exits non-zero (never a single-device render instead).
``--backend`` is NCCL (a card a rank; the default on ``cuda``) or gloo
(ranks that share a card, or the CPU; the default on ``cpu``); the
ranks meet at ``--init-method`` (torchrun's ``env://`` by default).
With ``--checkpoint`` the sharded checkpoint runs.  Rank 0 writes the
PNG and prints the line.  ``--mesh`` with ``--regen`` is an error, as
in the JAX CLI.

Not ported yet (ROADMAP queue 1 item 13): ``--scene-json``, animation
frames and GIFs (``--frames``), profiling and metrics files.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rust_pathtracer_tpu_torch",
        description="path tracer on PyTorch + CUDA (forward render)",
    )
    p.add_argument("--scene", required=True, help="named scene")
    p.add_argument("--obj-path", default="./model.obj", help="OBJ for ModelTest")
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--spp", type=int, help="samples per pixel override")
    p.add_argument("--max-bounces", type=int)
    p.add_argument("--spp-chunk", type=int, help="samples per wavefront chunk")
    p.add_argument("--seed", type=int, default=0, help="RNG key seed")
    p.add_argument("--bvh", choices=["auto", "on", "off"], default="auto")
    p.add_argument("--leaf-size", type=int, default=4)
    p.add_argument(
        "--russian-roulette", type=int, default=None, metavar="START_BOUNCE",
        help="enable russian roulette from this bounce (off by default: "
             "reference semantics)",
    )
    p.add_argument(
        "--regen", action="store_true",
        help="regeneration wavefront: terminated lanes refill from the "
             "sample queue (best for deep-bounce scenes, e.g. LightTest)",
    )
    p.add_argument(
        "--lanes", type=int, default=None,
        help="lane-pool size for --regen (default min(total, 2^20))",
    )
    p.add_argument(
        "--cascade", default=None, metavar="SCHEDULE", nargs="?", const="dynamic",
        help="compact the wavefront once lanes die (the same image as the "
             "chunked render).  Bare --cascade: the dynamic cascade; 'auto': "
             "a schedule from a probe render; or a static schedule such as "
             "5:8,9:64 (boundary:shrink,...; a shrink may be a rational like "
             "16/11)",
    )
    p.add_argument("--checkpoint", help="accumulation checkpoint file (exact resume)")
    p.add_argument(
        "--checkpoint-every", type=int, default=1, metavar="CHUNKS",
        help="save every N sample chunks (each save costs a device sync and "
             "a disk write)",
    )
    p.add_argument(
        "--mesh", default=None, metavar="TILESxSAMPLES",
        help="shard over a grid of torch.distributed ranks, e.g. 2x2 (launch "
             "TILES*SAMPLES ranks with torchrun; default: one device)",
    )
    p.add_argument(
        "--backend", choices=["nccl", "gloo"], default=None,
        help="collectives of --mesh: nccl (a card a rank; the default on cuda) "
             "or gloo (ranks that share a card, or the CPU; the default on cpu)",
    )
    p.add_argument(
        "--init-method", default=None, metavar="URL",
        help="where the --mesh ranks meet (default env://, torchrun's)",
    )
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p


def parse_mesh(raw: str):
    """"TxS" as (tiles, samples), both at least 1; ValueError otherwise."""
    try:
        tiles, samples = (int(x) for x in raw.lower().split("x"))
    except ValueError:
        raise ValueError(f"--mesh {raw!r} is not TILESxSAMPLES, e.g. 2x2") from None
    if tiles < 1 or samples < 1:
        raise ValueError(f"--mesh {raw!r}: tiles and samples must be at least 1")
    return tiles, samples


def _check_args(parser: argparse.ArgumentParser, args) -> None:
    """The checks argparse cannot make; errors exit as argparse's do."""
    from rust_pathtracer_tpu_torch.render import parse_cascade_schedule

    if args.cascade is not None:
        if args.regen:
            parser.error("--cascade and --regen are mutually exclusive renderer modes")
        if args.cascade not in ("dynamic", "auto"):
            try:
                parse_cascade_schedule(args.cascade)
            except ValueError as e:
                parser.error(str(e))
    if args.checkpoint_every < 1:
        parser.error("--checkpoint-every must be at least 1")
    if args.mesh is None and (args.backend or args.init_method):
        parser.error("--backend and --init-method apply to --mesh only")
    if args.mesh is not None:
        if args.regen:
            parser.error("--mesh and --regen are mutually exclusive renderer modes "
                         "(the regeneration wavefront is single-device)")
        try:
            parse_mesh(args.mesh)
        except ValueError as e:
            parser.error(str(e))


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    _check_args(parser, args)

    import torch

    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.checkpoint import render_radiance_checkpointed
    from rust_pathtracer_tpu_torch.utils.image import frame_path, to_rgb8, write_png
    from rust_pathtracer_tpu_torch.wavefront import render_radiance_regen

    if args.device == "cuda" and not torch.cuda.is_available():
        print("error: --device cuda, but torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    mesh = None
    device = args.device
    if args.mesh is not None:
        from rust_pathtracer_tpu_torch.parallel import distributed_init, make_mesh

        tiles, samples = parse_mesh(args.mesh)
        world = int(os.environ.get("WORLD_SIZE", 1))
        if world != tiles * samples:
            print(f"error: --mesh {args.mesh} needs {tiles * samples} ranks, but the "
                  f"world size is {world} (launch with torchrun --nproc-per-node "
                  f"{tiles * samples})", file=sys.stderr)
            return 2
        backend = args.backend or ("nccl" if args.device == "cuda" else "gloo")
        device = distributed_init(backend, args.init_method, device=args.device)
        mesh = make_mesh(tiles, samples, device=device)

    kwargs = {"obj_path": args.obj_path} if args.scene == "ModelTest" else {}
    use_bvh = {"auto": "auto", "on": True, "off": False}[args.bvh]
    sd = get_scene(args.scene, use_bvh=use_bvh, leaf_size=args.leaf_size, **kwargs)
    settings = sd.output.image
    overrides = {}
    if args.width:
        overrides["width"] = args.width
    if args.height:
        overrides["height"] = args.height
    if args.spp:
        overrides["samples_per_pixel"] = args.spp
    if args.max_bounces:
        overrides["max_bounces"] = args.max_bounces
    if args.spp_chunk:
        overrides["spp_chunk"] = args.spp_chunk
    if args.russian_roulette is not None:
        overrides["russian_roulette_start"] = args.russian_roulette
    if args.cascade is not None:
        overrides["cascade"] = True
        if args.cascade != "dynamic":
            overrides["cascade_schedule"] = args.cascade
    if overrides:
        settings = dataclasses.replace(settings, **overrides)

    scene = sd.build(device=device)
    cam = sd.camera_at(0.0, device=device)
    key = prng_key(args.seed, device=device)
    if args.device == "cuda":
        from rust_pathtracer_tpu_torch.ops._build import load_library

        # first-use builds of the kernels the scene's routes launch:
        # set-up, not render time.  On a mesh the first rank of each host
        # builds them, and its other ranks load them after a barrier
        libs = (("fused_bounce", "closest_hit", "draws") if scene.kinds_static is not None
                else ("projected", "draws"))
        first = mesh is None or int(os.environ.get("LOCAL_RANK", 0)) == 0
        if not first:
            mesh.barrier()
        for name in libs:
            load_library(name)
        if mesh is not None and first:
            mesh.barrier()

    if mesh is not None:
        mesh.barrier()  # every rank's kernels loaded: the clock starts together
    t0 = time.perf_counter()
    if mesh is not None and args.checkpoint:
        from rust_pathtracer_tpu_torch.utils.checkpoint import (
            render_radiance_sharded_checkpointed,
        )

        img, stats = render_radiance_sharded_checkpointed(
            scene, cam, settings, key, mesh, args.checkpoint,
            checkpoint_every=args.checkpoint_every)
    elif mesh is not None:
        from rust_pathtracer_tpu_torch.parallel import render_radiance_sharded

        img, stats = render_radiance_sharded(scene, cam, settings, key, mesh)
    elif args.regen:
        img, stats = render_radiance_regen(scene, cam, settings, key, lanes=args.lanes,
                                           device=args.device)
    elif args.checkpoint:
        img, stats = render_radiance_checkpointed(
            scene, cam, settings, key, args.checkpoint,
            checkpoint_every=args.checkpoint_every, device=args.device)
    else:
        img, stats = render_radiance(scene, cam, settings, key, device=args.device)
    img = img.cpu().numpy()  # waits for the device
    if mesh is not None:
        mesh.barrier()  # the render ends with the last rank's
    seconds = time.perf_counter() - t0
    if mesh is not None:
        rank = mesh.rank
        torch.distributed.destroy_process_group()
        if rank != 0:
            return 0

    path = frame_path(args.output_dir, 0)
    write_png(path, to_rgb8(img))
    segments = float(stats.segments)
    device_name = (torch.cuda.get_device_name(0) if args.device == "cuda"
                   else "cpu")
    print(f"wrote {path}")
    print(f"{sd.name} {settings.width}x{settings.height} "
          f"spp={settings.samples_per_pixel} bounces={settings.max_bounces} "
          f"{'regen ' if args.regen else ''}"
          f"{'' if mesh is None else f'mesh={mesh.tiles}x{mesh.samples} '}"
          f"{'' if args.cascade is None else f'cascade={args.cascade} '}on {device_name}: "
          f"segments={segments:.0f} seconds={seconds:.3f} "
          f"segments/s={segments / seconds:.4g}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
