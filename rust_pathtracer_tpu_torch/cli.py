"""The command line: a scene (named or JSON) to PNG frames.

Counterpart of ``rust_pathtracer_tpu/cli.py``; plain host code.

    python -m rust_pathtracer_tpu_torch.cli --scene CornellBox \\
        --width 256 --height 256 --spp 64 --output-dir ./output

    python -m rust_pathtracer_tpu_torch.cli --scene-json scene.json --spp 16

    python -m rust_pathtracer_tpu_torch.cli --scene SphereField --spp 8 --gif \\
        --cascade auto --timing-log ./output/frames.jsonl

    python -m rust_pathtracer_tpu_torch.cli --scene ModelTest \\
        --obj-path ./model.obj --spp 4

    python -m rust_pathtracer_tpu_torch.cli --scene LightTest --spp 16 --regen

    torchrun --nproc-per-node 4 -m rust_pathtracer_tpu_torch.cli \\
        --scene SphereField --frames 1 --mesh 2x2 --backend gloo

The default device is ``cuda``; ``--device cuda`` where there is no GPU
exits non-zero (there is no CPU fallback).  ``--list-scenes`` prints the
built-in scenes.  A scene renders ``--frames`` frames (default: the
scene's fps x duration, one for a still), frame f with the camera at
t = f / frames (main.rs:52), from ``--frame-start`` on, each to
``image_{f:04d}.png``; ``--gif`` assembles them into ``animation.gif``
at the scene's fps (30 where it has none), ``--rebuild-bvh`` builds the
scene again for every frame after the first, and ``--timing-log FILE``
appends a JSON line a frame: ``{frame, seconds, segments}``.  The kernels'
first-use builds are done before any clock starts.  A summary line
prints the frames, the ray segments traced, the render's wall seconds
and segments per second, summed over the frames; ``RenderMetrics`` and
the stage timers report to stderr unless ``--quiet``.

``--regen`` renders with the regeneration wavefront
(``wavefront.render_radiance_regen``, a pool of ``--lanes`` lanes).
``--cascade`` renders with the cascade: bare, the dynamic one; ``auto``,
a schedule derived from a probe; or an explicit schedule such as
``3:2,6:4``, checked when the arguments are parsed.  Over an animation
"auto" is derived once from probes at up to 8 poses of the frames to
render (at 1.15x the renderer's margin) and kept; a frame that
overflows it derives again at double the margin and renders again.
``--checkpoint FILE`` saves a frame's progress every
``--checkpoint-every`` sample chunks and resumes from FILE where it
matches the job (``utils/checkpoint.py``); an animation keeps one file
a frame, ``FILE.frame{f:04d}``, as the JAX CLI names them.
``--debug-nans`` raises FloatingPointError after the first frame whose
image holds a NaN.  ``--profile-dir DIR`` writes a ``torch.profiler``
Chrome trace of the frames to ``DIR/trace.json``.

``--mesh TILESxSAMPLES`` renders every frame over a grid of
``torch.distributed`` ranks (``parallel/shard.py``), one process a
rank, started by ``torchrun --nproc-per-node TILES*SAMPLES``; a world
size that is not TILES*SAMPLES exits non-zero (never a single-device
render instead).  ``--backend`` is NCCL (a card a rank; the default on
``cuda``) or gloo (ranks that share a card, or the CPU; the default on
``cpu``); the ranks meet at ``--init-method`` (torchrun's ``env://`` by
default).  With ``--checkpoint`` the sharded checkpoint runs.  Rank 0
writes the PNGs, the GIF, the timing log and the summary; each rank
writes its own trace (``trace.rank{r}.json``).  "auto" is derived by the
sharded renderer frame by frame.  ``--mesh`` with ``--regen`` is an
error, as in the JAX CLI.

``--bvh`` applies to the built-in scenes too (the JAX CLI applies it to
scene JSON only).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

# the sticky "auto" schedule of an animation: probes at up to this many
# poses, at AUTO_STICKY_SLACK x the renderer's margin (the JAX CLI's)
AUTO_PROBE_POSES = 8
AUTO_STICKY_SLACK = 1.15


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rust_pathtracer_tpu_torch",
        description="path tracer on PyTorch + CUDA (forward render)",
    )
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--scene", help="named scene (see --list-scenes)")
    src.add_argument("--scene-json", help="scene JSON file")
    src.add_argument("--list-scenes", action="store_true",
                     help="print the built-in scenes and exit")
    p.add_argument("--obj-path", default="./model.obj", help="OBJ for ModelTest")
    p.add_argument("--output-dir", default="./output")
    p.add_argument("--width", type=int)
    p.add_argument("--height", type=int)
    p.add_argument("--spp", type=int, help="samples per pixel override")
    p.add_argument("--max-bounces", type=int)
    p.add_argument("--spp-chunk", type=int, help="samples per wavefront chunk")
    p.add_argument("--frames", type=int, help="animation frame count override")
    p.add_argument("--frame-start", type=int, default=0,
                   help="first frame to render (resume an animation here)")
    p.add_argument("--seed", type=int, default=0, help="RNG key seed")
    p.add_argument("--bvh", choices=["auto", "on", "off"], default="auto")
    p.add_argument("--leaf-size", type=int, default=4)
    p.add_argument(
        "--russian-roulette", type=int, default=None, metavar="START_BOUNCE",
        help="enable russian roulette from this bounce (off by default: "
             "reference semantics)",
    )
    p.add_argument("--gif", action="store_true",
                   help="assemble the frames into animation.gif")
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
    p.add_argument("--checkpoint", help="accumulation checkpoint file (exact resume); "
                                        "an animation keeps FILE.frameNNNN a frame")
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
    p.add_argument("--profile-dir", help="write a torch.profiler Chrome trace here")
    p.add_argument(
        "--timing-log", metavar="PATH",
        help="append one JSON line a frame: {frame, seconds, segments}",
    )
    p.add_argument(
        "--rebuild-bvh", action="store_true",
        help="build the scene again for every animation frame after the first "
             "(the reference builds once)",
    )
    p.add_argument("--debug-nans", action="store_true",
                   help="raise FloatingPointError after a frame whose image holds a NaN")
    p.add_argument("--quiet", action="store_true",
                   help="no progress bar, schedule or metrics on stderr")
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
    if args.frame_start < 0:
        parser.error("--frame-start must be at least 0")
    if args.frames is not None and args.frames < 1:
        parser.error("--frames must be at least 1")
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


def _settings(sd, args):
    """The scene's image settings with the command line's overrides."""
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
    return dataclasses.replace(sd.output.image, **overrides)


def probe_frames(frame_start: int, frames: int):
    """The frames whose poses the sticky "auto" schedule is derived from:
    up to AUTO_PROBE_POSES spread evenly over [frame_start, frames), both
    ends included (the JAX CLI's), so a resumed animation probes the
    range it renders."""
    n = min(AUTO_PROBE_POSES, frames - frame_start)
    span = frames - frame_start
    return sorted({frame_start + (i * (span - 1)) // max(1, n - 1) for i in range(n)})


def main(argv=None) -> int:
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.list_scenes:
        from rust_pathtracer_tpu_torch.models import SCENES

        for name in sorted(SCENES):
            print(name)
        return 0
    _check_args(parser, args)

    import numpy as np
    import torch

    from rust_pathtracer_tpu_torch import render as render_mod
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import (
        CascadeOverflowError,
        derive_cascade_schedule,
        derive_cascade_schedule_multi,
        render_radiance,
    )
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.checkpoint import render_radiance_checkpointed
    from rust_pathtracer_tpu_torch.utils.image import (
        frame_path,
        to_rgb8,
        write_gif,
        write_png,
    )
    from rust_pathtracer_tpu_torch.utils.metrics import (
        ProgressBar,
        RenderMetrics,
        StageTimer,
        profiler_trace,
    )
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
    lead = mesh is None or mesh.rank == 0  # writes the files and the reports
    report = lead and not args.quiet

    timer = StageTimer()
    use_bvh = {"auto": "auto", "on": True, "off": False}[args.bvh]
    if args.scene_json:
        from rust_pathtracer_tpu_torch.scene.json_io import load_scene_json

        sd = load_scene_json(args.scene_json, use_bvh=use_bvh, leaf_size=args.leaf_size)
    else:
        kwargs = {"obj_path": args.obj_path} if args.scene == "ModelTest" else {}
        sd = get_scene(args.scene, use_bvh=use_bvh, leaf_size=args.leaf_size, **kwargs)
    settings = _settings(sd, args)
    frames = args.frames if args.frames else sd.output.num_frames
    if args.frame_start >= frames:
        parser.error(f"--frame-start {args.frame_start} is past the last frame "
                     f"({sd.name} has {frames})")

    with timer.stage("scene build"):
        scene = sd.build(device=device)
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

    # an animation under "auto": one schedule for every frame, from probes
    # across the frames to render; kept unless a frame overflows it.  On
    # a mesh the sharded renderer derives it frame by frame
    sticky_auto = (settings.cascade_schedule == "auto"
                   and frames - args.frame_start > 1 and mesh is None)
    auto_margin = None
    if sticky_auto:
        auto_margin = render_mod.AUTO_MARGIN * AUTO_STICKY_SLACK
        with timer.stage("schedule probe"):
            sched = derive_cascade_schedule_multi(
                scene, [sd.camera_at(f / frames, device=device)
                        for f in probe_frames(args.frame_start, frames)],
                settings, key, margin=auto_margin, device=device)
        settings = dataclasses.replace(settings, cascade_schedule=sched,
                                       cascade=sched is not None)
        if report:
            print(f"auto cascade schedule: {sched}", file=sys.stderr)

    def render_one(settings, cam, ckpt_path):
        if mesh is not None and ckpt_path:
            from rust_pathtracer_tpu_torch.utils.checkpoint import (
                render_radiance_sharded_checkpointed,
            )

            return render_radiance_sharded_checkpointed(
                scene, cam, settings, key, mesh, ckpt_path,
                checkpoint_every=args.checkpoint_every)
        if mesh is not None:
            from rust_pathtracer_tpu_torch.parallel import render_radiance_sharded

            return render_radiance_sharded(scene, cam, settings, key, mesh)
        if args.regen:
            return render_radiance_regen(scene, cam, settings, key, lanes=args.lanes,
                                         device=device)
        if ckpt_path:
            return render_radiance_checkpointed(
                scene, cam, settings, key, ckpt_path,
                checkpoint_every=args.checkpoint_every, device=device)
        return render_radiance(scene, cam, settings, key, device=device)

    metrics = RenderMetrics(width=settings.width, height=settings.height,
                            spp=settings.samples_per_pixel)
    bar = ProgressBar(frames - args.frame_start, prefix="frames") if report else None
    rendered = []
    with profiler_trace(args.profile_dir, device, None if mesh is None else mesh.rank):
        for frame in range(args.frame_start, frames):
            cam = sd.camera_at(frame / frames, device=device)  # main.rs:52: not frames-1
            if args.rebuild_bvh and frame > args.frame_start:
                with timer.stage("bvh rebuild"):
                    scene = sd.build(device=device)
            ckpt_path = args.checkpoint
            if ckpt_path and frames > 1:
                ckpt_path = f"{ckpt_path}.frame{frame:04d}"
            if mesh is not None:
                mesh.barrier()  # every rank ready: the clock starts together
            t0 = time.perf_counter()
            with timer.stage("render"):
                while True:
                    try:
                        img, stats = render_one(settings, cam, ckpt_path)
                        break
                    except CascadeOverflowError as e:
                        # the kept schedule went stale (the camera moved):
                        # derive again at double the margin and render the
                        # frame again; an explicit schedule raises
                        if not sticky_auto:
                            raise
                        auto_margin *= 2.0
                        if report:
                            print(f"frame {frame}: {e}\nderiving again at margin "
                                  f"{auto_margin:g}", file=sys.stderr)
                        sched = derive_cascade_schedule(scene, cam, settings, key,
                                                        margin=auto_margin, device=device)
                        settings = dataclasses.replace(settings, cascade_schedule=sched,
                                                       cascade=sched is not None)
                img = img.cpu().numpy()  # waits for the device
                if mesh is not None:
                    mesh.barrier()  # the frame ends with the last rank's
            frame_s = time.perf_counter() - t0
            if args.debug_nans and np.isnan(img).any():
                raise FloatingPointError(
                    f"frame {frame}: the image holds {int(np.isnan(img).sum())} NaN "
                    "values (--debug-nans)")
            segments = float(stats.segments)
            metrics.wall_seconds += frame_s
            metrics.segments += segments
            metrics.add_occupancy(stats.occupancy.cpu().numpy())
            metrics.frames += 1
            if not lead:
                continue
            if args.timing_log:
                os.makedirs(os.path.dirname(os.path.abspath(args.timing_log)),
                            exist_ok=True)
                with open(args.timing_log, "a") as f:
                    f.write(json.dumps({"frame": frame, "seconds": round(frame_s, 3),
                                        "segments": segments}) + "\n")
            rgb = to_rgb8(img)
            path = frame_path(args.output_dir, frame)
            with timer.stage("io"):
                write_png(path, rgb)
            print(f"wrote {path}")
            if args.gif:
                rendered.append(rgb)
            if bar:
                bar.tick()
    if mesh is not None:
        torch.distributed.destroy_process_group()
    if not lead:
        return 0
    if bar:
        bar.finish()
    if args.gif:
        gif_path = os.path.join(args.output_dir, "animation.gif")
        with timer.stage("gif"):
            write_gif(gif_path, rendered, fps=sd.output.fps or 30.0)
        print(f"wrote {gif_path}")

    device_name = (torch.cuda.get_device_name(0) if args.device == "cuda"
                   else "cpu")
    seconds = metrics.wall_seconds
    print(f"{sd.name} {settings.width}x{settings.height} "
          f"spp={settings.samples_per_pixel} bounces={settings.max_bounces} "
          f"frames={metrics.frames} "
          f"{'regen ' if args.regen else ''}"
          f"{'' if mesh is None else f'mesh={mesh.tiles}x{mesh.samples} '}"
          f"{'' if args.cascade is None else f'cascade={args.cascade} '}on {device_name}: "
          f"segments={metrics.segments:.0f} seconds={seconds:.3f} "
          f"segments/s={metrics.segments / seconds:.4g}")
    if report:
        metrics.report()
        timer.report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
