#!/usr/bin/env python3
"""Where the time of one frame or one differentiable step goes, on one GPU.

    python3 profile_port.py --scene SphereField --mode step
    python3 profile_port.py --scene ModelTest --mode frame
    python3 profile_port.py --scene CornellBox --mode frame --root output/parent
    python3 profile_port.py --scene LightTest --mode regen
    python3 profile_port.py --scene SphereField --mode frame --cascade 3:2,5:4,7:16

Runs ``rust_pathtracer_tpu_torch`` (never JAX) on the card: one warm-up,
then the same frame (``render_radiance``), regen frame
(``wavefront.render_radiance_regen``) or differentiable step
(``render_radiance`` with ``differentiable=True``, loss = mean(img),
``backward``) under ``torch.profiler`` with CPU and CUDA activities.
Prints:

* the card's name and power limit;
* the host wall time of the profiled run (closed by a synchronize) and
  the same run unprofiled;
* the device busy time, the union of the CUDA kernel and copy intervals
  of the trace, and the idle share 1 - busy / profiled wall (the
  profiler slows the host, so the idle share is an upper bound);
* the device time by kernel and by host op (an op's row counts the
  kernels it launched), largest first, and the device time under
  autograd's backward; with ``--kernel NAME``, the device time and
  launches of the kernels whose name holds NAME.

Exits non-zero without a GPU.  ImageScene is the image-textured scene of
``tests/test_grad.py::_scene_simple`` (chip_smoke.py's phase 11: the
generic route, K3 at 3 primitives).  ModelTest renders
``scene.obj_loader.write_benchmark_obj``'s asset, ModelTest20k its
20,000-triangle mesh (rows=101, cols=100: the pair route, K7).  CornellBox's frame is
the serving shape (400x400, 60 spp in chunks of 6, 960,000 lanes a
chunk), its step ``bench.py``'s (512x512, 4 spp, one chunk).  LightTest's
frame and regen frame are chip_smoke.py's phase 21 (854x480, 16 spp, 50
bounces), SphereField's regen frame its phase 22 (8 spp).
``--root`` imports the package from another checkout (a parent commit
unpacked with ``git archive``), so that two versions are timed by one
script on one card.  ``--cascade`` renders a frame through the cascade
renderer: "dynamic", "auto" or a static schedule.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))

# scene -> mode -> (width, height, spp, bounces, spp a chunk): the
# scene's own width, spp cut to one chunk; CornellBox as chip_smoke.py
# serves it and as bench.py steps it
SHAPES = {"SphereField": {**dict.fromkeys(("frame", "step"), (854, 480, 2, 20, 2)),
                         "regen": (854, 480, 8, 20, 2)},
          "LightTest": dict.fromkeys(("frame", "regen"), (854, 480, 16, 50, 2)),
          "ModelTest": dict.fromkeys(("frame", "step"), (800, 800, 1, 20, 1)),
          "ModelTest20k": dict.fromkeys(("frame", "step"), (800, 800, 1, 20, 1)),
          "TwoSphereCheckers": dict.fromkeys(("frame", "step"), (854, 480, 2, 20, 2)),
          "ImageScene": dict.fromkeys(("frame", "step"), (854, 480, 2, 20, 2)),
          "CornellBox": {"frame": (400, 400, 60, 20, 6), "step": (512, 512, 4, 20, 4)}}
# write_benchmark_obj's arguments: its 10,080-triangle asset, and the
# 20,000-triangle mesh whose frame takes K7 (and K5 where it overflows)
MESHES = {"ModelTest": {}, "ModelTest20k": dict(rows=101, cols=100)}
TOP = 20  # rows of each table
# ImageScene: tests/test_grad.py::_scene_simple (chip_smoke.py's phase 11,
# the generic route with K3 at 3 primitives): its camera and background
IMAGE_CAM = ((0.0, 1.0, 2.0), (0.0, 0.5, -3.0), (0.0, 1.0, 0.0), 50.0, 854.0 / 480.0,
             0.0, 10.0)
IMAGE_BG = (0.1, 0.1, 0.1)


def image_scene(dev):
    """A lambertian sphere, a ground sphere with an 8x8 image ramp, a rect
    light (tests/test_grad.py::_scene_simple)."""
    import numpy as np

    from rust_pathtracer_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    b.add_sphere((0.0, 0.5, -3.0), 0.5, b.lambertian((0.4, 0.5, 0.6)))
    ramp = np.linspace(0.1, 0.9, 8 * 8 * 3).reshape(8, 8, 3).astype(np.float32)
    b.add_sphere((0.0, -100.0, -3.0), 100.0, b.lambertian(b.image_texture(ramp)))
    b.add_rect("xz", (-2.0, 4.0, -5.0), (2.0, 4.0, -1.0), -1.0,
               b.diffuse_light((5.0, 5.0, 5.0)))
    return b.build(use_bvh=False, device=dev)


def busy_ms(events):
    """Union of the device intervals (kernels and copies), in ms."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type.name == "CUDA" and e.time_range.end > e.time_range.start)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--scene", default="SphereField", choices=sorted(SHAPES))
    p.add_argument("--mode", default="step", choices=["step", "frame", "regen"])
    p.add_argument("--root", default=REPO,
                   help="the checkout whose rust_pathtracer_tpu_torch to import")
    p.add_argument("--cascade", default=None, metavar="SCHEDULE",
                   help="frame mode: render through the cascade, 'dynamic', "
                        "'auto' or a schedule such as 3:2,5:4")
    p.add_argument("--kernel", action="append", default=[],
                   help="also print the device time and launches of the kernels "
                        "whose name holds this string (repeatable)")
    args = p.parse_args()

    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False", flush=True)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else "unknown"
    print(card, flush=True)
    print(f"package from {root}", flush=True)

    from rust_pathtracer_tpu_torch.camera import make_camera
    from rust_pathtracer_tpu_torch.grad import CameraParams, DiffParams, apply_params
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key

    kw = {}
    if args.scene.startswith("ModelTest"):
        from rust_pathtracer_tpu_torch.scene.obj_loader import write_benchmark_obj

        path = os.path.join(root, "output", "profile", f"{args.scene}.obj")
        write_benchmark_obj(path, **MESHES[args.scene])
        kw["obj_path"] = path
    if args.mode not in SHAPES[args.scene]:
        print(f"FAIL: no {args.mode} shape for {args.scene}", flush=True)
        return 1
    W, H, spp, nb, chunk = SHAPES[args.scene][args.mode]
    dev = "cuda"
    if args.scene == "ImageScene":
        scene, bg = image_scene(dev), IMAGE_BG
        cam = make_camera(*IMAGE_CAM, device=dev)
        cam_params = CameraParams.create(*IMAGE_CAM, device=dev)
    else:
        sd = get_scene("ModelTest" if args.scene.startswith("ModelTest") else args.scene,
                       **kw)
        scene, bg = sd.build(device=dev), sd.output.image.background
        cam = sd.camera_at(0.0, device=dev)
        cam_params = sd.camera_at(0.0, device=dev, make=CameraParams.create)
    settings = RenderSettings(W, H, spp, nb, bg, spp_chunk=chunk,
                              differentiable=args.mode == "step")
    if args.cascade is not None:
        if args.mode != "frame":
            print("FAIL: --cascade renders a frame (--mode frame)", flush=True)
            return 1
        settings = dataclasses.replace(
            settings, cascade=True,
            cascade_schedule=None if args.cascade == "dynamic" else args.cascade)
    key = prng_key(0, device=dev)
    leaves = None
    if args.mode == "step":  # the camera's seven parameters as leaves too
        params = DiffParams.from_scene(scene, cam_params, bg)
        leaves = [x.detach().clone().requires_grad_(True) for x in params.leaves()]

    def run():
        if args.mode == "regen":
            from rust_pathtracer_tpu_torch.wavefront import render_radiance_regen

            return render_radiance_regen(scene, cam, settings, key, device=dev)
        if leaves is None:
            return render_radiance(scene, cam, settings, key, device=dev)
        for x in leaves:
            x.grad = None
        prm = DiffParams.from_leaves(leaves)
        img, stats = render_radiance(apply_params(scene, prm), prm.camera.build(),
                                     settings, key, background=prm.background,
                                     device=dev)
        img.mean().backward()
        return img, stats

    run()  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, stats = run()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = busy_ms(prof.events())
    print(f"{args.scene} {args.mode}"
          f"{'' if args.cascade is None else f' cascade {args.cascade}'} {W}x{H}, "
          f"{spp} spp ({chunk} a chunk), {nb} bounces on {card}: "
          f"wall {plain_wall:.2f} ms unprofiled, {wall:.2f} ms profiled; device busy "
          f"{busy:.2f} ms, idle share {1 - busy / wall:.4f} of the profiled wall; "
          f"segments {float(stats.segments):.0f}", flush=True)
    avgs = prof.key_averages()

    def dev_ms(a):
        return getattr(a, "device_time_total", getattr(a, "cuda_time_total", 0.0)) / 1e3

    kernels = sorted((a for a in avgs if a.device_type.name == "CUDA"), key=dev_ms,
                     reverse=True)
    ops = sorted((a for a in avgs if a.device_type.name != "CUDA" and dev_ms(a) > 0),
                 key=dev_ms, reverse=True)
    backward = [a for a in ops if a.key.startswith("autograd::engine::evaluate_function")]
    print(f"device time {sum(dev_ms(a) for a in kernels):.2f} ms in "
          f"{sum(a.count for a in kernels)} launches; under autograd's backward "
          f"{sum(dev_ms(a) for a in backward):.2f} ms")
    for name in args.kernel:
        rows = [a for a in kernels if name in a.key]
        print(f"kernels holding {name!r}: {sum(dev_ms(a) for a in rows):.4f} ms in "
              f"{sum(a.count for a in rows)} launches")
    for title, rows in (("kernels", kernels), ("host ops (their kernels' time)", ops)):
        print(f"{title} by device time, top {TOP}:")
        for a in rows[:TOP]:
            print(f"  {dev_ms(a):10.2f} ms  {a.count:7d} calls  {a.key[:100]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
