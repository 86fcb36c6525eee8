"""The loops that drive the program: one client, closed loop.

* ``frames``: whole frames through ``render.render_radiance`` (or, with a
  ``mesh`` in the traffic, ``parallel.shard.render_radiance_sharded`` on
  every rank; with ``renderer`` "regen", the regeneration wavefront
  ``wavefront.render_radiance_regen`` over a pool of the traffic's
  ``lanes``), back to back, a new key a frame, the camera at each
  frame's orbit time where the configuration orbits;
* ``steps``: inverse-rendering steps through ``grad.render_loss_and_grad``
  and Adam on the colours the traffic names, a new key a step.

Set-up builds the scene (timed apart as ``scene_build_s``), loads the
kernels, and warms the cell's own shapes: one frame, or the first steps,
which go through the window's own call and whose numbers the check
compares.  The window then runs for ``seconds`` (the last answer may end
after it), or, traced, for the traffic's ``trace_frames`` /
``trace_steps`` under the profiler.  Each frame is closed by a device
sync; each step too, after its parameter update.  The pixels the check
samples are gathered from each frame as it completes, and each frame's
ray-segment count is kept on the device, unread, for the readers.

A traffic file's ``settings`` set ``RenderSettings`` fields beyond the
sizes, the background, the stream and the roulette start (``spec.SETTINGS``).
"""

from __future__ import annotations

import dataclasses
import math
import random
import sys
import time
from typing import Callable, Optional

import torch

from benchmark.reference.threefry import frame_key
from benchmark.reference.scene import texture_index

GOLDEN = (math.sqrt(5.0) - 1.0) / 2.0
WARM_INDEX = 1 << 30  # the warm-up frame's key index, outside any window
TARGET_INDEX = (1 << 30) + 1  # the inverse steps' target


def image(cell, toy: bool) -> dict:
    """The frame's settings: the configuration's, then the traffic's,
    then (on a toy run) the traffic's toy sizes."""
    cfg, tr = cell.config, cell.traffic
    out = {k: cfg[k] for k in ("width", "height", "samples_per_pixel", "max_bounces")}
    out.update({k: tr[k] for k in ("width", "height", "samples_per_pixel", "max_bounces",
                                   "spp_chunk") if k in tr})
    if toy:
        out.update({k: v for k, v in tr["toy"].items() if k in out or k == "spp_chunk"})
    if tr.get("renderer") == "regen":
        # no chunks: the reference sums a pixel's samples in one
        out.setdefault("spp_chunk", out["samples_per_pixel"])
    return out


def regen_lanes(cell, img: dict, toy: bool) -> int:
    """The regen renderer's pool: the traffic's ``lanes`` (on a toy run
    the toy's, where it sets them), which the port's queue runs as given;
    a pool over the frame's lanes raises, since the port would cut it."""
    tr = cell.traffic
    lanes = int(tr["toy"].get("lanes", tr["lanes"]) if toy else tr["lanes"])
    total = img["width"] * img["height"] * img["samples_per_pixel"]
    if not 0 < lanes <= total:
        raise ValueError(f"traffic of {cell.name!r}: a pool of {lanes} lanes, want 1 to the "
                         f"frame's {total}")
    return lanes


def orbit_time(cell, seed: int, i: int) -> float:
    """Animation time of answer ``i``: 0 for a still scene; on an orbit
    the frame (start + round(i * golden * F)) mod F of F, start = (seed x
    multiplier) mod F, so every seed's window spreads over the whole orbit."""
    orbit = cell.traffic.get("orbit")
    if orbit is None:
        return 0.0
    frames = int(cell.config["frames"])
    start = (int(seed) * int(orbit["start_multiplier"])) % frames
    return ((start + round(i * GOLDEN * frames)) % frames) / frames


def check_pixels(cell, seed: int, img: dict, toy: bool) -> torch.Tensor:
    """The pixel ids the check samples, drawn from the seed (sorted)."""
    n = cell.traffic["toy"]["pixels"] if toy else cell.traffic["check"]["pixels"]
    npix = img["width"] * img["height"]
    rng = random.Random(int(seed) * 7919 + 1)
    return torch.tensor(sorted(rng.sample(range(npix), min(n, npix))), dtype=torch.int64)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


class Window:
    """Runs ``body(i)`` back to back: for ``seconds`` (the last call may
    end after), or ``count`` times.  ``times`` holds each call's (start,
    end) on the host clock, each end after a device sync."""

    def __init__(self, device, seconds: Optional[float] = None, count: Optional[int] = None,
                 go_on: Optional[Callable[[bool], bool]] = None):
        self.device, self.seconds, self.count, self.go_on = device, seconds, count, go_on
        self.times = []
        self.start = None

    def run(self, body: Callable[[int], None]) -> None:
        self.start = time.perf_counter()
        i = 0
        while True:
            t0 = time.perf_counter()
            body(i)
            sync(self.device)
            t1 = time.perf_counter()
            self.times.append((t0, t1))
            i += 1
            more = (i < self.count if self.count is not None
                    else t1 - self.start < self.seconds)
            if self.go_on is not None:
                more = self.go_on(more)
            if not more:
                break

    @property
    def seconds_to_last(self) -> float:
        return self.times[-1][1] - self.start


def load_kernels(device) -> None:
    """Build (first run in a checkout) or load every kernel library of the
    port, the builds in parallel, and the native BVH builder."""
    if torch.device(device).type != "cuda":
        return
    from concurrent.futures import ThreadPoolExecutor

    from rust_pathtracer_tpu_torch import native
    from rust_pathtracer_tpu_torch.ops._build import SIGNATURES, load_library

    with ThreadPoolExecutor(max_workers=len(SIGNATURES) + 1) as pool:
        futs = [pool.submit(native.build)] + [pool.submit(load_library, n) for n in SIGNATURES]
        for fut in futs:
            fut.result()


def port_scene(cell, device, img: dict, differentiable: bool = False):
    """The program's scene (timed), its scene definition and settings."""
    from rust_pathtracer_tpu_torch.models import get_scene

    t0 = time.perf_counter()
    load_kernels(device)
    print(f"[benchmark] kernels loaded in {time.perf_counter() - t0:.3f} s", file=sys.stderr,
          flush=True)
    sd = get_scene(cell.config["scene"])
    t0 = time.perf_counter()
    scene = sd.build(device=device)
    sync(device)
    build_s = time.perf_counter() - t0
    settings = dataclasses.replace(
        sd.output.image, width=img["width"], height=img["height"],
        samples_per_pixel=img["samples_per_pixel"], max_bounces=img["max_bounces"],
        spp_chunk=img["spp_chunk"], rng_scheme=cell.config["rng_scheme"],
        russian_roulette_start=cell.config["russian_roulette_start"],
        differentiable=differentiable, **cell.traffic.get("settings", {}))
    return sd, scene, settings, build_s


class FrameLoop:
    """Whole frames on one device, or on this rank of a mesh."""

    def __init__(self, cell, seed: int, device, toy: bool = False, mesh=None):
        from rust_pathtracer_tpu_torch.render import render_radiance

        self.cell, self.seed, self.device, self.mesh = cell, int(seed), device, mesh
        self.img = image(cell, toy)
        self.sd, self.scene, self.settings, self.scene_build_s = port_scene(
            cell, device, self.img)
        self.pixels = check_pixels(cell, seed, self.img, toy).to(device)
        self.answers = []  # (index, orbit time, the sampled pixels (P, 3))
        self.segments = []  # each frame's ray segments, a device scalar
        self.bounces = 0
        self.renderer = cell.traffic.get("renderer", "chunked")
        if self.renderer == "regen":
            from rust_pathtracer_tpu_torch.wavefront import render_radiance_regen

            self.lanes = regen_lanes(cell, self.img, toy)
            self._render = lambda cam, key: render_radiance_regen(
                self.scene, cam, self.settings, key, lanes=self.lanes, device=device)
        elif mesh is None:
            self._render = lambda cam, key: render_radiance(
                self.scene, cam, self.settings, key, device=device)
        else:
            from rust_pathtracer_tpu_torch.parallel.shard import render_radiance_sharded

            self._render = lambda cam, key: render_radiance_sharded(
                self.scene, cam, self.settings, key, mesh)

    @property
    def samples_per_frame(self) -> int:
        return self.img["width"] * self.img["height"] * self.img["samples_per_pixel"]

    @property
    def pixels_per_rank(self) -> int:
        """Pixels a rank traces: its tile (the pixels padded to a multiple
        of the tiles), or the frame."""
        npix = self.img["width"] * self.img["height"]
        return npix if self.mesh is None else -(-npix // self.mesh.tiles)

    def frame(self, i: int, keep: bool = True) -> None:
        t = orbit_time(self.cell, self.seed, i)
        key = torch.tensor(frame_key(self.seed, i), dtype=torch.int64, device=self.device)
        img, stats = self._render(self.sd.camera_at(t, device=self.device), key)
        self.bounces += int(stats.bounces)
        if keep:
            self.answers.append((i, t, img.reshape(-1, 3)[self.pixels]))
            self.segments.append(stats.segments)

    def warm(self) -> None:
        self.frame(WARM_INDEX, keep=False)
        sync(self.device)
        self.bounces = 0


class StepLoop:
    """Inverse-rendering steps: the loss to a target rendered at the true
    colours, Adam on the unknown colours, each clipped to [0, 1] after its
    update (``examples/inverse_rendering.py``)."""

    def __init__(self, cell, seed: int, device, toy: bool = False):
        from rust_pathtracer_tpu_torch.grad import (
            CameraParams,
            DiffParams,
            render_loss_and_grad,
            render_radiance_diff,
        )

        self.cell, self.seed, self.device = cell, int(seed), device
        tr = cell.traffic
        self.img = image(cell, toy)
        self.sd, self.scene, self.settings, self.scene_build_s = port_scene(
            cell, device, self.img, differentiable=True)
        c = cell.config["camera"]
        cam = CameraParams.create(c["lookfrom"], c["lookat"], c["vup"], c["vfov"],
                                  c["aspect"], c["aperture"], c["focus_dist"], device=device)
        self.truth = DiffParams.from_scene(self.scene, cam, cell.config["background"])
        with torch.no_grad():
            key = torch.tensor(frame_key(seed, TARGET_INDEX), dtype=torch.int64, device=device)
            self.target = render_radiance_diff(self.truth, self.scene, self.settings, key,
                                               device=device)
        self.rows = [texture_index(cell.config, n) for n in tr["unknown"]]
        self.leaves = [torch.full((3,), float(tr["guess"]), dtype=torch.float32,
                                  device=device, requires_grad=True) for _ in self.rows]
        self.theta0 = [x.detach().clone() for x in self.leaves]
        self.opt = torch.optim.Adam(self.leaves, lr=float(tr["learning_rate"]))
        self._loss_and_grad = render_loss_and_grad
        self.losses = []
        self.first_grads = None
        self.theta_first = None

    def step(self, i: int) -> None:
        with torch.no_grad():
            tex = self.truth.tex_color.detach().clone()
            for r, x in zip(self.rows, self.leaves):
                tex[r] = x
        params = dataclasses.replace(self.truth, tex_color=tex)
        key = torch.tensor(frame_key(self.seed, i), dtype=torch.int64, device=self.device)
        loss, grads = self._loss_and_grad(params, self.scene, self.settings, key,
                                          self.target, device=self.device)
        for r, x in zip(self.rows, self.leaves):
            x.grad = grads.tex_color[r].detach().clone()
        self.opt.step()
        with torch.no_grad():
            for x in self.leaves:
                x.clamp_(0.0, 1.0)
        if i < self.cell.traffic["first_steps"]:
            self.losses.append(loss.detach())
            if i == 0:
                beta1 = self.opt.param_groups[0]["betas"][0]
                # no first moment: the optimizer took no step, and no gradient
                self.first_grads = [self.opt.state[x].get("exp_avg", torch.zeros_like(x))
                                    .detach() / (1.0 - beta1) for x in self.leaves]
            if i == self.cell.traffic["first_steps"] - 1:
                self.theta_first = [x.detach().clone() for x in self.leaves]

    def first(self) -> None:
        for i in range(self.cell.traffic["first_steps"]):
            self.step(i)
        sync(self.device)
