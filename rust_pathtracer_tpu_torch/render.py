"""Render orchestration: pixel grid -> ray wavefronts -> image.

Counterpart of ``rust_pathtracer_tpu/render.py``; plain tensor code
around the integrator.

* all pixels x a chunk of samples form one flat lane axis, traced as
  one wavefront; the samples-per-pixel loop becomes sample chunks;
* jitter u = (x + xi)/(w-1), v = (y + xi)/(h-1) (renderer.rs:22-25);
  image row r is y = height-1-r (renderer.rs:16), so the image comes
  out top row first;
* the lane counter pixel * spp + sample keys the RNG, so the same key
  gives the same image under any chunking.

Every entry point takes an explicit ``device``; asking for ``"cuda"``
where there is no GPU raises.  With ``RenderSettings.differentiable``
the chunk loop runs with autograd live: the image is differentiable in
the camera, the texture colours, the image texels and the background
(see ``grad.py``); ``RenderSettings.remat`` picks the remat mode of the
generic route (``integrator.resolve_remat_mode``).
Not ported yet: the cascade renderer (``cascade`` /
``cascade_schedule``, ROADMAP queue 1 item 11).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from rust_pathtracer_tpu_torch import sampling
from rust_pathtracer_tpu_torch.camera import Camera, camera_rays
from rust_pathtracer_tpu_torch.integrator import MAX_BOUNCE_STATS, TraceStats, trace


@dataclasses.dataclass(frozen=True)
class RenderSettings:
    """ImageSettings (scene.rs:19-25)."""

    width: int
    height: int
    samples_per_pixel: int
    max_bounces: int
    background: Tuple[float, float, float]
    # wavefront sizing: lanes per chunk = width * height * spp_chunk
    spp_chunk: Optional[int] = None
    # optional russian roulette start bounce (None = off, reference behavior)
    russian_roulette_start: Optional[int] = None
    # run the differentiable trace (fused: K1 with residuals and K2;
    # generic: K4 and autograd)
    differentiable: bool = False
    # remat mode of the generic differentiable trace: None / "auto",
    # "none", "mid", "names"
    remat: Optional[str] = None
    # not ported yet: raise in render_radiance
    cascade: bool = False
    cascade_schedule: Optional[str] = None

    def resolve_chunk(self, target_lanes: int = 1 << 20) -> int:
        """Samples per chunk: ``spp_chunk``, or as many as fit
        ``target_lanes`` lanes (the JAX package's default wavefront)."""
        if self.spp_chunk is not None:
            return max(1, min(self.spp_chunk, self.samples_per_pixel))
        per_sample = self.width * self.height
        return max(1, min(self.samples_per_pixel, target_lanes // max(per_sample, 1)))


@dataclasses.dataclass(frozen=True)
class OutputSettings:
    """OutputSettings (scene.rs:27-36): one static frame, or fps *
    duration animation frames with the camera at t = frame / frames
    (main.rs:51-53).  The port renders single frames (the CLI's t = 0);
    the animation loop is not ported yet (ROADMAP queue 1 item 13)."""

    image: RenderSettings
    fps: float = 0.0
    duration: float = 0.0


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises where no such device exists
    (never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} was asked for, but torch.cuda.is_available() "
            "is False")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    return dev


def camera_lanes(cam: Camera, base_key, pixel, sample, *, width, height, spp_total):
    """Camera lanes for flat (pixel, sample) items, (R,) int64 each: the
    lane keys (R, 2) of counter pixel * spp_total + sample (uint32
    arithmetic), origins and directions (R, 3)."""
    dev = pixel.device
    lkeys = sampling.lane_keys(base_key, (pixel * spp_total + sample) & 0xFFFFFFFF)
    jit_u = sampling.uniform2(
        sampling.bounce_keys(lkeys, 0, sampling.P_PIXEL_JITTER)
    )
    col = (pixel % width).to(torch.float32)
    y = (height - 1 - pixel // width).to(torch.float32)  # renderer.rs:16: reversed rows

    def f32(v):  # divide by a tensor: true division on every device
        return torch.tensor(v, dtype=torch.float32, device=dev)

    u = (col + jit_u[:, 0]) / f32(width - 1.0)   # renderer.rs:23
    v = (y + jit_u[:, 1]) / f32(height - 1.0)    # renderer.rs:24

    lens_keys = sampling.bounce_keys(lkeys, 0, sampling.P_LENS)
    o, d = camera_rays(cam, u, v, lens_keys)
    return lkeys, o, d


def _make_lanes(cam: Camera, base_key, pix, sample_offset: int, *, width,
                height, spp_chunk, spp_total):
    """Camera lanes for len(pix)*spp_chunk (pixel, sample) items, pixel
    major.

    Returns (lane keys (R, 2), origins, directions, in_range (R,)
    bool: False for the padded samples of the final chunk).
    """
    sample_ids = sample_offset + torch.arange(spp_chunk, dtype=torch.int64,
                                              device=pix.device)
    lkeys, o, d = camera_lanes(
        cam, base_key, torch.repeat_interleave(pix, spp_chunk),
        sample_ids.repeat(pix.shape[0]), width=width, height=height,
        spp_total=spp_total)
    in_range = (sample_ids[None, :] < spp_total).expand(pix.shape[0], spp_chunk)
    return lkeys, o, d, in_range.reshape(-1)


def trace_pixel_lanes(scene, cam: Camera, base_key, pix, sample_offset: int,
                      background, *, width: int, height: int, spp_chunk: int,
                      spp_total: int, max_bounces: int,
                      rr_start: Optional[int], differentiable: bool = False,
                      remat: Optional[str] = None):
    """Trace len(pix)*spp_chunk lanes for the given pixel ids.
    Returns (sum_radiance (len(pix), 3), stats)."""
    npix = pix.shape[0]
    lkeys, o, d, in_range = _make_lanes(
        cam, base_key, pix, sample_offset, width=width, height=height,
        spp_chunk=spp_chunk, spp_total=spp_total,
    )
    rad, stats = trace(scene, o, d, lkeys, background,
                       max_bounces=max_bounces, russian_roulette_start=rr_start,
                       differentiable=differentiable, remat=remat)
    # mask samples beyond spp_total (padded final chunk)
    rad = rad * in_range.to(torch.float32)[:, None]
    return rad.reshape(npix, spp_chunk, 3).sum(dim=1), stats


def _render_chunk(scene, cam: Camera, base_key, sample_offset: int,
                  background, *, width: int, height: int, spp_chunk: int,
                  spp_total: int, max_bounces: int, rr_start: Optional[int],
                  differentiable: bool = False, remat: Optional[str] = None):
    """Trace width*height*spp_chunk lanes on the scene's device;
    returns (sum_radiance (H*W, 3), stats)."""
    pix = torch.arange(width * height, dtype=torch.int64, device=scene.device)
    return trace_pixel_lanes(
        scene, cam, base_key, pix, sample_offset, background,
        width=width, height=height, spp_chunk=spp_chunk,
        spp_total=spp_total, max_bounces=max_bounces, rr_start=rr_start,
        differentiable=differentiable, remat=remat,
    )


def _render_frame(scene, cam, settings: RenderSettings, key, bg, spp: int,
                  chunk: int):
    """One full frame, chunk by chunk; returns (img (H, W, 3), stats)."""
    dev = scene.device
    acc = torch.zeros((settings.width * settings.height, 3),
                      dtype=torch.float32, device=dev)
    total_segments = torch.zeros((), dtype=torch.float32, device=dev)
    total_bounces = 0
    total_occ = torch.zeros(MAX_BOUNCE_STATS, dtype=torch.float32, device=dev)
    for s0 in range(0, spp, chunk):
        part, stats = _render_chunk(
            scene, cam, key, s0, bg,
            width=settings.width, height=settings.height,
            spp_chunk=chunk, spp_total=spp,
            max_bounces=settings.max_bounces,
            rr_start=settings.russian_roulette_start,
            differentiable=settings.differentiable, remat=settings.remat,
        )
        acc = acc + part
        total_segments = total_segments + stats.segments
        total_bounces += stats.bounces
        total_occ = total_occ + stats.occupancy

    img = (acc / torch.tensor(float(spp), dtype=torch.float32, device=dev)
           ).reshape(settings.height, settings.width, 3)
    return img, TraceStats(segments=total_segments, bounces=total_bounces,
                           occupancy=total_occ)


def render_radiance(scene, cam: Camera, settings: RenderSettings, key,
                    background=None, *, device):
    """Linear-space mean radiance image (H, W, 3) + TraceStats, rendered
    on ``device``.  ``key`` is the (2,) raw key (``sampling.prng_key``);
    scene, camera and key are moved to ``device``.  With
    ``settings.differentiable`` the image carries gradients to the
    scene's texture colours and image texels, the camera's tensors and
    ``background``.  A differentiable render ignores ``cascade`` and
    ``cascade_schedule``, as the JAX package's does (render.py:830-835);
    a forward render with either raises: the cascade renderer is not
    ported."""
    if (settings.cascade or settings.cascade_schedule is not None) and \
            not settings.differentiable:
        raise NotImplementedError(
            "the cascade renderer is not ported yet (ROADMAP queue 1 item 11)")
    dev = resolve_device(device)
    scene, cam = scene.to(dev), cam.to(dev)
    key = torch.as_tensor(key, dtype=torch.int64, device=dev)
    bg = torch.as_tensor(
        settings.background if background is None else background,
        dtype=torch.float32, device=dev,
    )
    return _render_frame(scene, cam, settings, key, bg,
                         settings.samples_per_pixel, settings.resolve_chunk())


def render_image(scene, cam: Camera, settings: RenderSettings, key, *, device):
    """Render to gamma-2 RGB8 (renderer.rs:30-33 + vec3.rs:278-291)."""
    from rust_pathtracer_tpu_torch.utils.image import to_rgb8

    img, stats = render_radiance(scene, cam, settings, key, device=device)
    return to_rgb8(img.cpu().numpy()), stats

