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

The cascade renderer (``cascade`` / ``cascade_schedule``, forward
only) traces the first bounces at full width, then compacts: a stable
partition puts the live lanes first in their order, the finished
lanes' radiance is banked at their caller lane index, and
``integrator.trace_resume`` continues on the live slice.  Every lane
traces the path it traces in the chunked renderer, and the per-pixel
sums run over the banked lanes in caller order, so a cascade render
equals the chunked one bit for bit (image, segments, occupancy).  The
JAX package sorts instead (XLA has no cheap scatter); the port does not
copy that.  Schedules, their parser, the occupancy probe behind
``"auto"`` and the overflow guard are the JAX package's.  Its
environment knobs (``RPT_CASCADE``, ``RPT_CASCADE_B1``,
``RPT_CASCADE_STATIC``, ``RPT_CASCADE_PRESORT``, ``RPT_REORDER_KEY``)
are not ported: settings and arguments select everything.  The
pass-set reorder a ``"1:1"`` boundary stands for in JAX is not ported
either (ROADMAP queue 1, item 11's remainder); here that boundary is a full-width
compaction.
"""

from __future__ import annotations

import dataclasses
import warnings
from fractions import Fraction
from typing import Optional, Tuple

import numpy as np
import torch

from rust_pathtracer_tpu_torch import sampling
from rust_pathtracer_tpu_torch.camera import Camera, camera_rays
from rust_pathtracer_tpu_torch.integrator import (
    MAX_BOUNCE_STATS,
    TraceStats,
    trace,
    trace_resume,
)


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
    # compact the wavefront once lanes die (forward only; a
    # differentiable render ignores both): ``cascade`` alone is the
    # dynamic cascade (one host sync a boundary); ``cascade_schedule``
    # a static "boundary:shrink,..." schedule (fixed widths, no sync,
    # dropped live lanes counted in occupancy[-1]) or "auto" (derived
    # from a 1-spp probe, ``derive_cascade_schedule``); a schedule
    # implies ``cascade``
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


# ---------------------------------------------------------------------------
# the cascade renderer
# ---------------------------------------------------------------------------

CASCADE_B1 = 3  # the dynamic cascade's boundary
_CASCADE_SHRINKS = (32, 16, 8, 4, 2, 1)
# "auto": slice widths hug AUTO_MARGIN x the live count of a 1-spp probe
# over ~AUTO_PROBE_TARGET strided pixels; the renderer owns the
# overflow guard, so the margin may sit near 1
AUTO_MARGIN = 1.35
AUTO_PROBE_TARGET = 1 << 16
# a derived schedule starts with JAX's "1:1" boundary on scenes of this
# many projected clusters or more, so the string is JAX's (in the port a
# full-width compaction)
REORDER_CLUSTER_MIN = 32


class CascadeOverflowError(RuntimeError):
    """A static cascade slice dropped live lanes (occupancy[-1] > 0): the
    image would come out darkened by the missing paths.  Widen the
    schedule (smaller shrinks, later boundaries) or use
    ``cascade_schedule="auto"``, which derives safe widths and widens
    them on overflow."""


def parse_cascade_schedule(raw):
    """Parse a "b:s,b:s" schedule into [(boundary, shrink)].

    ``shrink`` is an integer divisor or a rational "num/den" ("1:16/11"
    keeps 11/16 of the lanes); shrinks come back as Fractions, and
    boundaries and shrinks must both strictly increase.  Raises
    ValueError on malformed input (the CLI validates with it)."""
    out = []
    prev_b, prev_s = 0, Fraction(0)
    for part in raw.split(","):
        try:
            b_str, s_str = part.split(":")
            b = int(b_str)
            if "/" in s_str:
                num, den = s_str.split("/")
                s = Fraction(int(num), int(den))
            else:
                s = Fraction(int(s_str))
        except (ValueError, ZeroDivisionError):
            raise ValueError(
                f"cascade schedule entry {part!r} is not 'bounce:shrink' "
                "(shrink: int or num/den)"
            ) from None
        if s < 1:
            raise ValueError(f"cascade shrink must be >= 1, got {part!r}")
        if b <= prev_b:
            raise ValueError(f"cascade boundaries must increase, got {raw!r}")
        if s <= prev_s:
            raise ValueError(f"cascade shrinks must increase, got {raw!r}")
        out.append((b, s))
        prev_b, prev_s = b, s
    return out


def _cascade_static_schedule(max_bounces, n_lanes, settings_schedule=None):
    """Resolve "5:8,9:16" to [(boundary, width)] for ``n_lanes`` lanes.
    Returns [] when unset, malformed or inapplicable (a width that is
    not a whole number of lanes, a boundary at or past ``max_bounces``,
    or ``max_bounces`` reaching the occupancy guard slot): the caller
    then runs the dynamic cascade."""
    if not settings_schedule or max_bounces >= MAX_BOUNCE_STATS - 1:
        return []
    try:
        pairs = parse_cascade_schedule(settings_schedule)
    except ValueError:
        return []
    out = []
    for b, shrink in pairs:
        num, den = shrink.numerator, shrink.denominator
        if not (b < max_bounces and (n_lanes * den) % num == 0
                and (n_lanes * den) // num >= 1):
            return []
        out.append((b, (n_lanes * den) // num))
    return out


def _derive_cascade_schedule(occupancy, n_lanes, max_bounces, *,
                             margin=AUTO_MARGIN, max_stages=4):
    """A static schedule from an occupancy histogram (``occupancy[b]``:
    lanes alive entering bounce b, scaled to ``n_lanes``).  Each
    boundary's width is ``margin`` x the live count rounded up to 128
    lanes; the first boundary lands where that is at most 60% of the
    lanes, each later one where it drops another 1.4x, up to
    ``max_stages``.  Returns a "b:s,..." string, or None when no
    boundary pays (the JAX package's rules, DESIGN.md section 11)."""
    nb = min(int(max_bounces), len(occupancy) - 1)
    stages = []
    cur = n_lanes
    for b in range(1, nb):
        alive = float(occupancy[b])
        w = int(-(-max(margin * alive, 128.0) // 128.0) * 128)
        emit = w <= (0.6 * n_lanes if not stages else cur / 1.4)
        if emit and len(stages) < max_stages:
            f = Fraction(n_lanes, w)
            s = (str(f.numerator) if f.denominator == 1
                 else f"{f.numerator}/{f.denominator}")
            stages.append(f"{b}:{s}")
            cur = w
    return ",".join(stages) if stages else None


def _maybe_prepend_reorder(sched, scene):
    """JAX's "1:1" first boundary on scenes of REORDER_CLUSTER_MIN
    projected clusters or more."""
    if not sched:
        return sched
    first_b = int(sched.split(",")[0].split(":")[0])
    if (scene.proj is not None
            and scene.proj.cluster_bounds.shape[1] >= REORDER_CLUSTER_MIN
            and first_b > 1):
        return "1:1," + sched
    return sched


def derive_cascade_schedule(scene, cam, settings, key, background=None, *,
                            margin=AUTO_MARGIN, device):
    """A static cascade schedule from a 1-spp probe render over about
    AUTO_PROBE_TARGET strided pixels on the plain path; deterministic
    for a given (scene, camera, settings, key), so a resumed or repeated
    render derives the same string.  Returns a schedule string or None
    when no boundary pays."""
    return derive_cascade_schedule_multi(scene, [cam], settings, key, background,
                                         margin=margin, device=device)


def derive_cascade_schedule_multi(scene, cams, settings, key, background=None,
                                  *, margin=AUTO_MARGIN, device):
    """One probe a camera pose; the schedule comes from the per-bounce
    maximum of their occupancy histograms, so one schedule serves every
    pose probed.  The probe's lane counters take ``spp_total = 1``, so
    the schedule does not depend on the render's sample count."""
    if not cams:
        raise ValueError(
            "derive_cascade_schedule_multi: need at least one camera pose to "
            "probe (got an empty cams list)")
    dev = resolve_device(device)
    scene = scene.to(dev)
    key = torch.as_tensor(key, dtype=torch.int64, device=dev)
    bg = torch.as_tensor(settings.background if background is None else background,
                         dtype=torch.float32, device=dev)
    npix = settings.width * settings.height
    stride = max(1, npix // AUTO_PROBE_TARGET)
    pix = torch.arange(0, npix, stride, dtype=torch.int64, device=dev)
    occ = None
    for cam in cams:
        _, stats = trace_pixel_lanes(
            scene, cam.to(dev), key, pix, 0, bg, width=settings.width,
            height=settings.height, spp_chunk=1, spp_total=1,
            max_bounces=settings.max_bounces, rr_start=settings.russian_roulette_start)
        o = stats.occupancy.cpu().numpy()
        occ = o if occ is None else np.maximum(occ, o)
    n_lanes = npix * settings.resolve_chunk()
    sched = _derive_cascade_schedule(occ * (n_lanes / float(pix.shape[0])), n_lanes,
                                     settings.max_bounces, margin=margin)
    return _maybe_prepend_reorder(sched, scene)


def _live_first(alive):
    """The stable partition of the lanes, live ones first: a permutation
    (R,) int64 that keeps each side's order.  No host sync."""
    live = alive.to(torch.int64)
    n_live = live.sum()
    pos = torch.where(alive, torch.cumsum(live, 0) - 1,
                      n_live + torch.cumsum(1 - live, 0) - 1)
    perm = torch.empty_like(pos)
    perm[pos] = torch.arange(pos.shape[0], dtype=torch.int64, device=pos.device)
    return perm


def _render_chunk_cascaded(scene, cam: Camera, base_key, sample_offset: int,
                           background, *, width: int, height: int,
                           spp_chunk: int, spp_total: int, max_bounces: int,
                           rr_start: Optional[int], schedule=None):
    """One sample chunk through the cascade; returns (sum_radiance (H*W,
    3), stats), as ``_render_chunk``.

    Static (``schedule`` applies, ``_cascade_static_schedule``): the
    slice after each boundary has the schedule's fixed width, with no
    host sync; live lanes that do not fit are dropped and counted into
    ``occupancy[-1]``, which the caller must find zero.  Dynamic (no
    static schedule): one boundary at CASCADE_B1, where one host sync
    reads the live count and the slice takes JAX's shrink rule: the
    largest exact divisor in ``_CASCADE_SHRINKS`` that keeps max(live,
    128) lanes.

    Padded lanes of a final chunk (sample >= spp_total) start dead, as
    in the JAX package, so they add no segments there."""
    R = width * height * spp_chunk
    stages = _cascade_static_schedule(max_bounces, R, schedule)
    static = bool(stages)
    if not static:
        stages = [(CASCADE_B1, None)] if 0 < CASCADE_B1 < max_bounces else []
    pix = torch.arange(width * height, dtype=torch.int64, device=scene.device)
    lkeys, o, d, alive = _make_lanes(cam, base_key, pix, sample_offset, width=width,
                                     height=height, spp_chunk=spp_chunk,
                                     spp_total=spp_total)
    dev = o.device
    thr = torch.ones((R, 3), dtype=torch.float32, device=dev)
    rad = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    lane = torch.arange(R, dtype=torch.int64, device=dev)
    banked = torch.zeros((R, 3), dtype=torch.float32, device=dev)
    segments = torch.zeros((), dtype=torch.float32, device=dev)
    occupancy = torch.zeros(MAX_BOUNCE_STATS, dtype=torch.float32, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    bounces = 0
    b0 = 0
    for b1, width_s in stages + [(max_bounces, None)]:
        st, n = trace_resume(scene, o, d, thr, rad, alive, lkeys, background, b0, b1,
                             rr_start, segments=segments, occupancy=occupancy)
        bounces += n
        segments, occupancy = st["segments"], st["occupancy"]
        alive = st["alive"]
        if b1 == max_bounces:
            banked[lane] = st["rad"]
            break
        # bank the finished lanes at their caller index; a live lane's
        # slot stays zero until it finishes (and stays zero if dropped)
        banked[lane] = torch.where(alive[:, None], 0.0, st["rad"])
        perm = _live_first(alive)
        if static:
            overflow += torch.clamp(alive.sum() - width_s, min=0)
        else:
            n_live, W = int(alive.sum()), alive.shape[0]  # host sync
            width_s = W
            for f in _CASCADE_SHRINKS:
                if W // f >= max(n_live, 128) and (W // f) * f == W:
                    width_s = W // f
                    break
        keep = perm[:width_s]
        o, d, thr, rad = st["o"][keep], st["d"][keep], st["thr"][keep], st["rad"][keep]
        alive, lkeys, lane = alive[keep], lkeys[keep], lane[keep]
        b0 = b1
    if static:
        occupancy[-1] += overflow.to(torch.float32)
    acc = banked.reshape(width * height, spp_chunk, 3).sum(dim=1)
    return acc, TraceStats(segments=segments, bounces=bounces, occupancy=occupancy)


def _render_frame(scene, cam, settings: RenderSettings, key, bg, spp: int,
                  chunk: int, *, cascade: bool = False, schedule=None):
    """One full frame, chunk by chunk, at a resolved schedule (never
    "auto"); returns (img (H, W, 3), stats, used_static), where
    ``used_static`` says that the static cascade ran, so that
    occupancy[-1] is its overflow count."""
    dev = scene.device
    used_static = cascade and bool(_cascade_static_schedule(
        settings.max_bounces, settings.width * settings.height * chunk, schedule))
    acc = torch.zeros((settings.width * settings.height, 3),
                      dtype=torch.float32, device=dev)
    total_segments = torch.zeros((), dtype=torch.float32, device=dev)
    total_bounces = 0
    total_occ = torch.zeros(MAX_BOUNCE_STATS, dtype=torch.float32, device=dev)
    args = dict(width=settings.width, height=settings.height, spp_chunk=chunk,
                spp_total=spp, max_bounces=settings.max_bounces,
                rr_start=settings.russian_roulette_start)
    for s0 in range(0, spp, chunk):
        if cascade:
            part, stats = _render_chunk_cascaded(scene, cam, key, s0, bg,
                                                 schedule=schedule, **args)
        else:
            part, stats = _render_chunk(
                scene, cam, key, s0, bg, differentiable=settings.differentiable,
                remat=settings.remat, **args)
        acc = acc + part
        total_segments = total_segments + stats.segments
        total_bounces += stats.bounces
        total_occ = total_occ + stats.occupancy

    img = (acc / torch.tensor(float(spp), dtype=torch.float32, device=dev)
           ).reshape(settings.height, settings.width, 3)
    return img, TraceStats(segments=total_segments, bounces=total_bounces,
                           occupancy=total_occ), used_static


def uses_cascade(settings: RenderSettings) -> bool:
    """Whether a render with ``settings`` takes the cascade: ``cascade``
    or a schedule, and not differentiable."""
    return ((settings.cascade or settings.cascade_schedule is not None)
            and not settings.differentiable)


def render_radiance(scene, cam: Camera, settings: RenderSettings, key,
                    background=None, *, device):
    """Linear-space mean radiance image (H, W, 3) + TraceStats, rendered
    on ``device``.  ``key`` is the (2,) raw key (``sampling.prng_key``);
    scene, camera and key are moved to ``device``.  With
    ``settings.differentiable`` the image carries gradients to the
    scene's texture colours and image texels, the camera's tensors and
    ``background``; a differentiable render ignores ``cascade`` and
    ``cascade_schedule``, as the JAX package's does (render.py:830-835).

    The cascade's overflow guard is the renderer's: an explicit static
    schedule that drops live lanes (occupancy[-1] > 0) raises
    CascadeOverflowError instead of returning a darkened image; under
    "auto" the schedule is derived from a probe (``derive_cascade_schedule``)
    and, on overflow, derived again at double the margin and rendered
    again, three attempts in all, then the frame renders on the plain
    chunked path.  One occupancy read a frame."""
    dev = resolve_device(device)
    scene, cam = scene.to(dev), cam.to(dev)
    key = torch.as_tensor(key, dtype=torch.int64, device=dev)
    bg = torch.as_tensor(
        settings.background if background is None else background,
        dtype=torch.float32, device=dev,
    )
    spp, chunk = settings.samples_per_pixel, settings.resolve_chunk()
    cascade = uses_cascade(settings)
    auto = cascade and settings.cascade_schedule == "auto"
    margin = AUTO_MARGIN
    for _ in range(3 if auto else 1):
        if auto:
            sched = derive_cascade_schedule(scene, cam, settings, key, background,
                                            margin=margin, device=dev)
            use_cascade = sched is not None
        else:
            sched, use_cascade = settings.cascade_schedule, cascade
        img, stats, used_static = _render_frame(scene, cam, settings, key, bg, spp,
                                                chunk, cascade=use_cascade,
                                                schedule=sched)
        overflow = float(stats.occupancy[-1]) if used_static else 0.0
        if overflow == 0.0:
            return img, stats
        if not auto:
            raise CascadeOverflowError(
                f"static cascade schedule {sched!r} dropped {overflow:.0f} live "
                "lanes (occupancy[-1] > 0): the image is biased.  Widen the "
                "schedule or use cascade_schedule='auto'.")
        warnings.warn(
            f"auto cascade schedule {sched!r} dropped {overflow:.0f} live lanes: "
            f"deriving again at margin {margin * 2:g} and rendering again",
            stacklevel=2)
        margin *= 2.0
    warnings.warn("auto cascade schedule still overflowed after widening: "
                  "rendering the plain chunked path", stacklevel=2)
    img, stats, _ = _render_frame(scene, cam, settings, key, bg, spp, chunk)
    return img, stats


def render_image(scene, cam: Camera, settings: RenderSettings, key, *, device):
    """Render to gamma-2 RGB8 (renderer.rs:30-33 + vec3.rs:278-291)."""
    from rust_pathtracer_tpu_torch.utils.image import to_rgb8

    img, stats = render_radiance(scene, cam, settings, key, device=device)
    return to_rgb8(img.cpu().numpy()), stats

