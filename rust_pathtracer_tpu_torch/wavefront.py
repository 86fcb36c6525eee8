"""Regeneration wavefront renderer: a lane pool refilled from the work queue.

Counterpart of ``rust_pathtracer_tpu/wavefront.py``; plain tensor code
around the kernels.

The chunked renderer (``render.py``) traces width * height * spp_chunk
lanes in lockstep until all of them die; in a deep-bounce scene with a
black background (LightTest: 50 bounces) most lanes die within a few
bounces and the rest hold the chunk open.  Here a fixed pool of lanes
stays occupied: a lane whose path ended takes the next (pixel, sample)
work item.  Every ``FLUSH_EVERY`` bounces a window ends: the finished
lanes' radiance goes into the image, and each of them takes a work item
and spawns its camera ray.

Each lane carries its own path depth, and its draws are those of the
chunked renderer for the same (pixel, sample) at that depth, so a path
computes the same radiance in either renderer; only the order of the
per-pixel sums differs.  The bounce runs on the scene's route, as
``integrator.trace`` picks it:

* **fused** (``fused_bounce_ok``): one launch of the keyed K1 at
  per-lane depth (``ops/fused_bounce.py``), which draws at each lane's
  depth and applies roulette where that depth is ``rr_start`` or more;
* **generic** (image textures, nested checkers, more than 128
  primitives): ``integrator.search_and_record`` (K3, or K6 / K7 / K5 on
  the projected tables), the draw kernel at per-lane depth
  (``ops/draws.py``), the tensor-op shading and per-lane roulette.

Then the depth cap kills the lanes at ``max_bounces``.  On the fused
route K1 commits the state of a lane the cap kills (roulette included);
that lane is dead, and nothing reads a dead lane's origin, direction or
throughput again (the flush reads radiance, a respawn overwrites), so
the image does not change.

Work handout (``mode``): "queue": the finished lanes take
the next work ids in lane order (JAX's exclusive cumsum: a finished
lane's rank among the finished lanes is its slot) and their radiance is
added into the image each window; "stripe": each lane owns a
pixel-aligned run of consecutive ids of one pixel, banks its radiance
lane-locally, and the image takes one flush at the end.  The radiance
flush is ``index_put_(accumulate=True)``, which adds in a fixed order on
the card as on the CPU (a sort by pixel, then each pixel's values in
turn), so one key gives the same image bit for bit; never
``index_add_``, whose CUDA adds are atomics.

Not ported: the between-bounce reorder of big scenes (it changes no
per-lane result), the "none" flush (a biased probe) and the JAX
package's environment knobs: ``RPT_REGEN_MODE`` is the ``mode``
argument, ``RPT_FLUSH_EVERY`` the constant ``FLUSH_EVERY`` (JAX's
default) and ``RPT_REGEN_FLUSH`` goes with the "none" flush.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from rust_pathtracer_tpu_torch.camera import Camera
from rust_pathtracer_tpu_torch.integrator import (
    MAX_BOUNCE_STATS,
    T_MIN,
    TraceStats,
    _bounce_tail,
    _call,
    search_and_record,
)
from rust_pathtracer_tpu_torch.ops.closest_hit import pack_prims
from rust_pathtracer_tpu_torch.ops.draws import bounce_draws
from rust_pathtracer_tpu_torch.ops.fused_bounce import (
    fused_bounce_keyed,
    fused_bounce_ok,
    key_words,
    pack_prims_shaded,
)
from rust_pathtracer_tpu_torch.render import RenderSettings, camera_lanes, resolve_device

MODES = ("queue", "stripe")
# bounces a window: a flush and refill after every second bounce
FLUSH_EVERY = 2


def _stripe_len(total: int, spp: int, lanes: int):
    """Pixel-aligned stripe length for the stripe mode: the smallest
    divisor of spp >= ceil(total / lanes), or None when no single-pixel
    stripe covers the pool (lanes < npix)."""
    k0 = -(-total // lanes)
    if k0 > spp:
        return None
    for k in range(k0, spp + 1):
        if spp % k == 0:
            return k
    return None


@dataclasses.dataclass
class _Frame:
    """What a render's lanes share: the scene and its route, the camera,
    the key and the work queue's shape."""

    scene: object
    table: torch.Tensor
    fused: bool
    cam: Camera
    key: torch.Tensor
    bg: torch.Tensor
    width: int
    height: int
    spp: int
    max_bounces: int
    rr_start: Optional[int]
    stripe: bool

    @property
    def npix(self):
        return self.width * self.height

    @property
    def roulette(self):
        return self.rr_start is not None and self.rr_start < self.max_bounces


@dataclasses.dataclass
class _Pool:
    """The lane pool.  ``state`` (13, R) f32 rows (o, d, thr, rad, alive;
    ``fused_bounce._COL_KEYS``), ``keys`` (2, R) int32 key words,
    ``depth`` (R,) int32 path depth, ``work`` (R,) int32 work id (-1: idle),
    ``pixel`` (R,) int64; stripe mode: ``nxt`` / ``send`` (R,) int32, the
    rest of the lane's stripe [nxt, send), ``acc_lane`` (R, 3) its banked
    radiance."""

    state: torch.Tensor
    keys: torch.Tensor
    depth: torch.Tensor
    work: torch.Tensor
    pixel: torch.Tensor
    nxt: Optional[torch.Tensor] = None
    send: Optional[torch.Tensor] = None
    acc_lane: Optional[torch.Tensor] = None


def _spawn(fr: _Frame, wid: torch.Tensor):
    """Camera lanes for work ids ``wid`` (int64, >= 0), the chunked
    renderer's lane of the same (pixel, sample) (JAX ``spawn``,
    :148-171).  Returns (pixel (n,) int64, key words (2, n), state
    (13, n): the camera ray, throughput 1, radiance 0, alive)."""
    if fr.stripe:  # pixel-major ids: a stripe is one pixel's samples
        pixel, sample = wid // fr.spp, wid % fr.spp
    else:
        pixel, sample = wid % fr.npix, wid // fr.npix
    lkeys, o, d = camera_lanes(fr.cam, fr.key, pixel, sample, width=fr.width,
                               height=fr.height, spp_total=fr.spp)
    ones = torch.ones_like(o[:, 0])
    zeros = torch.zeros_like(ones)
    state = torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                         ones, ones, ones, zeros, zeros, zeros, ones])
    return pixel, key_words(lkeys), state


def _respawn(fr: _Frame, pool: _Pool, take: torch.Tensor, wid: torch.Tensor):
    """Lanes ``take`` (ascending lane indices) start work items ``wid``:
    only they spawn (JAX spawns the whole pool and selects, the same
    bits; chip_smoke.py phase 21 times both)."""
    pixel, keys, state = _spawn(fr, wid)
    pool.pixel[take] = pixel
    pool.keys[:, take] = keys
    pool.state[:, take] = state
    pool.depth[take] = 0
    pool.work[take] = wid.to(torch.int32)


def _bounce_generic(fr: _Frame, state, keys, depth):
    """One generic bounce at per-lane depth (JAX :300-331): the search and
    record, the draws at each lane's depth, the shading, then roulette on
    the lanes at depth ``rr_start`` or more.  Returns the (13, R) state."""
    o, d, thr, rad = (state[k:k + 3].T.contiguous() for k in (0, 3, 6, 9))
    alive = state[12] > 0.5
    hit, rec, shade_row = search_and_record(fr.scene, fr.table, o, d, alive)
    su, bu, coin, rl = bounce_draws(keys, depth, fr.roulette)
    o, d, thr, rad, cont = _bounce_tail(
        fr.scene, (o, d, thr, rad, alive), hit, rec,
        dict(sphere_u=su, ball_u=bu, coin=coin), fr.bg, rl, _call, shade_row,
        rr_sel=depth >= fr.rr_start if fr.roulette else None)
    return torch.cat([o.T, d.T, thr.T, rad.T, cont.to(torch.float32)[None]])


def _bounce(fr: _Frame, pool: _Pool):
    """One bounce of the live lanes (JAX ``bounce``, :254-339): each draws
    at its own depth; then ``depth += alive`` and the depth cap.  Finished
    lanes keep their radiance (alive 0, work id kept) until the flush.
    Returns the segments traced, a (,) f32 tensor."""
    alive = pool.state[12] > 0.5
    n_alive = alive.sum(dtype=torch.float32)
    if fr.fused:
        state = fused_bounce_keyed(
            fr.table, fr.bg, fr.scene.textures.perlin_seed, pool.state, pool.keys,
            pool.depth, with_roulette=fr.roulette, rr_start=fr.rr_start or 0,
            kinds=fr.scene.kinds_static, mat_types=fr.scene.mat_types,
            tex_types=fr.scene.tex_types, t_min=T_MIN)
    else:
        state = _bounce_generic(fr, pool.state, pool.keys, pool.depth)
    pool.depth = pool.depth + alive.to(torch.int32)
    state[12].masked_fill_(pool.depth >= fr.max_bounces, 0.0)
    pool.state = state
    return n_alive


def _depth_hist(depth):
    """Counts of finished lanes by (clamped) path length, f32."""
    d = depth.clamp(max=MAX_BOUNCE_STATS - 1).to(torch.int64)
    return torch.bincount(d, minlength=MAX_BOUNCE_STATS).to(torch.float32)


def _flush_refill(fr: _Frame, pool: _Pool, acc, hist, issued: int, total: int):
    """Queue mode's window end (JAX ``flush_refill``, :374-409): the
    finished lanes' radiance into ``acc`` and their lengths into
    ``hist``; each takes the next work id, in lane order, while the queue
    lasts.  Returns (hist, issued, lanes that took work)."""
    finished = (pool.state[12] <= 0.5) & (pool.work >= 0)
    fin = torch.nonzero(finished).squeeze(1)  # ascending: each lane's queue slot
    hist = hist + _depth_hist(pool.depth[fin])
    acc.index_put_((pool.pixel[fin],), pool.state[9:12, fin].T, accumulate=True)
    n_take = min(fin.shape[0], total - issued)
    pool.work[fin[n_take:]] = -1
    if n_take:
        wid = torch.arange(issued, issued + n_take, dtype=torch.int64,
                           device=fin.device)
        _respawn(fr, pool, fin[:n_take], wid)
    return hist, issued + n_take, n_take


def _advance_stripe(fr: _Frame, pool: _Pool, hist):
    """Stripe mode's window end (JAX ``advance_stripe``, :411-439): the
    finished lanes bank their radiance lane-locally and start the next
    sample of their stripe.  Returns (hist, lanes that took work)."""
    finished = (pool.state[12] <= 0.5) & (pool.work >= 0)
    fin = torch.nonzero(finished).squeeze(1)
    hist = hist + _depth_hist(pool.depth[fin])
    pool.acc_lane[fin] = pool.acc_lane[fin] + pool.state[9:12, fin].T
    pool.work[fin] = -1
    take = fin[pool.nxt[fin] < pool.send[fin]]
    if take.shape[0]:
        wid = pool.nxt[take].to(torch.int64)
        pool.nxt[take] += 1
        _respawn(fr, pool, take, wid)
    return hist, take.shape[0]


def render_radiance_regen(scene, cam: Camera, settings: RenderSettings, key,
                          lanes: Optional[int] = None, mode: str = "queue", *,
                          device):
    """Linear radiance image (H, W, 3) and TraceStats via the regeneration
    wavefront, rendered on ``device`` (scene, camera and key are moved
    there).  The same estimator as ``render.render_radiance`` on the same
    key; the per-pixel sums are added in another order.

    ``lanes``: the pool, default min(total, 2**20), total = width *
    height * spp.  ``mode``: "queue" or "stripe" (see the module
    docstring; the pool is then one lane a stripe).
    ``TraceStats.bounces`` counts the loop's bounce iterations,
    ``occupancy[b]`` the paths longer than b.

    Forward only: a differentiable ``settings`` raises, as does a
    non-positive pool, total >= 2**31 (work ids are int32) and "stripe"
    where no pixel-aligned stripe covers the pool.
    """
    if settings.differentiable:
        raise NotImplementedError(
            "the regen wavefront is forward only (JAX's while_loop has no "
            "gradient); render_radiance renders differentiably")
    width, height = settings.width, settings.height
    spp = settings.samples_per_pixel
    total = width * height * spp
    lanes = min(total, 1 << 20) if lanes is None else int(min(lanes, total))
    if lanes <= 0:
        raise ValueError(f"lane pool must be positive, got {lanes}")
    if total >= 2 ** 31:
        raise ValueError(
            f"regen wavefront work queue is int32-indexed: width*height*spp = "
            f"{total} >= 2**31; use render_radiance for this size")
    if mode not in MODES:
        raise ValueError(f"regen mode {mode!r}, want one of {MODES}")
    stripe_k = _stripe_len(total, spp, lanes)
    if mode == "stripe" and stripe_k is None:
        raise ValueError(
            f"stripe mode needs a pixel-aligned stripe: spp={spp} has no divisor "
            f">= ceil(total/lanes)={-(-total // lanes)}")
    stripe = mode == "stripe"
    if stripe:
        lanes = total // stripe_k  # one lane a stripe

    dev = resolve_device(device)
    scene, cam = scene.to(dev), cam.to(dev)
    fused = fused_bounce_ok(scene)
    if fused:
        table = pack_prims_shaded(scene)
    else:
        table = scene.proj if scene.kinds_static is None else pack_prims(scene.prims)
    fr = _Frame(scene=scene, table=table, fused=fused, cam=cam,
                key=torch.as_tensor(key, dtype=torch.int64, device=dev),
                bg=torch.as_tensor(settings.background, dtype=torch.float32, device=dev),
                width=width, height=height, spp=spp,
                max_bounces=settings.max_bounces,
                rr_start=settings.russian_roulette_start, stripe=stripe)

    init = torch.arange(lanes, dtype=torch.int64, device=dev) * (stripe_k if stripe else 1)
    pixel, keys, state = _spawn(fr, init)
    pool = _Pool(state=state, keys=keys, depth=torch.zeros(lanes, dtype=torch.int32,
                                                           device=dev),
                 work=init.to(torch.int32), pixel=pixel)
    if stripe:
        pool.nxt = (init + 1).to(torch.int32)
        pool.send = (init + stripe_k).to(torch.int32)
        pool.acc_lane = torch.zeros((lanes, 3), dtype=torch.float32, device=dev)
    acc = torch.zeros((fr.npix, 3), dtype=torch.float32, device=dev)
    hist = torch.zeros(MAX_BOUNCE_STATS, dtype=torch.float32, device=dev)
    segments = torch.zeros((), dtype=torch.float32, device=dev)
    issued, iters = lanes, 0
    while True:  # every lane is alive entering the first window
        for _ in range(FLUSH_EVERY):
            segments = segments + _bounce(fr, pool)
            iters += 1
        if stripe:
            hist, n_take = _advance_stripe(fr, pool, hist)
        else:
            hist, issued, n_take = _flush_refill(fr, pool, acc, hist, issued, total)
        # no lane is pending after a flush: the loop ends once none is alive
        if n_take == 0 and not bool((pool.state[12] > 0.5).any()):
            break
    if stripe:
        acc.index_put_((pool.pixel,), pool.acc_lane, accumulate=True)

    img = (acc / torch.tensor(float(spp), dtype=torch.float32, device=dev)
           ).reshape(height, width, 3)
    # path lengths -> per-bounce occupancy: a path of length L traced a
    # segment at bounces 0 .. L-1, so occupancy[b] = paths longer than b
    suffix = torch.flip(torch.cumsum(torch.flip(hist, (0,)), 0), (0,))
    occupancy = torch.cat([suffix[1:], torch.zeros(1, dtype=torch.float32, device=dev)])
    return img, TraceStats(segments=segments, bounces=iters, occupancy=occupancy)
