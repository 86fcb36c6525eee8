"""Iterative wavefront integrator: the bounce loops.

Counterpart of ``rust_pathtracer_tpu/integrator.py``; plain tensor code
around the kernels.

The reference integrator is the recursive ``Ray::color``
(ray.rs:20-41).  The wavefront form carries (origin, direction,
throughput, radiance, alive) for every lane and peels one bounce per
iteration:

    radiance += throughput * emitted            (hit lanes)
    radiance += throughput * background         (miss lanes; lane dies)
    throughput *= attenuation                   (scatter lanes)

Two routes, chosen per scene as in the JAX package:

* **fused**, for the scenes ``fused_bounce_ok`` admits (and, when
  differentiable, ``fused_bounce_diff_ok``): the state as one (13, R)
  tensor and one launch of the keyed K1 a bounce
  (``ops/fused_bounce.py``), which draws the bounce's uniforms from the
  lane keys and applies roulette itself; the differentiable loop is the
  whole-scan ``autograd.Function`` ``fused_scan_trace`` (keyed K1 with
  residuals forward, K2 backward);
* **generic**, for every other scene (image textures, nested
  checkers, perlin when differentiable, and every scene of more than
  128 primitives): ``_bounce_step`` on (R, 3) tensors.  The search is a
  kernel.  Up to 128 primitives: K3 (search and hit record) when not
  differentiable, K4 (the detached search) when differentiable.
  Beyond, over the scene's projected tables (``ops/projected.py``): the
  forward takes K6, K7 or K5 by the tables' size, with dead lanes
  parked at an unhittable origin, and shades from the winner's payload
  row; the differentiable search is K5.  The differentiable record is
  ``record_from_rows`` on the gathered primitive rows; shading and
  scatter are plain tensor ops (``materials.py``, ``textures.py``) and
  autograd differentiates them.  It draws each bounce's uniforms with
  the draw kernel (``ops/draws.py``), where the JAX package hoists them
  for every bounce (``_precompute_draws``, kept as the reference).

The non-differentiable loops stop at ``max_bounces`` or once no lane is
alive; the differentiable ones run exactly ``max_bounces`` bounces.
Optional russian roulette (off by default; the reference has none) runs
between bounces.  t_min = 0.001 (ray.rs:25) is in units of |direction|.

``trace_resume`` continues the forward loop of either route on a given
wavefront state from any bounce; ``trace`` is its bounce-0 case, and
the cascade renderer (``render.py``) calls it on each compacted slice.
The regen wavefront (``wavefront.py``) runs the same two routes on a
lane pool at per-lane depth.

Not ported: the geometry-gradient re-derivation (``RPT_DIFF_T=rederive``),
``remat="bf16"``, the diff cascade, the between-bounce wavefront
reorder of big scenes (ROADMAP queue 1 items 8, 11 and 14; the reorder
changes no per-lane result).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.utils.checkpoint import checkpoint

from rust_pathtracer_tpu_torch import sampling
from rust_pathtracer_tpu_torch import vecmath as vm
from rust_pathtracer_tpu_torch.materials import emitted, scatter, shade_inputs
from rust_pathtracer_tpu_torch.ops.closest_hit import (
    closest_hit,
    closest_hit_record,
    pack_prims,
)
from rust_pathtracer_tpu_torch.ops.draws import bounce_draws
from rust_pathtracer_tpu_torch.ops.fused_bounce import (
    _COL_KEYS,
    fused_bounce_diff_ok,
    fused_bounce_keyed,
    fused_bounce_ok,
    fused_scan_trace,
    key_words,
    pack_prims_shaded,
)
from rust_pathtracer_tpu_torch.ops.projected import (
    PAY_IDX,
    closest_hit_projected,
    closest_hit_record_projected,
)
from rust_pathtracer_tpu_torch.ops.intersect import (
    PRIM_RECT,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    axis_onehot,
    gather_prim_rows,
    record_from_rows,
)

T_MIN = 1e-3  # ray.rs:25
# a dead lane's origin in the big-scene forward: no cluster's slab test
# passes it, so it visits no cluster (integrator.py:256-259)
PARKED_ORIGIN = 3.0e33

# fixed histogram length, as in the JAX package
MAX_BOUNCE_STATS = 64

# remat="auto": the generic differentiable trace keeps every
# intermediate ("none") up to this many lane-bounces, and checkpoints
# each bounce ("mid") beyond.  "none" keeps 1,124.8 B a lane-bounce
# (TwoSphereCheckers 854x480, 2 spp, 20 bounces: 18.44 GB; NVIDIA H100
# 80GB HBM3, 700 W, chip_smoke.py phase 12); a budget of 30 GB, under
# half the card, is 26.7 M lane-bounces.
REMAT_AUTO_LANE_BOUNCES = 26_000_000
REMAT_MODES = ("none", "mid", "names")


class TraceStats(NamedTuple):
    segments: torch.Tensor   # f32 scalar: total ray segments traced
    bounces: int             # bounce iterations executed (kernel launches)
    occupancy: torch.Tensor  # f32 (MAX_BOUNCE_STATS,): alive lanes per bounce


def _precompute_draws(lane_keys, max_bounces, rr_start, start_bounce=0):
    """Per-bounce uniforms for bounces [start_bounce, max_bounces).

    The draws depend only on (lane key, bounce, purpose), never on the
    path state, so they are drawn for every bounce at once.  Returns a
    dict of (B, R, ...) tensors: ``sphere_u`` (B, R, 2), ``ball_u``
    (B, R, 3), ``coin`` (B, R) and, when roulette can fire,
    ``roulette`` (B, R).  Bit-equal to the JAX legacy stream.  The JAX
    package's hoisted form; the port's routes draw bounce by bounce (the
    fused route inside K1, the generic route with ``bounce_draws``), and
    the tests hold them to this.
    """
    rr = rr_start < max_bounces
    b = torch.arange(start_bounce, max_bounces, dtype=torch.int64,
                     device=lane_keys.device)[:, None]
    out = dict(
        sphere_u=sampling.uniform2(
            sampling.bounce_keys(lane_keys, b, sampling.P_LAMBERT)),
        ball_u=sampling.uniform3(
            sampling.bounce_keys(lane_keys, b, sampling.P_FUZZ)),
        coin=sampling.uniform(
            sampling.bounce_keys(lane_keys, b, sampling.P_SCHLICK)),
    )
    if rr:
        out["roulette"] = sampling.uniform(
            sampling.bounce_keys(lane_keys, b, sampling.P_ROULETTE))
    return out


def resolve_remat_mode(remat, lanes: int, max_bounces: int) -> str:
    """The remat mode of a generic differentiable trace: ``remat``, or
    for None / ``"auto"`` "none" up to ``REMAT_AUTO_LANE_BOUNCES``
    lane-bounces and "mid" beyond (``_resolve_remat_mode``; the JAX
    package's threshold is a TPU memory figure and is not carried)."""
    mode = remat or "auto"
    if mode == "auto":
        return "none" if lanes * max_bounces <= REMAT_AUTO_LANE_BOUNCES else "mid"
    if mode not in REMAT_MODES:
        raise NotImplementedError(
            f"remat={mode!r}: the port has {REMAT_MODES} and 'auto' "
            "('bf16' is not ported, ROADMAP queue 1 item 14)")
    return mode


# ---------------------------------------------------------------------------
# the generic bounce
# ---------------------------------------------------------------------------


def _analytic_t(kind, aux, data, o, d, t_det, prim_types):
    """Differentiable hit distance by the implicit function theorem.

    For a hit on the surface F(x) = 0 at x = o + t d, dt = -(n.do +
    t n.dd) / (n.d) with n = grad F at the hit, so

        t(o, d) = t_det - (n.(o - o_det) + t_det n.(d - d_det)) / (n_det.d_det)

    is bitwise ``t_det`` in the forward and carries the exact first-order
    (o, d) derivative.  n per kind: the sphere's x - c, the rect's axis,
    the triangle's e1 x e2; all detached (the geometry is no gradient
    leaf, see ``trace``)."""
    od, dd = o.detach(), d.detach()
    point = od + t_det[..., None] * dd
    n = torch.zeros_like(od)
    if PRIM_SPHERE in prim_types:
        n = vm.where(kind == PRIM_SPHERE, point - data[..., 0:3], n)
    if PRIM_RECT in prim_types:
        n = vm.where(kind == PRIM_RECT, axis_onehot(aux), n)
    if PRIM_TRIANGLE in prim_types:
        n = vm.where(kind == PRIM_TRIANGLE, vm.cross(data[..., 3:6], data[..., 6:9]), n)
    den = vm.dot(n, dd)
    den = torch.where(torch.abs(den) < 1e-30, torch.ones_like(den), den)
    return t_det - (vm.dot(n, o - od) + t_det * vm.dot(n, d - dd)) / den


def search_and_record(scene, table, o, d, alive):
    """The non-differentiable route's closest hit and hit record: K3 on
    the packed table up to 128 primitives; beyond, the projected route
    (K6, K7 or K5) with dead lanes parked at PARKED_ORIGIN and the
    record from the winner's payload.  Returns (hit & alive, HitRecord
    with valid = that mask, shade_row or None).  The differentiable
    route searches in ``_bounce_step`` and builds its record in
    ``_record_diff``."""
    if scene.kinds_static is None:
        o_live = vm.where(alive, o, torch.full_like(o, PARKED_ORIGIN))
        hit, _, _, rec, shade_row = closest_hit_record_projected(scene, o_live, d, T_MIN)
    else:
        hit, _, _, rec = closest_hit_record(table, o, d, kinds=scene.kinds_static,
                                            t_min=T_MIN)
        shade_row = None
    hit = hit & alive
    return hit, rec._replace(valid=hit), shade_row


def detached_search(scene, table, o, d):
    """The differentiable route's detached closest hit (hit, t, idx), t =
    T_MISS and idx = 0 on a miss: K4 on the packed table up to 128
    primitives, K5 on the projected tables beyond (``intersect.closest_hit``
    on the TPU)."""
    if scene.kinds_static is not None:
        return closest_hit(table, o, d, kinds=scene.kinds_static, t_min=T_MIN)
    hit, t, pay = closest_hit_projected(table, o, d, T_MIN)
    idx = torch.round(pay[:, PAY_IDX]).to(torch.int32).clamp(min=0)
    return hit, t, idx


def _record_diff(scene, o, d, alive, hit, t_search, idx):
    """The differentiable route's record from K4's (hit, t, idx):
    ``_analytic_t`` and ``record_from_rows`` on the winner's primitive
    row, so autograd carries the (o, d) derivative."""
    t_det = torch.where(hit, t_search, torch.ones_like(t_search))
    kind, aux, data, mat = gather_prim_rows(scene.prims, idx)
    t = _analytic_t(kind, aux, data, o, d, t_det, scene.prim_types)
    hit = hit & alive
    return hit, record_from_rows(kind, aux, data, mat, idx, o, d, t, hit,
                                 scene.prim_types)


def _call(fn, *args):
    return fn(*args)


def _checkpointed(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def _bounce_step(scene, table, state, draws_b, background, rr_u,
                 differentiable=False, mode="none"):
    """One generic bounce; ``state`` is (o, d, thr, rad, alive) with
    (R, 3) vectors and a bool alive mask, ``draws_b`` this bounce's
    uniforms, ``rr_u`` the roulette uniforms or None.  Returns the new
    state.

    Differentiable, the detached search (K4 or K5) runs here, outside any
    checkpoint, so that a backward never runs it again.  The remat
    ``mode``: "none" keeps every intermediate for the backward; "mid"
    checkpoints the record, the shading inputs and the scatter
    separately, so only the values between them are kept; "names"
    checkpoints the whole bounce after the search, so only its inputs
    and the search's result are kept."""
    o, d = state[0], state[1]
    if not differentiable:
        hit, rec, shade_row = search_and_record(scene, table, o, d, state[4])
        return _bounce_tail(scene, state, hit, rec, draws_b, background, rr_u, _call,
                            shade_row)
    search = detached_search(scene, table, o.detach(), d.detach())
    if mode == "names":
        return _checkpointed(_bounce_diff, scene, state, search, draws_b,
                             background, rr_u, _call)
    return _bounce_diff(scene, state, search, draws_b, background, rr_u,
                        _checkpointed if mode == "mid" else _call)


def _bounce_diff(scene, state, search, draws_b, background, rr_u, stage):
    o, d, _, _, alive = state
    hit, rec = stage(_record_diff, scene, o, d, alive, *search)
    return _bounce_tail(scene, state, hit, rec, draws_b, background, rr_u, stage)


def _bounce_tail(scene, state, hit, rec, draws_b, background, rr_u, stage,
                 shade_row=None, rr_sel=None):
    """The bounce after the hit record (JAX ``_bounce_step`` :562-631): the
    shading inputs (from the tables, or the payload ``shade_row``),
    background and emission banking, scatter, the state commit and
    roulette on ``rr_u`` (None: none); ``rr_sel``, an optional (R,) bool
    mask, limits roulette to those lanes (the regen pool's lanes at depth
    ``rr_start`` or more).  ``stage(fn, *args)`` runs the shading inputs
    and the scatter (directly, or checkpointed)."""
    o, d, thr, rad, alive = state
    si = stage(shade_inputs, scene, rec, shade_row)

    miss = alive & ~hit
    rad = rad + torch.where(miss[..., None], thr * background, 0.0)  # ray.rs:40
    em = emitted(scene, rec, si)                                     # ray.rs:26
    rad = rad + torch.where(hit[..., None], thr * em, 0.0)

    # detached sampling: the draws carry no gradient; their transforms
    # run here, at the wavefront's shape
    sphere_dir = sampling.on_unit_sphere_from_u(draws_b["sphere_u"])
    ball_dir = sampling.in_unit_sphere_from_u(draws_b["ball_u"])
    sc = stage(scatter, scene, rec, d, sphere_dir, ball_dir, draws_b["coin"], si)

    cont = hit & sc.did_scatter
    thr = torch.where(cont[..., None], thr * sc.attenuation, thr)
    o = vm.where(cont, rec.point, o)
    d = vm.where(cont, sc.direction, d)
    alive = cont
    if rr_u is not None:  # russian roulette (no reference counterpart)
        p = torch.clamp(thr.detach().amax(dim=-1), 0.05, 1.0)
        live = alive if rr_sel is None else alive & rr_sel
        survive = rr_u < p
        thr = torch.where((live & survive)[..., None], thr / p[..., None], thr)
        alive = alive & (survive | ~live)
    return o, d, thr, rad, alive


# ---------------------------------------------------------------------------
# the loops
# ---------------------------------------------------------------------------


def _stats(alive, bounce, segments, occupancy):
    n_alive = alive.sum()
    occupancy[min(bounce, MAX_BOUNCE_STATS - 1)] = n_alive
    return segments + n_alive


def _trace_generic(scene, state, keys, background, start_bounce, max_bounces,
                   rr_start, segments, occupancy, differentiable=False, mode=None):
    """Bounces [start_bounce, max_bounces) of the generic route on ``state``
    = (o, d, thr, rad, alive); stops early once no lane is alive unless
    ``differentiable``.  Returns (state, segments, occupancy, bounces
    run)."""
    table = scene.proj if scene.kinds_static is None else pack_prims(scene.prims)
    bounce = start_bounce
    while bounce < max_bounces and (differentiable or bool(state[4].any())):
        segments = _stats(state[4].to(torch.float32), bounce, segments, occupancy)
        su, bu, coin, rr_u = bounce_draws(keys, bounce, bounce >= rr_start)
        draws_b = dict(sphere_u=su, ball_u=bu, coin=coin)
        state = _bounce_step(scene, table, state, draws_b, background, rr_u,
                             differentiable, mode)
        bounce += 1
    return state, segments, occupancy, bounce - start_bounce


def _trace_fused(scene, state, keys, background, start_bounce, max_bounces,
                 rr_start, segments, occupancy, differentiable=False):
    """Bounces [start_bounce, max_bounces) of the fused route on the
    (13, R) ``state`` (rows in ``_COL_KEYS`` order).  Forward: one keyed
    K1 launch a bounce, until no lane is alive.  Differentiable: the
    whole-scan ``fused_scan_trace`` over exactly ``max_bounces`` bounces
    from bounce 0.  Returns (state, segments, occupancy, bounces run)."""
    if differentiable:
        if start_bounce:
            raise ValueError("the differentiable fused trace starts at bounce 0")
        cols, segments, occupancy = fused_scan_trace(
            scene, dict(zip(_COL_KEYS, state.unbind(0))), keys, background, T_MIN,
            max_bounces, rr_start, MAX_BOUNCE_STATS)
        return (torch.stack([cols[k] for k in _COL_KEYS]), segments, occupancy,
                max_bounces)

    table = pack_prims_shaded(scene)
    seed = scene.textures.perlin_seed
    bounce = start_bounce
    while bounce < max_bounces and bool((state[12] > 0.5).any()):
        segments = _stats(state[12], bounce, segments, occupancy)
        state = fused_bounce_keyed(
            table, background, seed, state, keys, bounce,
            with_roulette=bounce >= rr_start, kinds=scene.kinds_static,
            mat_types=scene.mat_types, tex_types=scene.tex_types, t_min=T_MIN,
        )
        bounce += 1
    return state, segments, occupancy, bounce - start_bounce


def trace_resume(scene, o, d, thr, rad, alive, lane_keys, background,
                 start_bounce: int, max_bounces: int,
                 russian_roulette_start: Optional[int] = None, *,
                 segments=None, occupancy=None, differentiable: bool = False,
                 mode: Optional[str] = None):
    """Continue the bounce loop on an explicit wavefront state over
    bounces [start_bounce, max_bounces) (JAX ``trace_resume``).

    o, d, thr, rad: (R, 3) f32; alive: (R,) bool; lane_keys: (R, 2).
    The draws key on (lane key, bounce), so a lane continues exactly as
    it would have in one uninterrupted trace, wherever it now sits in
    the wavefront.  The forward stops once no lane is alive.
    ``segments`` (f32 scalar) and ``occupancy`` (MAX_BOUNCE_STATS,)
    carry the counts of the bounces before (zeros when None); the
    forward writes occupancy in place.  The route is ``trace``'s: keyed
    K1 on the fused scenes, else the generic bounce (K3, or K6 / K7 /
    K5) with the draw kernel.  ``differentiable`` / ``mode`` serve
    ``trace``'s differentiable loops, which start at bounce 0.  Returns
    (state dict with o, d, thr, rad, alive, segments, occupancy;
    bounces run)."""
    if scene.prims.data.requires_grad:
        raise NotImplementedError(
            "gradients of the primitive geometry (scene.prims.data) are not "
            "ported: the hit distance is linearised in the ray only, so they "
            "would come back zero (JAX RPT_DIFF_T=rederive; ROADMAP queue 1 "
            "item 8)")
    dev = o.device
    if scene.device != dev:
        raise ValueError(f"scene on {scene.device}, rays on {dev}")
    background = torch.as_tensor(background, dtype=torch.float32, device=dev)
    rr_start = (max_bounces + 1 if russian_roulette_start is None
                else russian_roulette_start)
    if segments is None:
        segments = torch.zeros((), dtype=torch.float32, device=dev)
    if occupancy is None:
        occupancy = torch.zeros(MAX_BOUNCE_STATS, dtype=torch.float32, device=dev)
    keys = key_words(lane_keys)
    if (fused_bounce_diff_ok if differentiable else fused_bounce_ok)(scene):
        state = torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                             thr[:, 0], thr[:, 1], thr[:, 2],
                             rad[:, 0], rad[:, 1], rad[:, 2], alive.to(o.dtype)])
        state, segments, occupancy, n = _trace_fused(
            scene, state, keys, background, start_bounce, max_bounces, rr_start,
            segments, occupancy, differentiable)
        o, d, thr = state[0:3].T, state[3:6].T, state[6:9].T
        rad, alive = state[9:12].T.contiguous(), state[12] > 0.5
    else:
        (o, d, thr, rad, alive), segments, occupancy, n = _trace_generic(
            scene, (o, d, thr, rad, alive), keys, background, start_bounce,
            max_bounces, rr_start, segments, occupancy, differentiable, mode)
    return dict(o=o, d=d, thr=thr, rad=rad, alive=alive, segments=segments,
                occupancy=occupancy), n


def trace(
    scene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    lane_keys: torch.Tensor,
    background,
    max_bounces: int,
    russian_roulette_start: Optional[int] = None,
    differentiable: bool = False,
    remat: Optional[str] = None,
):
    """Estimate radiance for a wavefront of rays.

    origins, directions: (R, 3) f32; lane_keys: (R, 2) lane keys;
    background: (3,) miss color.  All on one device, which the scene
    must share.  Returns (radiance (R, 3), TraceStats).

    ``differentiable`` runs exactly ``max_bounces`` bounces with autograd
    live: gradients reach origins, directions, the texture colours and
    image texels and the background (the detached-sampling estimator of
    the JAX package).  A gradient of the primitive geometry
    (``scene.prims.data.requires_grad``) raises: the hit distance is
    linearised in (o, d) only, so it would come back zero.  ``remat``
    ("none", "mid", "names", or None / "auto") applies to the generic
    route (see ``resolve_remat_mode``); the fused route keeps its
    residuals, 64-72 B a lane-bounce.
    """
    dev = origins.device
    R = origins.shape[0]
    mode = resolve_remat_mode(remat, R, max_bounces) if differentiable else None
    st, n = trace_resume(
        scene, origins, directions, torch.ones((R, 3), device=dev),
        torch.zeros((R, 3), device=dev), torch.ones(R, dtype=torch.bool, device=dev),
        lane_keys, background, 0, max_bounces, russian_roulette_start,
        differentiable=differentiable, mode=mode)
    return st["rad"], TraceStats(segments=st["segments"], bounces=n,
                                 occupancy=st["occupancy"])
