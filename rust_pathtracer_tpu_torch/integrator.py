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
  row: in one launch of the shade kernel (``ops/shade.py``) where the
  tables' rows are complete and the textures solid or checkers
  (``forward_bounce``), else in tensor ops; the differentiable search is
  K5.  The differentiable record is ``record_from_rows`` on the gathered
  primitive rows; shading and scatter are plain tensor ops
  (``materials.py``, ``textures.py``) and autograd differentiates them.
  It draws each bounce's uniforms with
  the draw kernel (``ops/draws.py``), where the JAX package hoists them
  for every bounce (``_precompute_draws``, kept as the reference).

The non-differentiable loops stop at ``max_bounces`` or once no lane is
alive; the differentiable ones run exactly ``max_bounces`` bounces.
Optional russian roulette (off by default; the reference has none) runs
between bounces.  t_min = 0.001 (ray.rs:25) is in units of |direction|.

Two choices of the JAX package's environment are arguments here.
``rng_scheme`` (``RPT_RNG_SCHEME``): the scatter draws' stream, "legacy"
or "packed" (``sampling.bounce_draws``), passed to every draw site (K1,
the draw kernel), so a trace never mixes them.  ``diff_t``
(``RPT_DIFF_T``): the differentiable hit distance.  "analytic" (the
default) linearises K4's t in the ray (``_analytic_t``); "rederive"
re-intersects the winning primitive's row in plain tensor ops
(``intersect.prim_intersect_t``), so autograd also carries the
gradient of the geometry, ``scene.prims.data``, through t, the hit
point, the normal and uv.  Under "rederive" the fused route is not
taken (``fused_bounce_diff_ok``): CornellBox's differentiable step runs
K4 and autograd, big scenes keep K5 as the detached search.

``trace_resume`` continues the forward loop of either route on a given
wavefront state from any bounce; ``trace`` is its bounce-0 case, and
the cascade renderer (``render.py``) calls it on each compacted slice.
The regen wavefront (``wavefront.py``) runs the same two routes on a
lane pool at per-lane depth.

Three more choices of the JAX package are arguments of ``trace``.
``reorder`` (``RPT_BIN``): the between-bounce reorder of big scenes
(JAX ``_reorder_wavefront``).  On the forward generic route over
projected tables, from bounce 1 on while more than 1/64 of the lanes
live, the wavefront is sorted by its lanes' exact cluster pass-sets
(``projected.passset_perm``, keys from the pass-set key kernel), so
that a warp's lanes visit the same clusters; the radiance goes back to
caller order at the end.  Each lane carries its key and state, and the
sweeps' results do not depend on the order, so the reorder changes no
per-lane result.  None follows JAX's routing (``use_wavefront_reorder``:
forward, at least 4 real clusters); ``trace_resume`` never reorders.
``remat="bf16"`` (``ops/compressed_vjp.py``): remat "none" with the
saved residuals in bfloat16.  ``diff_cascade`` (``RPT_DIFF_CASCADE``):
a differentiable trace in stages of static width (``_trace_diff_cascade``).
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
from rust_pathtracer_tpu_torch.ops.compressed_vjp import compressed_residuals
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
    closest_hit_routed,
    passset_perm,
    record_from_payload,
)
from rust_pathtracer_tpu_torch.ops.projected import (
    use_wavefront_reorder as _tables_want_reorder,
)
from rust_pathtracer_tpu_torch.ops.intersect import (
    PRIM_RECT,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    axis_onehot,
    gather_prim_rows,
    prim_intersect_t,
    record_from_rows,
)
from rust_pathtracer_tpu_torch.ops.shade import shade_bounce, shade_kernel_ok
from rust_pathtracer_tpu_torch.utils.metrics import span

T_MIN = 1e-3  # ray.rs:25
T_MAX = 1.0e30  # the re-derived hit distance's upper bound (JAX T_MAX)
# the differentiable hit distance (JAX RPT_DIFF_T)
DIFF_T_MODES = ("analytic", "rederive")
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
REMAT_MODES = ("none", "mid", "names", "bf16")
# the between-bounce reorder runs while more than 1/REORDER_ALIVE_SHARE of
# the lanes live (integrator.py:380-405: below that, re-sorting every lane
# costs more than the few live lanes' blocks lose)
REORDER_ALIVE_SHARE = 64


class TraceStats(NamedTuple):
    segments: torch.Tensor   # f32 scalar: total ray segments traced
    bounces: int             # bounce iterations executed (kernel launches)
    occupancy: torch.Tensor  # f32 (MAX_BOUNCE_STATS,): alive lanes per bounce


def _precompute_draws(lane_keys, max_bounces, rr_start, start_bounce=0,
                      rng_scheme="legacy"):
    """Per-bounce uniforms for bounces [start_bounce, max_bounces).

    The draws depend only on (lane key, bounce, purpose), never on the
    path state, so they are drawn for every bounce at once.  Returns a
    dict of (B, R, ...) tensors: ``sphere_u`` (B, R, 2), ``ball_u``
    (B, R, 3), ``coin`` (B, R) and, when roulette can fire,
    ``roulette`` (B, R).  Bit-equal to the JAX stream of ``rng_scheme``.
    The JAX package's hoisted form; the port's routes draw bounce by
    bounce (the fused route inside K1, the generic route with
    ``bounce_draws``), and the tests hold them to this.
    """
    rr = rr_start < max_bounces
    b = torch.arange(start_bounce, max_bounces, dtype=torch.int64,
                     device=lane_keys.device)[:, None]
    su, bu, cn, rl = sampling.bounce_draws(lane_keys, b, rr, rng_scheme)
    out = dict(sphere_u=su, ball_u=bu, coin=cn)
    if rr:
        out["roulette"] = rl
    return out


def resolve_remat_mode(remat, lanes: int, max_bounces: int) -> str:
    """The remat mode of a generic differentiable trace: ``remat``, or
    for None / ``"auto"`` "none" up to ``REMAT_AUTO_LANE_BOUNCES``
    lane-bounces and "mid" beyond (``_resolve_remat_mode``; the JAX
    package's threshold is a TPU memory figure and is not carried).
    "auto" never picks the lossy "bf16"."""
    mode = remat or "auto"
    if mode == "auto":
        return "none" if lanes * max_bounces <= REMAT_AUTO_LANE_BOUNCES else "mid"
    if mode not in REMAT_MODES:
        raise ValueError(f"remat={mode!r}, want one of {REMAT_MODES} or 'auto'")
    return mode


def use_wavefront_reorder(scene, differentiable: bool = False,
                          reorder: Optional[bool] = None) -> bool:
    """Whether ``trace`` reorders the wavefront between bounces (JAX
    ``use_wavefront_reorder``): never when differentiable, nor on a scene
    without projected tables; else ``reorder`` where it is a bool
    (``RPT_BIN=1/0``), and for None at least 4 real clusters
    (``projected.use_wavefront_reorder``)."""
    if reorder not in (None, True, False):
        raise ValueError(f"reorder={reorder!r}, want None, True or False")
    if differentiable or scene.kinds_static is not None or scene.proj is None:
        return False
    return _tables_want_reorder(scene.proj) if reorder is None else reorder


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


def shade_bounce_plain(scene, search, state, draws_b, background, rr_u, rr_sel=None):
    """The tensor-op shading of a projected search's (t, column, payload):
    the hit record from the payload rows (``record_from_payload``), masked
    to the live lanes, then ``_bounce_tail``.  The forward route of every
    projected bounce the shade kernel does not take, and that kernel's
    plain twin (``ops/shade.py``).  Returns the new state."""
    o, d, _, _, alive = state
    hit, rec, shade_row = record_from_payload(scene, o, d, *search)
    hit = hit & alive
    return _bounce_tail(scene, state, hit, rec._replace(valid=hit), draws_b, background,
                        rr_u, _call, shade_row, rr_sel)


def forward_bounce(scene, table, state, draws_b, background, rr_u, rr_sel=None):
    """One forward generic bounce on ``state`` = (o, d, thr, rad, alive).
    Up to 128 primitives: K3 on the packed ``table``, then ``_bounce_tail``.
    Beyond: the projected search (K6, K7 or K5) with dead lanes parked at
    PARKED_ORIGIN, then the shade kernel (``shade.shade_bounce``) where
    ``shade.shade_kernel_ok`` admits the scene on the state's device (a
    CUDA one), else ``shade_bounce_plain``.  ``rr_u`` and ``rr_sel`` as
    ``_bounce_tail`` takes them.  Returns the new state.  The
    differentiable route searches in ``_bounce_step`` and builds its record
    in ``_record_diff``."""
    o, d, alive = state[0], state[1], state[4]
    if scene.kinds_static is not None:
        hit, _, _, rec = closest_hit_record(table, o, d, kinds=scene.kinds_static,
                                            t_min=T_MIN)
        hit = hit & alive
        return _bounce_tail(scene, state, hit, rec._replace(valid=hit), draws_b,
                            background, rr_u, _call, None, rr_sel)
    o_live = vm.where(alive, o, torch.full_like(o, PARKED_ORIGIN))
    search = closest_hit_routed(scene.proj, o_live, d, T_MIN)
    if shade_kernel_ok(scene, o.device):
        return shade_bounce(scene, search, state, draws_b, background, rr_u, rr_sel)
    return shade_bounce_plain(scene, search, state, draws_b, background, rr_u, rr_sel)


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


def _record_diff(scene, o, d, alive, hit, t_search, idx, diff_t="analytic"):
    """The differentiable route's record from K4's (or K5's) (hit, t, idx)
    on the winner's primitive row: the hit distance by ``diff_t``, then
    ``record_from_rows``.  "analytic": ``_analytic_t``, so autograd
    carries the (o, d) derivative; "rederive": ``prim_intersect_t`` on the
    row (JAX ``_find_hit``; its ``valid`` is not read, and a miss lane
    takes t = 1), so it also carries the derivative of the row's
    ``prims.data``."""
    kind, aux, data, mat = gather_prim_rows(scene.prims, idx)
    if diff_t == "rederive":
        t_re, _ = prim_intersect_t(kind, aux, data, o, d, T_MIN, T_MAX,
                                   scene.prim_types)
        t = torch.where(hit, t_re, torch.ones_like(t_re))
    else:
        t_det = torch.where(hit, t_search, torch.ones_like(t_search))
        t = _analytic_t(kind, aux, data, o, d, t_det, scene.prim_types)
    hit = hit & alive
    return hit, record_from_rows(kind, aux, data, mat, idx, o, d, t, hit,
                                 scene.prim_types)


def _call(fn, *args):
    return fn(*args)


def _checkpointed(fn, *args):
    return checkpoint(fn, *args, use_reentrant=False)


def _bounce_step(scene, table, state, draws_b, background, rr_u,
                 differentiable=False, mode="none", diff_t="analytic"):
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
    and the search's result are kept; "bf16" keeps what "none" keeps,
    the large f32 tensors in bfloat16 (``compressed_vjp``).  ``diff_t``
    picks the hit distance (``_record_diff``)."""
    if not differentiable:
        return forward_bounce(scene, table, state, draws_b, background, rr_u)
    o, d = state[0], state[1]
    search = detached_search(scene, table, o.detach(), d.detach())
    if mode == "names":
        return _checkpointed(_bounce_diff, scene, state, search, draws_b,
                             background, rr_u, _call, diff_t)
    if mode == "bf16":
        with compressed_residuals():
            return _bounce_diff(scene, state, search, draws_b, background, rr_u,
                                _call, diff_t)
    return _bounce_diff(scene, state, search, draws_b, background, rr_u,
                        _checkpointed if mode == "mid" else _call, diff_t)


def _bounce_diff(scene, state, search, draws_b, background, rr_u, stage, diff_t):
    o, d, _, _, alive = state
    hit, rec = stage(_record_diff, scene, o, d, alive, *search, diff_t)
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
                   rr_start, segments, occupancy, differentiable=False, mode=None,
                   diff_t="analytic", rng_scheme="legacy", reorder=False):
    """Bounces [start_bounce, max_bounces) of the generic route on ``state``
    = (o, d, thr, rad, alive); stops early once no lane is alive unless
    ``differentiable``.  The search tables hold no gradient (``pack_prims``
    packs the detached geometry; the projected tables are the scene's).
    ``reorder`` (forward, projected tables): from bounce 1 on, while more
    than 1/REORDER_ALIVE_SHARE of the lanes live, the lanes are sorted by
    ``passset_perm`` before the bounce (JAX ``_reorder_wavefront``); the
    live count comes from the loop's one sync a bounce.  Returns (state,
    segments, occupancy, bounces run, lane): ``lane`` None, or where the
    reorder left them, each slot's lane in ``state``'s incoming order."""
    table = scene.proj if scene.kinds_static is None else pack_prims(scene.prims)
    R = state[0].shape[0]
    lane = None
    bounce = start_bounce
    while bounce < max_bounces:
        if reorder:
            with span("rpt.sync"):
                n_alive = int(state[4].sum())  # the loop's sync
            if n_alive == 0:
                break
        elif not differentiable:
            with span("rpt.sync"):
                live = bool(state[4].any())
            if not live:
                break
        with span("rpt.bounce", bounce):
            if reorder and bounce > 0 and n_alive * REORDER_ALIVE_SHARE > R:
                perm = passset_perm(table, state[0], state[1], state[4], T_MIN)
                state = tuple(x[perm] for x in state)
                keys = keys[:, perm]
                lane = perm if lane is None else lane[perm]
            segments = _stats(state[4].to(torch.float32), bounce, segments, occupancy)
            su, bu, coin, rr_u = bounce_draws(keys, bounce, bounce >= rr_start, rng_scheme)
            draws_b = dict(sphere_u=su, ball_u=bu, coin=coin)
            state = _bounce_step(scene, table, state, draws_b, background, rr_u,
                                 differentiable, mode, diff_t)
        bounce += 1
    return state, segments, occupancy, bounce - start_bounce, lane


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


def diff_cascade_stages(schedule, max_bounces: int, n_lanes: int):
    """The differentiable cascade's stages (JAX ``_diff_cascade_stages``):
    [(boundary, width)] from a "b:s,..." ``schedule`` (``render``'s
    parser), the width ``n_lanes // s``.  [] (the plain trace) when
    ``schedule`` is None or empty, when ``max_bounces`` reaches the
    overflow slot MAX_BOUNCE_STATS - 1, or when a boundary is at or past
    ``max_bounces`` or a shrink does not divide ``n_lanes``.  A malformed
    string raises ValueError."""
    from rust_pathtracer_tpu_torch.render import parse_cascade_schedule

    if not schedule:
        return []
    pairs = parse_cascade_schedule(schedule)
    if max_bounces >= MAX_BOUNCE_STATS - 1:
        return []  # the overflow slot would alias a bounce's count
    if not all(b < max_bounces and n_lanes % s == 0 for b, s in pairs):
        return []
    return [(b, int(n_lanes // s)) for b, s in pairs]


def _trace_diff_cascade(scene, o, d, keys, background, stages, max_bounces,
                        rr_start, mode, diff_t, rng_scheme):
    """The differentiable trace in stages of static width (JAX
    ``_trace_diff_cascade``): the generic route runs bounces [b0, b1) on
    the current slice, every lane's radiance is added into ``banked`` at
    its caller index (the indices are unique, so no two adds meet), and
    at a boundary the live lanes are stably partitioned first
    (``_live_first``) and the first ``width`` lanes go on with radiance 0.
    A live lane past the width is dropped; the dropped lanes are counted
    into occupancy[MAX_BOUNCE_STATS - 1], which the caller must find 0.
    Each lane traces its path, so the result is the plain trace's up to
    the order in which a lane's stage sums add.  Returns (radiance (R, 3)
    in caller order, segments, occupancy)."""
    R, dev = o.shape[0], o.device
    f32 = torch.float32
    state = (o, d, torch.ones((R, 3), dtype=f32, device=dev),
             torch.zeros((R, 3), dtype=f32, device=dev),
             torch.ones(R, dtype=torch.bool, device=dev))
    banked = torch.zeros((R, 3), dtype=f32, device=dev)
    lane = torch.arange(R, dtype=torch.int64, device=dev)
    segments = torch.zeros((), dtype=f32, device=dev)
    occupancy = torch.zeros(MAX_BOUNCE_STATS, dtype=f32, device=dev)
    overflow = torch.zeros((), dtype=torch.int64, device=dev)
    b0 = 0
    for b1, width in stages + [(max_bounces, None)]:
        state, segments, occupancy, _, _ = _trace_generic(
            scene, state, keys, background, b0, b1, rr_start, segments, occupancy,
            True, mode, diff_t, rng_scheme)
        banked = banked.index_put((lane,), state[3], accumulate=True)
        if width is None:
            break
        alive = state[4]
        overflow += torch.clamp(alive.sum() - width, min=0)
        keep = _live_first(alive)[:width]
        state = (state[0][keep], state[1][keep], state[2][keep],
                 torch.zeros((width, 3), dtype=f32, device=dev), alive[keep])
        keys, lane = keys[:, keep], lane[keep]
        b0 = b1
    occupancy[MAX_BOUNCE_STATS - 1] += overflow.to(f32)
    return banked, segments, occupancy


def _trace_fused(scene, state, keys, background, start_bounce, max_bounces,
                 rr_start, segments, occupancy, differentiable=False,
                 rng_scheme="legacy"):
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
            max_bounces, rr_start, MAX_BOUNCE_STATS, rng_scheme)
        return (torch.stack([cols[k] for k in _COL_KEYS]), segments, occupancy,
                max_bounces)

    table = pack_prims_shaded(scene)
    seed = scene.textures.perlin_seed
    bounce = start_bounce
    while bounce < max_bounces:
        with span("rpt.sync"):
            live = bool((state[12] > 0.5).any())
        if not live:
            break
        with span("rpt.bounce", bounce):
            segments = _stats(state[12], bounce, segments, occupancy)
            state = fused_bounce_keyed(
                table, background, seed, state, keys, bounce,
                with_roulette=bounce >= rr_start, kinds=scene.kinds_static,
                mat_types=scene.mat_types, tex_types=scene.tex_types, t_min=T_MIN,
                rng_scheme=rng_scheme,
            )
        bounce += 1
    return state, segments, occupancy, bounce - start_bounce


def _check_trace(scene, dev, differentiable, diff_t, rng_scheme):
    if diff_t not in DIFF_T_MODES:
        raise ValueError(f"diff_t {diff_t!r}, want one of {DIFF_T_MODES}")
    sampling.check_rng_scheme(rng_scheme)
    if scene.prims.data.requires_grad and not (differentiable and diff_t == "rederive"):
        raise NotImplementedError(
            "a gradient of the primitive geometry (scene.prims.data) needs a "
            'differentiable trace with diff_t="rederive": under "analytic" the '
            "hit distance is linearised in the ray only, so it would come back "
            "zero")
    if scene.device != dev:
        raise ValueError(f"scene on {scene.device}, rays on {dev}")


def _resume(scene, o, d, thr, rad, alive, lane_keys, background, start_bounce,
            max_bounces, russian_roulette_start, segments, occupancy,
            differentiable, mode, diff_t, rng_scheme, reorder):
    """``trace_resume``'s loop, with the between-bounce ``reorder`` of
    ``_trace_generic`` where ``trace`` asks for it; every per-lane
    tensor returned is in the caller's order."""
    dev = o.device
    _check_trace(scene, dev, differentiable, diff_t, rng_scheme)
    background = torch.as_tensor(background, dtype=torch.float32, device=dev)
    rr_start = (max_bounces + 1 if russian_roulette_start is None
                else russian_roulette_start)
    if segments is None:
        segments = torch.zeros((), dtype=torch.float32, device=dev)
    if occupancy is None:
        occupancy = torch.zeros(MAX_BOUNCE_STATS, dtype=torch.float32, device=dev)
    keys = key_words(lane_keys)
    if fused_bounce_diff_ok(scene, diff_t) if differentiable else fused_bounce_ok(scene):
        state = torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2],
                             thr[:, 0], thr[:, 1], thr[:, 2],
                             rad[:, 0], rad[:, 1], rad[:, 2], alive.to(o.dtype)])
        state, segments, occupancy, n = _trace_fused(
            scene, state, keys, background, start_bounce, max_bounces, rr_start,
            segments, occupancy, differentiable, rng_scheme)
        o, d, thr = state[0:3].T, state[3:6].T, state[6:9].T
        rad, alive = state[9:12].T.contiguous(), state[12] > 0.5
    else:
        state, segments, occupancy, n, lane = _trace_generic(
            scene, (o, d, thr, rad, alive), keys, background, start_bounce,
            max_bounces, rr_start, segments, occupancy, differentiable, mode,
            diff_t, rng_scheme, reorder)
        if lane is not None:  # back to the caller's order
            state = tuple(torch.empty_like(x).index_put_((lane,), x) for x in state)
        o, d, thr, rad, alive = state
    return dict(o=o, d=d, thr=thr, rad=rad, alive=alive, segments=segments,
                occupancy=occupancy), n


def trace_resume(scene, o, d, thr, rad, alive, lane_keys, background,
                 start_bounce: int, max_bounces: int,
                 russian_roulette_start: Optional[int] = None, *,
                 segments=None, occupancy=None, differentiable: bool = False,
                 mode: Optional[str] = None, diff_t: str = "analytic",
                 rng_scheme: str = "legacy"):
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
    K5) with the draw kernel, drawing under ``rng_scheme``; it never
    reorders the wavefront (nor does JAX's: a cascade regroups at its
    boundaries).  ``differentiable`` / ``mode`` / ``diff_t`` serve
    ``trace``'s differentiable loops, which start at bounce 0.  Returns
    (state dict with o, d, thr, rad, alive, segments, occupancy; bounces
    run)."""
    return _resume(scene, o, d, thr, rad, alive, lane_keys, background, start_bounce,
                   max_bounces, russian_roulette_start, segments, occupancy,
                   differentiable, mode, diff_t, rng_scheme, False)


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
    diff_t: str = "analytic",
    rng_scheme: str = "legacy",
    reorder: Optional[bool] = None,
    diff_cascade: Optional[str] = None,
):
    """Estimate radiance for a wavefront of rays.

    origins, directions: (R, 3) f32; lane_keys: (R, 2) lane keys;
    background: (3,) miss color.  All on one device, which the scene
    must share.  Returns (radiance (R, 3), TraceStats).

    ``differentiable`` runs exactly ``max_bounces`` bounces with autograd
    live: gradients reach origins, directions, the texture colours and
    image texels and the background (the detached-sampling estimator of
    the JAX package).  ``diff_t`` ("analytic", the default, or
    "rederive"; JAX ``RPT_DIFF_T``) picks the hit distance: with
    "rederive" the winner is re-intersected in plain tensor ops, so a
    gradient also reaches the primitive geometry when
    ``scene.prims.data`` requires grad (on the generic route: K4, or K5
    beyond 128 primitives, then autograd).  Under "analytic" such a leaf
    raises, since the hit distance is linearised in (o, d) only and its
    gradient would come back zero.  ``rng_scheme`` ("legacy", the
    default, or "packed"; JAX ``RPT_RNG_SCHEME``) picks the stream of the
    scatter draws on every route.  ``remat`` ("none", "mid", "names",
    "bf16", or None / "auto") applies to the generic route (see
    ``resolve_remat_mode``); the fused route keeps its residuals, 64-72 B
    a lane-bounce.

    ``reorder`` (JAX ``RPT_BIN``; None, True or False): the forward's
    between-bounce reorder of big scenes (``use_wavefront_reorder``,
    ``_trace_generic``); the radiance comes back in caller order, and
    equals the trace without the reorder bit for bit.  ``diff_cascade``
    (JAX ``RPT_DIFF_CASCADE``; a "b:s,..." schedule, differentiable
    only): the trace narrows to R/s lanes at each boundary b
    (``_trace_diff_cascade``), on the generic route even for a scene the
    fused route takes; live lanes a width drops are counted into
    ``occupancy[MAX_BOUNCE_STATS - 1]``, which must come back 0.  An
    inapplicable schedule (``diff_cascade_stages``) runs the plain trace;
    a malformed one raises ValueError.
    """
    dev = origins.device
    R = origins.shape[0]
    mode = resolve_remat_mode(remat, R, max_bounces) if differentiable else None
    want_reorder = use_wavefront_reorder(scene, differentiable, reorder)
    stages = diff_cascade_stages(diff_cascade, max_bounces, R)
    if differentiable and stages:
        _check_trace(scene, dev, True, diff_t, rng_scheme)
        rr_start = (max_bounces + 1 if russian_roulette_start is None
                    else russian_roulette_start)
        bg = torch.as_tensor(background, dtype=torch.float32, device=dev)
        rad, segments, occupancy = _trace_diff_cascade(
            scene, origins, directions, key_words(lane_keys), bg, stages, max_bounces,
            rr_start, mode, diff_t, rng_scheme)
        return rad, TraceStats(segments=segments, bounces=max_bounces,
                               occupancy=occupancy)
    st, n = _resume(
        scene, origins, directions, torch.ones((R, 3), device=dev),
        torch.zeros((R, 3), device=dev), torch.ones(R, dtype=torch.bool, device=dev),
        lane_keys, background, 0, max_bounces, russian_roulette_start, None, None,
        differentiable, mode, diff_t, rng_scheme, want_reorder)
    return st["rad"], TraceStats(segments=st["segments"], bounces=n,
                                 occupancy=st["occupancy"])
