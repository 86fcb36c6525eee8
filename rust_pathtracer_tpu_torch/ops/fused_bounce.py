"""One whole wavefront bounce per launch: the fused-bounce kernel K1.

Counterpart of ``rust_pathtracer_tpu/ops/fused_bounce.py``.  This
module wraps a CUDA kernel (``csrc/fused_bounce.cu``, which replaces
the Pallas ``_kernel``) and holds its plain PyTorch twin.

One bounce for a scene of at most 128 primitives whose shading is
table-free (``fused_bounce_ok``):

* closest hit over the primitive list (sphere half-b nearest root,
  rect plane solve, one-sided Moller-Trumbore, strict ``t < best``);
* front-face flip, texture (solid / checker / perlin marble);
* background banking on a miss, emission banking on a front-face light;
* lambertian / metal / dielectric scatter;
* the state commit, then russian roulette from ``rr_start`` on.

``fused_bounce_keyed`` takes each lane's threefry key as two int32
columns (``key_words``, made once a trace) and the bounce index: the
kernel draws the bounce's uniforms itself, as ``sampling.bounce_draws``
draws them, and applies roulette, so the fused route draws nothing in
tensor ops.  It dispatches on where its tensors lie: CUDA tensors
launch the kernel (and count in ``launches``); CPU tensors run the plain
version ``fused_bounce_keyed_plain``: ``sampling.bounce_draws``, then
``fused_bounce_cols_plain`` (the Pallas kernel's interface, the six
uniforms as columns, op for op; the tests hold it against the Pallas
kernel), then ``roulette``.  With ``want_residuals`` it also returns the
residual planes that the backward kernel K2 (``fused_bounce_bwd.py``)
reads.

The differentiable bounce loop is one ``torch.autograd.Function``,
``FusedScanTrace`` (``fused_scan_trace``): keyed K1 with residuals
forward, K2 backward, for scenes that ``fused_bounce_diff_ok`` admits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Sequence, Tuple

import torch

from rust_pathtracer_tpu_torch import sampling
from rust_pathtracer_tpu_torch.ops.closest_hit import prim_candidate
from rust_pathtracer_tpu_torch.ops.intersect import MAX_PRIMS, T_MISS
from rust_pathtracer_tpu_torch.perlin import marble_planes
from rust_pathtracer_tpu_torch.scene.types import (
    MAT_DIELECTRIC,
    MAT_LAMBERTIAN,
    MAT_LIGHT,
    MAT_METAL,
    TEX_CHECKER,
    TEX_PERLIN,
    TEX_SOLID,
    SceneData,
)
from rust_pathtracer_tpu_torch.vecmath import _SAFE_EPS, NEAR_ZERO, cbrt, sqrt

# shading-table rows (rust_pathtracer_tpu/ops/projected.py PAY_*)
PAY_MKIND, PAY_FUZZ, PAY_IR, PAY_TKIND, PAY_TSCALE = 16, 17, 18, 19, 20
PAY_COLOR, PAY_ODD, PAY_EVEN = 21, 24, 27
PAY_W = 32

# the 13 wavefront state columns, in kernel order (al is f32 0/1)
_COL_KEYS = ("o0", "o1", "o2", "d0", "d1", "d2", "t0", "t1", "t2",
             "r0", "r1", "r2", "al")

# the residual outputs (want_residuals=True): nine f32 planes and the
# int32 flags word, in kernel order
_RES_KEYS = ("t", "nx", "ny", "nz", "v0", "v1", "v2", "ratio", "invr",
             "flags")

# residual flags bits (rust_pathtracer_tpu/ops/fused_bounce.py FLG_*)
FLG_HIT = 1
FLG_FRONT = 2
FLG_CONT = 4
FLG_REFLECT = 8       # dielectric chose reflect
FLG_SINES_NEG = 16    # checker picked the odd child
FLG_SEL_L = 32
FLG_SEL_M = 64
FLG_SEL_D = 128
FLG_LIGHT_ON = 256    # front-face light emission fired
FLG_COS_CLAMP = 512   # dielectric cos_t hit the min(., 1) clamp
FLG_REFR_ZERO = 1024  # refract safe_sqrt at <= 0 (zero gradient)
FLG_L_NEG = 2048      # refract 1 - |perp|^2 < 0 (abs() flips the sign)
FLG_IS_CK = 4096      # winning prim's texture is a checker
FLG_ALIVE = 8192      # lane was alive entering the bounce
FLG_RR_ACT = 16384    # roulette kept the lane and boosted it by 1/p (keyed)
# bits 16 and up: max(best_i, 0), the winning primitive (0 on a miss)
FLG_BESTI_SHIFT = 16

# kernel launches (CUDA tensors only): all of them, and those with
# residual outputs
launches = 0
residual_launches = 0

_M32 = 0xFFFFFFFF


def fused_bounce_ok(scene: SceneData) -> bool:
    """Can this scene's whole bounce run in the fused kernel?"""
    return (
        scene.kinds_static is not None
        and scene.shade_static
        and set(scene.tex_types) <= {TEX_SOLID, TEX_CHECKER, TEX_PERLIN}
    )


def fused_bounce_diff_ok(scene: SceneData) -> bool:
    """Can this scene's differentiable bounce run in K1 + K2?  Perlin's
    d(value)/d(point) has no backward, so solid and checker only."""
    return (fused_bounce_ok(scene)
            and set(scene.tex_types) <= {TEX_SOLID, TEX_CHECKER})


def pack_prims_shaded(scene: SceneData) -> torch.Tensor:
    """(PAY_W, P) f32 table: per-primitive geometry plus the flattened
    shading row.  Rows 0-11 prim data, 12 kind, 13 aux, 14 mat,
    16 material kind, 17 fuzz, 18 ir, 19 texture kind, 20 scale,
    21-23 solid color, 24-26 checker odd color, 27-29 checker even
    color (``fused_bounce.pack_prims_shaded``)."""
    prims, mats, texs = scene.prims, scene.materials, scene.textures
    f32 = torch.float32
    P = prims.kind.shape[0]
    mat = prims.mat.long()
    tex = mats.tex.long()[mat]
    tkind = texs.kind[tex]
    is_ck = tkind == TEX_CHECKER
    child = texs.child.long()[tex]  # (P, 2)
    zero = torch.zeros_like(child[:, 0])
    odd = torch.where(is_ck, child[:, 0], zero)
    even = torch.where(is_ck, child[:, 1], zero)
    rows = torch.stack([
        prims.kind.to(f32),            # 12
        prims.aux.to(f32),             # 13
        prims.mat.to(f32),             # 14
        torch.zeros(P, dtype=f32, device=prims.data.device),  # 15
        mats.kind[mat].to(f32),        # 16 PAY_MKIND
        mats.fuzz[mat],                # 17 PAY_FUZZ
        mats.ir[mat],                  # 18 PAY_IR
        tkind.to(f32),                 # 19 PAY_TKIND
        texs.scale[tex],               # 20 PAY_TSCALE
    ])
    color = texs.color[tex].T                                          # 21-23
    oddc = torch.where(is_ck[None, :], texs.color[odd].T, 0.0)       # 24-26
    evenc = torch.where(is_ck[None, :], texs.color[even].T, 0.0)     # 27-29
    pad = torch.zeros((PAY_W - PAY_EVEN - 3, P), dtype=f32,
                      device=prims.data.device)
    return torch.cat([prims.data.T.to(f32), rows, color, oddc, evenc, pad],
                     dim=0).contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch version (the Pallas _kernel op for op)
# ---------------------------------------------------------------------------


def fused_bounce_cols_plain(table, bg, seed, cols, su0, su1, bu0, bu1, bu2,
                            coin, *, kinds, mat_types, tex_types, t_min,
                            winner_out=None, want_residuals=False):
    """One fused bounce over R lanes, on given uniforms, in plain tensor
    ops (the Pallas kernel's interface).  Runs on any device.

    ``table`` (32, P) from ``pack_prims_shaded``; ``bg`` (3,) the
    background; ``seed`` the perlin seed (int); ``cols`` the 13 (R,)
    f32 state columns keyed by ``_COL_KEYS``; ``su0 .. coin`` the 6
    (R,) uniform columns.  ``kinds``, ``mat_types`` and ``tex_types``
    are the scene's static fields.  Returns the 13 new columns.
    ``winner_out``, an optional (R,) int32 tensor, receives each alive
    lane's winning primitive (-1 on a miss or a dead lane).

    With ``want_residuals`` the result is ``(cols, res)``: ``res`` maps
    ``_RES_KEYS`` to what the backward kernel K2 reads, on every lane
    (dead and missed ones included): nine (R,) f32 planes ``t`` (1.0 on
    a miss), the flipped normal, the texture value, the dielectric
    ``ratio`` (1.0 in a scene without a dielectric), ``invr`` (flip / r
    of a winning sphere, 0 otherwise), and the (R,) int32 ``flags``
    (``FLG_*``).  The 13 columns are the same either way.

    Every op rounds as the kernel's does (IEEE f32, no fused
    multiply-adds, a correctly rounded sqrt), so the two agree bit for
    bit apart from sin, cos and cbrt, where the libraries differ by an
    ulp."""
    f32 = torch.float32
    ox, oy, oz = cols["o0"], cols["o1"], cols["o2"]
    dx, dy, dz = cols["d0"], cols["d1"], cols["d2"]
    alive = cols["al"] > 0.5
    zeros = torch.zeros_like(ox)

    def full(v):
        return torch.full_like(ox, v)

    # ---- closest-hit sweep: strict t < best update, outward normal
    # kept at sweep time, the winner's shading row after the sweep ----
    a = dx * dx + dy * dy + dz * dz
    o_c = (ox, oy, oz)
    d_c = (dx, dy, dz)

    best_t = full(T_MISS)
    best_i = torch.full(ox.shape, -1, dtype=torch.int64, device=ox.device)
    wnx, wny, wnz = zeros, zeros, zeros
    w_invr = zeros  # the winning sphere's 1/r, 0 for rects and triangles

    for p, (kind, aux) in enumerate(kinds):
        c = prim_candidate(table, p, kind, aux, o_c, d_c, a, t_min, best_t)
        t, valid, (nx, ny, nz) = c["t"], c["valid"], c["n"]
        upd = valid & (t < best_t)
        best_t = torch.where(upd, t, best_t)
        best_i = torch.where(upd, p, best_i)
        wnx = torch.where(upd, nx, wnx)
        wny = torch.where(upd, ny, wny)
        wnz = torch.where(upd, nz, wnz)
        if want_residuals:
            w_invr = torch.where(upd, zeros if c["inv_r"] is None else c["inv_r"],
                                 w_invr)

    found = best_i >= 0
    if winner_out is not None:
        winner_out.copy_(torch.where(alive, best_i, -1))
    # the winner's shading row; zeros on a miss, as the kernel's
    # zero-initialized accumulators leave it
    shade = torch.where(found[None, :], table[:, best_i.clamp(min=0)],
                        torch.zeros((), dtype=f32, device=ox.device))
    mk, fz, ir_, tk, ts = (shade[PAY_MKIND], shade[PAY_FUZZ], shade[PAY_IR],
                           shade[PAY_TKIND], shade[PAY_TSCALE])
    c0, c1, c2 = shade[PAY_COLOR], shade[PAY_COLOR + 1], shade[PAY_COLOR + 2]
    od0, od1, od2 = shade[PAY_ODD], shade[PAY_ODD + 1], shade[PAY_ODD + 2]
    ev0, ev1, ev2 = shade[PAY_EVEN], shade[PAY_EVEN + 1], shade[PAY_EVEN + 2]

    hit = found & alive
    t = torch.where(found, best_t, full(1.0))  # finite t for miss lanes

    # ---- hit record (front-face flip, geometry.rs:29-41) ------------
    front = dx * wnx + dy * wny + dz * wnz < 0.0
    flip = torch.where(front, full(1.0), full(-1.0))
    nx, ny, nz = wnx * flip, wny * flip, wnz * flip
    px = ox + t * dx
    py = oy + t * dy
    pz = oz + t * dz

    def flag(mask, bit):
        return mask.to(torch.int32) * bit

    flags = flag(hit, FLG_HIT) | flag(front, FLG_FRONT)

    # ---- texture value ------------------------------------------------
    v0, v1, v2 = c0, c1, c2  # TEX_SOLID
    if TEX_CHECKER in tex_types:
        sines = torch.sin(ts * px) * torch.sin(ts * py) * torch.sin(ts * pz)
        is_ck = tk == float(TEX_CHECKER)
        pick = sines < 0.0
        flags = flags | flag(is_ck & pick, FLG_SINES_NEG) | flag(is_ck, FLG_IS_CK)
        v0 = torch.where(is_ck, torch.where(pick, od0, ev0), v0)
        v1 = torch.where(is_ck, torch.where(pick, od1, ev1), v1)
        v2 = torch.where(is_ck, torch.where(pick, od2, ev2), v2)
    if TEX_PERLIN in tex_types:
        gray = marble_planes(px, py, pz, seed, ts)
        is_pl = tk == float(TEX_PERLIN)
        v0 = torch.where(is_pl, gray, v0)
        v1 = torch.where(is_pl, gray, v1)
        v2 = torch.where(is_pl, gray, v2)

    # ---- emitted + background banking (ray.rs:26,40) -----------------
    thx, thy, thz = cols["t0"], cols["t1"], cols["t2"]
    rdx, rdy, rdz = cols["r0"], cols["r1"], cols["r2"]
    miss = alive & ~hit
    rdx = rdx + torch.where(miss, thx * bg[0], zeros)
    rdy = rdy + torch.where(miss, thy * bg[1], zeros)
    rdz = rdz + torch.where(miss, thz * bg[2], zeros)
    if MAT_LIGHT in mat_types:
        em_on = hit & (mk == float(MAT_LIGHT)) & front
        flags = flags | flag(em_on, FLG_LIGHT_ON)
        rdx = rdx + torch.where(em_on, thx * v0, zeros)
        rdy = rdy + torch.where(em_on, thy * v1, zeros)
        rdz = rdz + torch.where(em_on, thz * v2, zeros)

    # ---- scatter (materials.py op for op) ----------------------------
    did = torch.zeros_like(alive)
    sdx, sdy, sdz = zeros, zeros, zeros
    at0, at1, at2 = zeros, zeros, zeros

    if MAT_METAL in mat_types or MAT_DIELECTRIC in mat_types:
        inv_len = torch.reciprocal(sqrt(torch.clamp(a, min=_SAFE_EPS)))
        ux, uy, uz = dx * inv_len, dy * inv_len, dz * inv_len

    two_pi = 2.0 * math.pi
    if MAT_LAMBERTIAN in mat_types:
        s_z = 2.0 * su0 - 1.0
        s_phi = two_pi * su1
        s_r = sqrt(torch.clamp(1.0 - s_z * s_z, min=0.0))
        sph_x = s_r * torch.cos(s_phi)
        sph_y = s_r * torch.sin(s_phi)
        sph_z = s_z
    if MAT_METAL in mat_types:
        b_z = 2.0 * bu0 - 1.0
        b_phi = two_pi * bu1
        b_rho = sqrt(torch.clamp(1.0 - b_z * b_z, min=0.0))
        b_s = cbrt(bu2)
        ball_x = b_rho * torch.cos(b_phi) * b_s
        ball_y = b_rho * torch.sin(b_phi) * b_s
        ball_z = b_z * b_s

    if MAT_LAMBERTIAN in mat_types:
        dlx = nx + sph_x
        dly = ny + sph_y
        dlz = nz + sph_z
        nz_mask = (
            (torch.abs(dlx) < NEAR_ZERO) & (torch.abs(dly) < NEAR_ZERO)
            & (torch.abs(dlz) < NEAR_ZERO)
        )
        dlx = torch.where(nz_mask, nx, dlx)
        dly = torch.where(nz_mask, ny, dly)
        dlz = torch.where(nz_mask, nz, dlz)
        sel = mk == float(MAT_LAMBERTIAN)
        flags = flags | flag(sel, FLG_SEL_L)
        did = did | sel
        sdx = torch.where(sel, dlx, sdx)
        sdy = torch.where(sel, dly, sdy)
        sdz = torch.where(sel, dlz, sdz)
        at0 = torch.where(sel, v0, at0)
        at1 = torch.where(sel, v1, at1)
        at2 = torch.where(sel, v2, at2)

    if MAT_METAL in mat_types:
        dn = ux * nx + uy * ny + uz * nz
        rfx = ux - 2.0 * dn * nx
        rfy = uy - 2.0 * dn * ny
        rfz = uz - 2.0 * dn * nz
        ok = rfx * nx + rfy * ny + rfz * nz > 0.0
        sel = mk == float(MAT_METAL)
        flags = flags | flag(sel, FLG_SEL_M)
        did = did | (sel & ok)
        sdx = torch.where(sel, rfx + fz * ball_x, sdx)
        sdy = torch.where(sel, rfy + fz * ball_y, sdy)
        sdz = torch.where(sel, rfz + fz * ball_z, sdz)
        at0 = torch.where(sel, v0, at0)
        at1 = torch.where(sel, v1, at1)
        at2 = torch.where(sel, v2, at2)

    ratio = full(1.0)
    if MAT_DIELECTRIC in mat_types:
        ratio = torch.where(front, torch.reciprocal(ir_), ir_)
        raw_cos = -(ux * nx + uy * ny + uz * nz)
        cos_t = torch.clamp(raw_cos, max=1.0)
        sin_t = sqrt(torch.clamp(1.0 - cos_t * cos_t, min=0.0))
        cannot = ratio * sin_t > 1.0
        r0 = (1.0 - ratio) / (1.0 + ratio)
        r0 = r0 * r0                       # XLA integer_pow(2)
        one_c = 1.0 - cos_t
        one_c2 = one_c * one_c
        one_c5 = one_c * (one_c2 * one_c2)  # XLA integer_pow(5)
        refl_p = r0 + (1.0 - r0) * one_c5
        choose_reflect = cannot | (refl_p > coin)
        dnu = ux * nx + uy * ny + uz * nz
        rfx = ux - 2.0 * dnu * nx
        rfy = uy - 2.0 * dnu * ny
        rfz = uz - 2.0 * dnu * nz
        # refract (vec3.rs:118-127 via vecmath.refract)
        opx = ratio * (ux + cos_t * nx)
        opy = ratio * (uy + cos_t * ny)
        opz = ratio * (uz + cos_t * nz)
        raw_l = 1.0 - (opx * opx + opy * opy + opz * opz)
        plen = torch.abs(raw_l)
        # vecmath.safe_sqrt: 0 at <= 0
        par = -torch.where(plen <= 0.0, zeros,
                           sqrt(torch.where(plen <= 0.0, full(1.0), plen)))
        rrx = opx + par * nx
        rry = opy + par * ny
        rrz = opz + par * nz
        ddx = torch.where(choose_reflect, rfx, rrx)
        ddy = torch.where(choose_reflect, rfy, rry)
        ddz = torch.where(choose_reflect, rfz, rrz)
        sel = mk == float(MAT_DIELECTRIC)
        flags = (flags | flag(sel, FLG_SEL_D)
                 | flag(choose_reflect, FLG_REFLECT)
                 | flag(raw_cos >= 1.0, FLG_COS_CLAMP)
                 | flag(plen <= 0.0, FLG_REFR_ZERO)
                 | flag(raw_l < 0.0, FLG_L_NEG))
        did = did | sel
        sdx = torch.where(sel, ddx, sdx)
        sdy = torch.where(sel, ddy, sdy)
        sdz = torch.where(sel, ddz, sdz)
        one = full(1.0)
        at0 = torch.where(sel, one, at0)
        at1 = torch.where(sel, one, at1)
        at2 = torch.where(sel, one, at2)

    # ---- state commit (integrator._bounce_step tail) -----------------
    cont = hit & did
    out = {
        "o0": torch.where(cont, px, ox),
        "o1": torch.where(cont, py, oy),
        "o2": torch.where(cont, pz, oz),
        "d0": torch.where(cont, sdx, dx),
        "d1": torch.where(cont, sdy, dy),
        "d2": torch.where(cont, sdz, dz),
        "t0": torch.where(cont, thx * at0, thx),
        "t1": torch.where(cont, thy * at1, thy),
        "t2": torch.where(cont, thz * at2, thz),
        "r0": rdx,
        "r1": rdy,
        "r2": rdz,
        "al": cont.to(f32),
    }
    if not want_residuals:
        return out
    flags = (flags | flag(cont, FLG_CONT) | flag(alive, FLG_ALIVE)
             | (best_i.clamp(min=0).to(torch.int32) << FLG_BESTI_SHIFT))
    res = dict(zip(_RES_KEYS, (t, nx, ny, nz, v0, v1, v2, ratio,
                               flip * w_invr, flags)))
    return out, res


def key_words(lane_keys: torch.Tensor) -> torch.Tensor:
    """(R, 2) lane keys (uint32 words in int64) -> the keyed kernel's
    (2, R) int32 rows, the same 32 bits each."""
    words = torch.where(lane_keys >= 2**31, lane_keys - 2**32, lane_keys)
    return words.T.to(torch.int32).contiguous()


def _lane_keys(keys: torch.Tensor) -> torch.Tensor:
    """``key_words``' inverse: (2, R) int32 rows -> (R, 2) keys."""
    return (keys.T.to(torch.int64) & _M32).contiguous()


def state_cols(state: torch.Tensor) -> Dict[str, torch.Tensor]:
    """A (13, R) state -> the 13 columns keyed by ``_COL_KEYS`` (views)."""
    return dict(zip(_COL_KEYS, state.unbind(0)))


def fused_bounce_keyed_plain(table, bg, seed, state, keys, bounce, *, with_roulette,
                             kinds, mat_types, tex_types, t_min, rr_start=0,
                             winner_out=None, want_residuals=False):
    """The keyed bounce in plain tensor ops; same arguments and result as
    ``fused_bounce_keyed``.  Runs on any device: ``sampling.bounce_draws``
    draws the bounce's uniforms from the keys (at each lane's own depth
    where ``bounce`` is a tensor), ``fused_bounce_cols_plain`` runs the
    bounce on them, then ``roulette`` where ``with_roulette`` is set (on
    the lanes at depth ``rr_start`` or more, for a per-lane ``bounce``)."""
    per_lane = isinstance(bounce, torch.Tensor)
    draw_at = bounce.to(torch.int64) if per_lane else bounce
    su, bu, coin, rl = sampling.bounce_draws(_lane_keys(keys), draw_at, with_roulette)
    out = fused_bounce_cols_plain(
        table, bg, seed, state_cols(state), su[..., 0], su[..., 1], bu[..., 0],
        bu[..., 1], bu[..., 2], coin, kinds=kinds, mat_types=mat_types,
        tex_types=tex_types, t_min=t_min, winner_out=winner_out,
        want_residuals=want_residuals)
    out, res = out if want_residuals else (out, None)
    if with_roulette:
        out, p, act = roulette(out, rl, bounce >= rr_start if per_lane else None)
        if want_residuals:
            res = dict(res, flags=res["flags"] | act.to(torch.int32) * FLG_RR_ACT,
                       rr_p=p)
    out = torch.stack([out[k] for k in _COL_KEYS])
    return (out, res) if want_residuals else out


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------

_MAT_BITS = {MAT_LAMBERTIAN: 1, MAT_METAL: 2, MAT_DIELECTRIC: 4, MAT_LIGHT: 8}
_TEX_BITS = {TEX_SOLID: 1, TEX_CHECKER: 2, TEX_PERLIN: 4}


def _type_flags(types: Sequence[int], bits: Dict[int, int], what: str) -> int:
    flags = 0
    for t in types:
        if t not in bits:
            raise ValueError(f"the fused-bounce kernel has no {what} {t}")
        flags |= bits[t]
    return flags


def _check_table(table, bg, kinds, dev):
    for x in (table, bg):
        if x.device != dev:
            raise ValueError(f"fused_bounce: tensors on {x.device} and {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"fused_bounce: dtype {x.dtype}, want float32")
    if table.dim() != 2 or table.shape[0] != PAY_W or not 0 < table.shape[1] <= MAX_PRIMS:
        raise ValueError(
            f"fused_bounce: table of shape {tuple(table.shape)}, want "
            f"({PAY_W}, P) with 0 < P <= {MAX_PRIMS}")
    if len(kinds) != table.shape[1]:
        raise ValueError("fused_bounce: kinds do not match the table")
    if bg.shape != (3,):
        raise ValueError(f"fused_bounce: bg of shape {tuple(bg.shape)}")


def _check_winner(winner_out, dev, R):
    if winner_out is not None and (
            winner_out.shape != (R,) or winner_out.dtype != torch.int32
            or winner_out.device != dev or not winner_out.is_contiguous()):
        raise ValueError("fused_bounce: winner_out must be a contiguous "
                         f"({R},) int32 tensor on {dev}")


def fused_bounce_keyed(table, bg, seed, state, keys, bounce, *, with_roulette,
                       kinds, mat_types, tex_types, t_min, rr_start=0,
                       winner_out=None, want_residuals=False):
    """One fused bounce over R lanes that draws its own uniforms: the
    main path's K1.

    ``state`` the (13, R) f32 state, rows in ``_COL_KEYS`` order;
    ``keys`` the lanes' threefry keys as (2, R) int32 rows
    (``key_words(lane_keys)``); ``bounce`` the bounce index, or an (R,)
    int32 tensor of each lane's own path depth (the regen wavefront's
    pool, forward only).  Each lane draws the uniforms
    ``sampling.bounce_draws(lane_keys, bounce, with_roulette)`` gives it
    (the purposes its material consumes); with ``with_roulette`` the
    bounce ends in ``roulette`` on the lane's own uniform, for a per-lane
    ``bounce`` only on the lanes whose depth is ``rr_start`` or more.
    ``table``, ``bg``, ``seed``, the static fields and
    ``winner_out`` as in ``fused_bounce_cols_plain``.  Returns the new
    (13, R) state; with ``want_residuals``, ``(state, res)``, ``res`` as
    in ``fused_bounce_cols_plain`` plus, with roulette, ``rr_p``, roulette's (R,)
    p, and the flag FLG_RR_ACT where roulette boosted the lane: what the
    roulette's backward reads.  CUDA tensors launch the kernel; CPU
    tensors run ``fused_bounce_keyed_plain``.

    The host work a call is constant: the state, the keys and the
    outputs are single tensors, passed to the kernel as base pointers.
    """
    dev = table.device
    _check_table(table, bg, kinds, dev)
    if state.dim() != 2 or state.shape[0] != len(_COL_KEYS) or state.device != dev \
            or state.dtype != torch.float32:
        raise ValueError(f"fused_bounce_keyed: state must be a (13, R) float32 "
                         f"tensor on {dev}")
    R = state.shape[1]
    if keys.shape != (2, R) or keys.dtype != torch.int32 or keys.device != dev:
        raise ValueError(f"fused_bounce_keyed: keys must be (2, {R}) int32 rows on {dev}")
    if isinstance(bounce, torch.Tensor):
        if bounce.shape != (R,) or bounce.dtype != torch.int32 or bounce.device != dev:
            raise ValueError(f"fused_bounce_keyed: a per-lane bounce must be ({R},) "
                             f"int32 on {dev}")
        if want_residuals:
            raise ValueError("fused_bounce_keyed: a per-lane bounce is forward only "
                             "(no residuals)")
    elif not 0 <= int(bounce) <= _M32:
        raise ValueError(f"fused_bounce_keyed: bounce {bounce} out of range")
    _check_winner(winner_out, dev, R)
    if dev.type == "cpu":
        return fused_bounce_keyed_plain(
            table, bg, seed, state, keys, bounce, with_roulette=with_roulette,
            kinds=kinds, mat_types=mat_types, tex_types=tex_types, t_min=t_min,
            rr_start=rr_start, winner_out=winner_out, want_residuals=want_residuals)
    if dev.type != "cuda":
        raise ValueError(f"fused_bounce_keyed: no kernel for device {dev}")
    return _launch(table, bg, seed, state, keys, bounce, bool(with_roulette),
                   int(rr_start), mat_types, tex_types, t_min, winner_out,
                   want_residuals)


def _launch(table, bg, seed, state, keys, bounce, with_roulette, rr_start, mat_types,
            tex_types, t_min, winner_out, want_residuals):
    """Launch K1 on the (13, R) ``state`` and (2, R) ``keys`` at ``bounce``
    (an int, or a per-lane (R,) int32 depth); returns the (13, R) state,
    and the residuals with ``want_residuals``."""
    global launches, residual_launches
    from rust_pathtracer_tpu_torch.ops._build import load_library

    lib = load_library("fused_bounce")
    table, bg = table.contiguous(), bg.contiguous()
    state, keys = state.contiguous(), keys.contiguous()
    depth = bounce.contiguous() if isinstance(bounce, torch.Tensor) else None
    dev, R = state.device, state.shape[1]
    out = torch.empty((len(_COL_KEYS), R), dtype=torch.float32, device=dev)
    res_f = flags = None
    if want_residuals:  # nine planes, and roulette's p
        res_f = torch.empty((len(_RES_KEYS) - 1 + int(with_roulette), R),
                            dtype=torch.float32, device=dev)
        flags = torch.empty(R, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        err = lib.fused_bounce_launch(
            table.data_ptr(), table.shape[1], bg.data_ptr(), int(seed) & _M32,
            float(t_min), _type_flags(mat_types, _MAT_BITS, "material"),
            _type_flags(tex_types, _TEX_BITS, "texture"), state.data_ptr(),
            keys.data_ptr(), 0 if depth is not None else int(bounce),
            int(with_roulette), None if depth is None else depth.data_ptr(),
            int(rr_start), out.data_ptr(), None if res_f is None else res_f.data_ptr(),
            None if flags is None else flags.data_ptr(),
            None if winner_out is None else winner_out.data_ptr(), R,
            torch.cuda.current_stream().cuda_stream,
        )
    if err != 0:
        raise RuntimeError(
            f"fused_bounce kernel launch failed: {lib.error_string(err).decode()}")
    launches += 1
    if not want_residuals:
        return out
    residual_launches += 1
    planes = res_f.unbind(0)
    res = dict(zip(_RES_KEYS, (*planes[:len(_RES_KEYS) - 1], flags)))
    if with_roulette:
        res["rr_p"] = planes[-1]
    return out, res


# ---------------------------------------------------------------------------
# the bounce loop with its backward: one autograd.Function
# ---------------------------------------------------------------------------


def roulette(cols, u, sel=None):
    """Russian roulette (``_trace_fused_cols`` :845-869): survivors are
    boosted by 1/p, p = clip(max throughput, 0.05, 1).  ``sel``, an
    optional (R,) bool mask, limits it to those lanes (the regen pool's
    lanes at depth ``rr_start`` or more).  Returns ``(cols, p, act)``;
    ``act`` marks the lanes that were boosted."""
    t0, t1, t2, al = cols["t0"], cols["t1"], cols["t2"], cols["al"]
    p = torch.clamp(torch.maximum(torch.maximum(t0, t1), t2), 0.05, 1.0)
    live = al > 0.5 if sel is None else (al > 0.5) & sel
    act = live & (u < p)
    cols = dict(
        cols,
        t0=torch.where(act, t0 / p, t0),
        t1=torch.where(act, t1 / p, t1),
        t2=torch.where(act, t2 / p, t2),
        al=torch.where(live, act.to(al.dtype), al),
    )
    return cols, p, act


@dataclasses.dataclass(frozen=True)
class _ScanSpec:
    """The static arguments of one whole-scan trace."""

    kinds: Tuple[Tuple[int, int], ...]
    mat_types: Tuple[int, ...]
    tex_types: Tuple[int, ...]
    t_min: float
    max_bounces: int
    rr_start: int
    stats_slots: int


class FusedScanTrace(torch.autograd.Function):
    """All ``max_bounces`` bounces of a fused-diff scene, forward and
    backward (``_make_fused_scan_vjp``, the JAX whole-scan custom VJP).

    Forward: exactly ``max_bounces`` bounces, no early exit (dead lanes
    pass through, so the image equals the early-exit loop's).  Each
    bounce counts its alive lanes (detached statistics) and runs the
    keyed K1 with residuals, which draws the bounce's uniforms and, from
    ``rr_start`` on, applies roulette.  It saves the ten residual planes
    and the incoming d and thr, 16 (R,) planes a bounce, plus roulette's
    p where roulette ran (its act is a flag bit).

    Backward: the bounces in reverse.  Each undoes roulette
    (``where(act, g / p, g)``, a division as in the JAX transpose),
    runs K2 and adds the bounce's texture-colour and background
    gradients.  The radiance cotangent passes through unchanged, alive
    gets none, and neither do the draws.

    ``apply(spec, keys, table, bg, *cols)`` with ``keys`` the (2, R)
    int32 key rows (``key_words``) and the 13 columns in ``_COL_KEYS``
    order returns the 13 final columns, the segment count and the
    occupancy histogram.
    """

    @staticmethod
    def forward(ctx, spec, keys, table, bg, *cols):
        state = torch.stack(cols)
        dev = table.device
        segments = torch.zeros((), dtype=torch.float32, device=dev)
        occupancy = torch.zeros(spec.stats_slots, dtype=torch.float32, device=dev)
        saved = []
        for b in range(spec.max_bounces):
            n_alive = state[12].sum()
            segments = segments + n_alive
            occupancy[min(b, spec.stats_slots - 1)] = n_alive
            d_thr = state[3:9].clone()  # d0 d1 d2 t0 t1 t2 coming in
            state, res = fused_bounce_keyed(
                table, bg, 0, state, keys, b, with_roulette=b >= spec.rr_start,
                kinds=spec.kinds, mat_types=spec.mat_types,
                tex_types=spec.tex_types, t_min=spec.t_min, want_residuals=True)
            saved.append((res, d_thr))
        ctx.spec = spec
        ctx.bounces = saved
        ctx.save_for_backward(table, bg)
        ctx.mark_non_differentiable(segments, occupancy)
        return (*state.unbind(0), segments, occupancy)

    @staticmethod
    def backward(ctx, *g_out):
        from rust_pathtracer_tpu_torch.ops.fused_bounce_bwd import fused_bounce_bwd

        table, bg = ctx.saved_tensors
        P = table.shape[1]
        g = dict(zip(_COL_KEYS, g_out[:len(_COL_KEYS)]))
        d_tex = torch.zeros((9, P), dtype=torch.float32, device=table.device)
        d_bg = torch.zeros(3, dtype=torch.float32, device=table.device)
        saved, ctx.bounces = ctx.bounces, None
        if saved is None:
            raise RuntimeError("FusedScanTrace: a second backward through one "
                               "graph; the saved bounces went with the first")
        while saved:  # last bounce first; each bounce's tensors go as it is done
            res, d_thr = saved.pop()
            if "rr_p" in res:  # undo roulette
                res = dict(res)
                p = res.pop("rr_p")
                act = (res["flags"] & FLG_RR_ACT) != 0
                g = dict(g, **{k: torch.where(act, g[k] / p, g[k])
                               for k in ("t0", "t1", "t2")})
            grads, g_tex, g_bg = fused_bounce_bwd(
                res, d_thr[0:3].unbind(0), d_thr[3:6].unbind(0), g, bg,
                mat_types=ctx.spec.mat_types, n_prims=P)
            g = dict(g, **grads)  # the radiance cotangent passes through
            d_tex = d_tex + g_tex
            d_bg = d_bg + g_bg
        d_table = torch.zeros_like(table)
        d_table[PAY_COLOR:PAY_EVEN + 3] = d_tex
        g_cols = [g[k] for k in _COL_KEYS[:-1]] + [None]  # alive: none
        return (None, None, d_table, d_bg, *g_cols)


def fused_scan_trace(scene, cols, keys, background, t_min, max_bounces,
                     rr_start, stats_slots):
    """Differentiable whole-scan trace of a fused-diff scene
    (``fused_bounce_diff_ok``): ``FusedScanTrace`` over the packed table.

    ``cols`` the 13 state columns; ``keys`` the lanes' (2, R) int32 key
    rows (``key_words``); ``background`` a (3,) tensor.
    Returns ``(cols_final, segments, occupancy)``.  Gradients reach the
    columns, ``scene.textures.color`` (through ``pack_prims_shaded``) and
    ``background``.
    """
    spec = _ScanSpec(
        kinds=scene.kinds_static, mat_types=scene.mat_types,
        tex_types=scene.tex_types, t_min=float(t_min),
        max_bounces=int(max_bounces), rr_start=int(rr_start),
        stats_slots=int(stats_slots))
    out = FusedScanTrace.apply(spec, keys, pack_prims_shaded(scene),
                               background, *[cols[k] for k in _COL_KEYS])
    n = len(_COL_KEYS)
    return dict(zip(_COL_KEYS, out[:n])), out[n], out[n + 1]
