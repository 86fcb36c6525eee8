"""The backward of one fused bounce: the kernel K2.

Counterpart of ``_bwd_kernel`` / ``_bwd_call`` and of the reductions of
``_bounce_grads`` in ``rust_pathtracer_tpu/ops/fused_bounce.py``.  This
module wraps a CUDA kernel (``csrc/fused_bounce_bwd.cu``, which
replaces the Pallas ``_bwd_kernel``) and holds its plain PyTorch twin.

Per lane, the closed-form VJP of one bounce under the detached-sampling
estimator: the residuals K1 wrote (``fused_bounce._RES_KEYS``), the
incoming direction ``d`` and the cotangents of the outgoing
(o, d, thr, rad) in; the cotangents of the incoming (o, d, thr) out.
Discrete events (hit, material, dielectric coin, checker pick) are
detached; ``t`` is linearised implicitly (dt/do = -n/(n.d)); a sphere's
normal follows the hit point (dn/dp = flip/r).

The kernel also reduces what the bounce owes the scene: the texture
colour rows of the packed table (each hit lane's value gradient, routed
to its winning primitive's solid, checker-odd or checker-even row) and
the background (each miss lane's radiance cotangent times its
throughput).  On the card that is per-block partials summed in a fixed
order, so the result is the same bit for bit on every run.

``fused_bounce_bwd`` dispatches on where its tensors lie: CUDA tensors
launch the kernel (and count in ``launches``); CPU tensors run
``fused_bounce_bwd_plain``, which follows the JAX package's ``_bwd_xla``
(the jnp twin of ``_bwd_kernel``) op for op and its one-hot reduction.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Sequence, Tuple

import torch

from rust_pathtracer_tpu_torch.ops.fused_bounce import (
    _MAT_BITS,
    _RES_KEYS,
    FLG_ALIVE,
    FLG_BESTI_SHIFT,
    FLG_CONT,
    FLG_COS_CLAMP,
    FLG_HIT,
    FLG_IS_CK,
    FLG_L_NEG,
    FLG_LIGHT_ON,
    FLG_REFLECT,
    FLG_REFR_ZERO,
    FLG_SEL_D,
    FLG_SEL_L,
    FLG_SEL_M,
    FLG_SINES_NEG,
    MAX_PRIMS,
    _type_flags,
)
from rust_pathtracer_tpu_torch.scene.types import MAT_DIELECTRIC, MAT_METAL
from rust_pathtracer_tpu_torch.vecmath import _SAFE_EPS, sqrt

# the cotangents K2 reads: of the outgoing o, d, thr and rad
_COT_KEYS = ("o0", "o1", "o2", "d0", "d1", "d2", "t0", "t1", "t2",
             "r0", "r1", "r2")
# the cotangents K2 writes: of the incoming o, d and thr
_GRAD_KEYS = ("o0", "o1", "o2", "d0", "d1", "d2", "t0", "t1", "t2")

# kernel launches made by fused_bounce_bwd (CUDA tensors only)
launches = 0


def _dot(a, b):
    return a[0] * b[0] + a[1] * b[1] + a[2] * b[2]


def fused_bounce_bwd_plain(res, d, thr, cots, bg, *, mat_types, n_prims):
    """One bounce's backward in plain tensor ops; same arguments and
    result as ``fused_bounce_bwd``.  Runs on any device."""
    flags = res["flags"]

    def bit(b):
        return (flags & b) != 0

    def m(mask):
        return mask.to(d[0].dtype)

    hit, cont, reflect = bit(FLG_HIT), bit(FLG_CONT), bit(FLG_REFLECT)
    sel_l = bit(FLG_SEL_L) & cont
    sel_m = bit(FLG_SEL_M) & cont
    sel_d = bit(FLG_SEL_D) & cont
    light_on = bit(FLG_LIGHT_ON)
    cos_clamp, refr_zero, l_neg = bit(FLG_COS_CLAMP), bit(FLG_REFR_ZERO), bit(FLG_L_NEG)
    miss = bit(FLG_ALIVE) & ~hit

    n = (res["nx"], res["ny"], res["nz"])
    val = (res["v0"], res["v1"], res["v2"])
    rr, invr, t = res["ratio"], res["invr"], res["t"]
    g_o2 = tuple(cots[k] for k in ("o0", "o1", "o2"))
    g_d2 = tuple(cots[k] for k in ("d0", "d1", "d2"))
    g_thr2 = tuple(cots[k] for k in ("t0", "t1", "t2"))
    g_rad2 = tuple(cots[k] for k in ("r0", "r1", "r2"))

    a = _dot(d, d)
    sa = sqrt(torch.clamp(a, min=_SAFE_EPS))
    u = tuple(x / sa for x in d)

    g_dir = tuple(m(cont) * x for x in g_d2)
    g_n = tuple(m(sel_l) * x for x in g_dir)  # lambertian: dir = n + sph
    g_u = tuple(torch.zeros_like(x) for x in d)

    if MAT_METAL in mat_types or MAT_DIELECTRIC in mat_types:
        refl_m = sel_m | (sel_d & reflect)
        s = _dot(u, n)
        gr = tuple(m(refl_m) * x for x in g_dir)
        ngr = _dot(n, gr)
        g_u = tuple(g_u[c] + gr[c] - 2.0 * n[c] * ngr for c in range(3))
        g_n = tuple(g_n[c] - 2.0 * (u[c] * ngr + s * gr[c]) for c in range(3))

    if MAT_DIELECTRIC in mat_types:
        rm = sel_d & ~reflect
        gout = tuple(m(rm) * x for x in g_dir)
        raw_cos = -_dot(u, n)
        cos = torch.clamp(raw_cos, max=1.0)
        perp = tuple(rr * (u[c] + cos * n[c]) for c in range(3))
        abs_l = torch.abs(1.0 - _dot(perp, perp))
        s_par = torch.where(refr_zero, 0.0, sqrt(abs_l))
        g_spar = -_dot(n, gout)
        g_n = tuple(g_n[c] - s_par * gout[c] for c in range(3))
        g_absl = torch.where(refr_zero, 0.0,
                             g_spar / torch.clamp(2.0 * s_par, min=1e-30))
        sign = torch.where(l_neg, -1.0, 1.0)
        g_perp = tuple(gout[c] - 2.0 * perp[c] * (sign * g_absl)
                       for c in range(3))
        g_u = tuple(g_u[c] + rr * g_perp[c] for c in range(3))
        g_n = tuple(g_n[c] + rr * cos * g_perp[c] for c in range(3))
        g_cos = torch.where(cos_clamp, 0.0, rr * _dot(n, g_perp))
        g_u = tuple(g_u[c] - n[c] * g_cos for c in range(3))
        g_n = tuple(g_n[c] - u[c] * g_cos for c in range(3))

    # u = d/|d| -> d
    udg = _dot(u, g_u)
    g_d = tuple(m(~cont) * g_d2[c] + (g_u[c] - u[c] * udg) / sa
                for c in range(3))

    # throughput: attenuation, miss background, light emission
    lm = sel_l | sel_m
    g_thr = tuple(
        torch.where(cont, torch.where(lm, val[c], 1.0) * g_thr2[c], g_thr2[c])
        + m(miss) * bg[c] * g_rad2[c] + m(light_on) * val[c] * g_rad2[c]
        for c in range(3))

    # normal -> hit point (sphere dn/dp = flip/r); point = o + t(o, d) d
    g_point = tuple(m(cont) * g_o2[c] + invr * g_n[c] for c in range(3))
    g_t = _dot(d, g_point)
    g_o = tuple(m(~cont) * g_o2[c] + g_point[c] for c in range(3))
    g_d = tuple(g_d[c] + t * g_point[c] for c in range(3))
    den = _dot(n, d)
    den = torch.where(torch.abs(den) < 1e-30, 1.0, den)
    g_o = tuple(g_o[c] + g_t * (-n[c] / den) for c in range(3))
    g_d = tuple(g_d[c] + g_t * (-t * n[c] / den) for c in range(3))

    # ---- reductions (_bounce_grads): background and texture colours ----
    g_bg = torch.stack([torch.sum(m(miss) * thr[c] * g_rad2[c])
                        for c in range(3)])
    lonf = m(light_on)
    g_val = [m(lm) * thr[c] * g_thr2[c] + lonf * thr[c] * g_rad2[c]
             for c in range(3)]
    is_ck, sines_neg = bit(FLG_IS_CK), bit(FLG_SINES_NEG)
    targets = (hit & ~is_ck, is_ck & sines_neg, is_ck & ~sines_neg)
    gv9 = torch.stack([g_val[c] * m(mask) for mask in targets
                       for c in range(3)], dim=1)                  # (R, 9)
    best_i = flags >> FLG_BESTI_SHIFT
    prims = torch.arange(n_prims, dtype=best_i.dtype, device=best_i.device)
    onehot = m((best_i[:, None] == prims[None, :]) & hit[:, None])  # (R, P)
    g_tex = (onehot.T @ gv9).T                                     # (9, P)

    grads = dict(zip(_GRAD_KEYS, (*g_o, *g_d, *g_thr)))
    return grads, g_tex.contiguous(), g_bg


# ---------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------


def _check_inputs(res, d, thr, cots, bg, n_prims) -> Tuple[torch.device, int]:
    if set(res) != set(_RES_KEYS) or not set(_COT_KEYS) <= set(cots):
        raise ValueError("fused_bounce_bwd: want the residuals "
                         f"{_RES_KEYS} and the cotangents {_COT_KEYS}")
    floats = ([res[k] for k in _RES_KEYS[:-1]] + list(d) + list(thr)
              + [cots[k] for k in _COT_KEYS])
    flags = res["flags"]
    dev, R = flags.device, flags.shape[0]
    for x in (*floats, flags, bg):
        if x.device != dev:
            raise ValueError(f"fused_bounce_bwd: tensors on {x.device} and {dev}")
    for x in (*floats, bg):
        if x.dtype != torch.float32:
            raise TypeError(f"fused_bounce_bwd: dtype {x.dtype}, want float32")
    if flags.dtype != torch.int32:
        raise TypeError(f"fused_bounce_bwd: flags of dtype {flags.dtype}, want int32")
    for x in (*floats, flags):
        if x.shape != (R,):
            raise ValueError(
                f"fused_bounce_bwd: column of shape {tuple(x.shape)}, want ({R},)")
    if bg.shape != (3,):
        raise ValueError(f"fused_bounce_bwd: bg of shape {tuple(bg.shape)}")
    if not 0 < n_prims <= MAX_PRIMS:
        raise ValueError(f"fused_bounce_bwd: {n_prims} primitives, want 1..{MAX_PRIMS}")
    return dev, R


def fused_bounce_bwd(res: Dict[str, torch.Tensor], d: Sequence[torch.Tensor],
                     thr: Sequence[torch.Tensor], cots: Dict[str, torch.Tensor],
                     bg: torch.Tensor, *, mat_types, n_prims: int):
    """The backward of one fused bounce over R lanes.

    ``res`` K1's residuals (``_RES_KEYS``); ``d`` and ``thr`` the
    bounce's incoming direction and throughput, each 3 (R,) columns;
    ``cots`` the cotangents of its outgoing columns, keyed ``o0 .. r2``;
    ``bg`` (3,) the background; ``mat_types`` the scene's static field;
    ``n_prims`` the packed table's width P.

    Returns ``(grads, g_tex, g_bg)``: ``grads`` the cotangents of the
    incoming o, d and thr (keys ``o0 .. t2``), ``g_tex`` (9, P) the
    gradient of the packed table's rows 21-29 (solid, checker-odd and
    checker-even colours), ``g_bg`` (3,).  CUDA tensors launch the
    kernel; CPU tensors run the plain version; anything else raises.
    """
    dev, R = _check_inputs(res, d, thr, cots, bg, n_prims)
    if dev.type == "cpu":
        return fused_bounce_bwd_plain(res, d, thr, cots, bg,
                                      mat_types=mat_types, n_prims=n_prims)
    if dev.type != "cuda":
        raise ValueError(f"fused_bounce_bwd: no kernel for device {dev}")
    return _launch(res, d, thr, cots, bg, mat_types, n_prims, R)


def _launch(res, d, thr, cots, bg, mat_types, n_prims, R):
    global launches
    from rust_pathtracer_tpu_torch.ops._build import load_library

    lib = load_library("fused_bounce_bwd")
    ins = ([res[k] for k in _RES_KEYS] + list(d) + list(thr)
           + [cots[k] for k in _COT_KEYS])
    ins = [x.contiguous() for x in ins]
    bg = bg.contiguous()
    dev = bg.device
    outs = torch.empty((len(_GRAD_KEYS), R), dtype=torch.float32, device=dev)
    n_slots = 9 * n_prims + 3
    n_blocks = lib.fused_bounce_bwd_blocks(R)
    partials = torch.empty((max(n_blocks, 1), n_slots), dtype=torch.float32,
                           device=dev)
    reduced = torch.zeros(n_slots, dtype=torch.float32, device=dev)
    in_ptrs = (ctypes.c_void_p * len(ins))(*[x.data_ptr() for x in ins])
    out_ptrs = (ctypes.c_void_p * len(_GRAD_KEYS))(
        *[outs[i].data_ptr() for i in range(len(_GRAD_KEYS))])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.fused_bounce_bwd_launch(
            in_ptrs, out_ptrs, bg.data_ptr(),
            _type_flags(mat_types, _MAT_BITS, "material"), n_prims,
            partials.data_ptr(), reduced.data_ptr(), R, stream)
    if err != 0:
        raise RuntimeError(
            f"fused_bounce_bwd kernel launch failed: {lib.error_string(err).decode()}")
    launches += 1
    grads = dict(zip(_GRAD_KEYS, outs.unbind(0)))
    return grads, reduced[:9 * n_prims].view(9, n_prims), reduced[9 * n_prims:]
