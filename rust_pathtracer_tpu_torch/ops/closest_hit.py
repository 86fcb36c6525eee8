"""Closest hit over a static list of at most 128 primitives: K3 and K4.

Counterpart of ``rust_pathtracer_tpu/ops/pallas_intersect.py``.  This
module wraps two CUDA kernels (``csrc/closest_hit.cu``) and holds their
plain PyTorch twins, which follow the Pallas kernels op for op:

* ``closest_hit`` (K4, replaces ``_kernel``): the detached search of
  the differentiable generic route, ``(hit, t, idx)`` with
  ``t = T_MISS`` and ``idx = 0`` on a miss;
* ``closest_hit_record`` (K3, replaces ``_kernel_shade``): the search
  and the whole hit record of the non-differentiable generic route,
  ``(hit, t, idx, HitRecord)`` with ``t = 1`` on a miss.  Its record is
  the Pallas kernel's, not ``intersect.record_from_rows``: the sphere
  normal is ``(o + t d - c) * (1 / r)`` and the sphere uv takes plain
  ``acos`` / ``atan2`` (the XLA epilogue of the Pallas kernel, here
  inside the kernel).

The sweep: sphere half-b with the nearest root in ``[t_min, best]`` and
true divisions, the rect plane solve, one-sided Moller-Trumbore with
the ``|det| > 1e-30`` guard, and the strict ``t < best`` update, so the
first primitive wins a tie.  Dead lanes are swept like live ones, as
in the JAX package; the integrator masks them afterwards.

Both wrappers dispatch on where their tensors lie: CUDA tensors launch
the kernel (and count in ``hit_launches`` / ``record_launches``), whose
outputs are views of one buffer (``carve``); CPU tensors run the plain
version; anything else raises.
"""

from __future__ import annotations

import contextlib
import math

import torch

from rust_pathtracer_tpu_torch.ops.intersect import (
    INV_PI,
    INV_TWO_PI,
    MAX_PRIMS,
    RECT_FREE,
    T_MISS,
    TRI_DET_EPS,
    HitRecord,
)
from rust_pathtracer_tpu_torch.scene.types import (
    PRIM_RECT,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    Primitives,
)
from rust_pathtracer_tpu_torch.vecmath import sqrt

TABLE_ROWS = 16  # rows 0-11 data, 12 kind, 13 aux, 14 mat, 15 zero

# kernel launches made by the wrappers (CUDA tensors only): K4's and K3's
hit_launches = 0
record_launches = 0


def pack_prims(prims: Primitives) -> torch.Tensor:
    """(16, P) f32 table: rows 0-11 data, 12 kind, 13 aux, 14 mat
    (``pallas_intersect.pack_prims``)."""
    f32 = torch.float32
    extra = torch.stack([prims.kind.to(f32), prims.aux.to(f32),
                         prims.mat.to(f32), torch.zeros_like(prims.kind, dtype=f32)])
    return torch.cat([prims.data.T.to(f32), extra], dim=0).contiguous()


# ---------------------------------------------------------------------------
# plain PyTorch versions (the Pallas kernels op for op)
# ---------------------------------------------------------------------------


def prim_candidate(table, p, kind, aux, o_c, d_c, a, t_min, best_t, uv=False):
    """Primitive ``p``'s candidate hit for every lane, as the Pallas
    sweeps compute it: a dict with ``t``, ``valid``, the outward normal
    ``n`` (3 planes), ``inv_r`` (a sphere's 1/r, else None) and, with
    ``uv``, a rect's ``u`` and ``v`` (zeros for the other kinds).
    ``o_c`` / ``d_c`` are the ray's component planes, ``a`` = |d|^2 and
    ``best_t`` the running minimum.  Shared with K1's plain twin."""
    ox, oy, oz = o_c
    dx, dy, dz = d_c

    def s(row):
        return table[row, p]

    zeros = torch.zeros_like(ox)
    inv_r = None
    u = v = zeros
    if kind == PRIM_SPHERE:
        cx, cy, cz, r = s(0), s(1), s(2), s(3)
        ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
        half_b = dx * ocx + dy * ocy + dz * ocz
        c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
        dis = half_b * half_b - a * c
        sqrtd = sqrt(torch.clamp(dis, min=0.0))
        root1 = (-half_b - sqrtd) / a
        root2 = (-half_b + sqrtd) / a
        ok1 = (root1 >= t_min) & (root1 <= best_t)
        ok2 = (root2 >= t_min) & (root2 <= best_t)
        t = torch.where(ok1, root1, root2)
        valid = (dis >= 0.0) & (ok1 | ok2)
        inv_r = torch.reciprocal(r)
        n = ((ox + t * dx - cx) * inv_r, (oy + t * dy - cy) * inv_r,
             (oz + t * dz - cz) * inv_r)
    elif kind == PRIM_RECT:
        k, a0, b0, a1, b1, sgn = s(0), s(1), s(2), s(3), s(4), s(5)
        fa, fb = RECT_FREE[aux]
        t = (k - o_c[aux]) / d_c[aux]
        av = o_c[fa] + t * d_c[fa]
        bv = o_c[fb] + t * d_c[fb]
        valid = ((t >= t_min) & (t <= best_t)
                 & (av >= a0) & (av <= a1) & (bv >= b0) & (bv <= b1))
        comp = [zeros, zeros, zeros]
        comp[aux] = torch.ones_like(ox) * sgn
        n = tuple(comp)
        if uv:
            u = (av - a0) / (a1 - a0)
            v = (bv - b0) / (b1 - b0)
    elif kind == PRIM_TRIANGLE:
        p1x, p1y, p1z = s(0), s(1), s(2)
        e1x, e1y, e1z = s(3), s(4), s(5)
        e2x, e2y, e2z = s(6), s(7), s(8)
        pvx = dy * e2z - dz * e2y
        pvy = dz * e2x - dx * e2z
        pvz = dx * e2y - dy * e2x
        det = e1x * pvx + e1y * pvy + e1z * pvz
        inv_det = torch.reciprocal(
            torch.where(torch.abs(det) > 1e-30, det, torch.ones_like(det)))
        tvx, tvy, tvz = ox - p1x, oy - p1y, oz - p1z
        uu = (tvx * pvx + tvy * pvy + tvz * pvz) * inv_det
        qvx = tvy * e1z - tvz * e1y
        qvy = tvz * e1x - tvx * e1z
        qvz = tvx * e1y - tvy * e1x
        vv = (dx * qvx + dy * qvy + dz * qvz) * inv_det
        t = (e2x * qvx + e2y * qvy + e2z * qvz) * inv_det
        valid = ((det >= TRI_DET_EPS)
                 & (uu >= 0.0) & (uu <= 1.0) & (vv >= 0.0) & (uu + vv <= 1.0)
                 & (t >= t_min) & (t <= best_t))
        one = torch.ones_like(ox)
        n = (one * s(9), one * s(10), one * s(11))
    else:
        raise ValueError(f"unknown static kind {kind}")
    return dict(t=t, valid=valid, n=n, inv_r=inv_r, u=u, v=v)


def _planes(o, d):
    return (o[:, 0], o[:, 1], o[:, 2]), (d[:, 0], d[:, 1], d[:, 2])


def closest_hit_plain(table, o, d, *, kinds, t_min):
    """K4 in plain tensor ops; same arguments and result as
    ``closest_hit``.  Runs on any device."""
    o_c, d_c = _planes(o, d)
    a = d_c[0] * d_c[0] + d_c[1] * d_c[1] + d_c[2] * d_c[2]
    best_t = torch.full_like(a, T_MISS)
    best_i = torch.full(a.shape, -1, dtype=torch.int32, device=a.device)
    for p, (kind, aux) in enumerate(kinds):
        c = prim_candidate(table, p, kind, aux, o_c, d_c, a, t_min, best_t)
        upd = c["valid"] & (c["t"] < best_t)
        best_t = torch.where(upd, c["t"], best_t)
        best_i = torch.where(upd, p, best_i)
    hit = best_i >= 0
    return hit, best_t, best_i.clamp(min=0)


def closest_hit_record_plain(table, o, d, *, kinds, t_min):
    """K3 in plain tensor ops; same arguments and result as
    ``closest_hit_record``.  Runs on any device."""
    o_c, d_c = _planes(o, d)
    dx, dy, dz = d_c
    a = dx * dx + dy * dy + dz * dz
    zeros = torch.zeros_like(a)
    best_t = torch.full_like(a, T_MISS)
    best_i = torch.full(a.shape, -1, dtype=torch.int32, device=a.device)
    wkind = torch.full(a.shape, -1, dtype=torch.int32, device=a.device)
    wnx = wny = wnz = wu = wv = wmat = zeros
    for p, (kind, aux) in enumerate(kinds):
        c = prim_candidate(table, p, kind, aux, o_c, d_c, a, t_min, best_t, uv=True)
        upd = c["valid"] & (c["t"] < best_t)
        best_t = torch.where(upd, c["t"], best_t)
        best_i = torch.where(upd, p, best_i)
        wkind = torch.where(upd, kind, wkind)
        nx, ny, nz = c["n"]
        wnx = torch.where(upd, nx, wnx)
        wny = torch.where(upd, ny, wny)
        wnz = torch.where(upd, nz, wnz)
        wu = torch.where(upd, c["u"], wu)
        wv = torch.where(upd, c["v"], wv)
        wmat = torch.where(upd, table[14, p], wmat)

    front = dx * wnx + dy * wny + dz * wnz < 0.0  # on the outward normal
    hit = best_i >= 0
    t = torch.where(hit, best_t, torch.ones_like(best_t))  # finite t on a miss
    # sphere uv from the outward normal (geometry.rs:120-128)
    is_sphere = wkind == PRIM_SPHERE
    theta = torch.acos(torch.clamp(-wny, -1.0, 1.0))
    phi = torch.atan2(-wnz, torch.where(is_sphere, wnx, torch.ones_like(wnx))) + math.pi
    u = torch.where(is_sphere, phi * INV_TWO_PI, wu)
    v = torch.where(is_sphere, theta * INV_PI, wv)
    flip = torch.where(front, 1.0, -1.0)
    normal = torch.stack([wnx * flip, wny * flip, wnz * flip], dim=1)
    point = o + t[:, None] * d
    idx = best_i.clamp(min=0)
    rec = HitRecord(valid=hit, t=t, point=point, normal=normal, front_face=front,
                    u=u, v=v, mat=wmat.to(torch.int32), prim=idx)
    return hit, t, idx, rec


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

# The launch's one output buffer (``closest_hit_launch`` in
# csrc/closest_hit.cu): R lanes rounded up to PAD_LANES (Rp), each plane at
# a byte offset that is a multiple of 16.  name -> (offset in units of Rp,
# bytes a lane, dtype); point and normal are (R, 3) row-major.
PAD_LANES = 16
K4_PLANES = {"t": (0, 4, torch.float32), "idx": (4, 4, torch.int32),
             "hit": (8, 1, torch.bool)}
K3_PLANES = {"point": (0, 12, torch.float32), "normal": (12, 12, torch.float32),
             "t": (24, 4, torch.float32), "u": (28, 4, torch.float32),
             "v": (32, 4, torch.float32), "idx": (36, 4, torch.int32),
             "mat": (40, 4, torch.int32), "hit": (44, 1, torch.bool),
             "front": (45, 1, torch.bool)}
OUT_BYTES_A_LANE = {False: 9, True: 46}  # Rp times this is the buffer's size

_entry = None  # the library's closest_hit_launch, looked up at first use


def _check_inputs(name, table, o, d, kinds):
    dev = table.device
    for x in (table, o, d):
        if x.device != dev:
            raise ValueError(f"{name}: tensors on {x.device} and {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {x.dtype}, want float32")
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"{name}: rays of shape {tuple(o.shape)} and "
                         f"{tuple(d.shape)}, want (R, 3) both")
    P = table.shape[1] if table.dim() == 2 else -1
    if table.dim() != 2 or table.shape[0] != TABLE_ROWS or not 0 < P <= MAX_PRIMS:
        raise ValueError(f"{name}: table of shape {tuple(table.shape)}, want "
                         f"({TABLE_ROWS}, P) with 0 < P <= {MAX_PRIMS}")
    if len(kinds) != P:
        raise ValueError(f"{name}: kinds do not match the table")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def closest_hit(table, o, d, *, kinds, t_min):
    """K4: the closest hit of each ray.  ``table`` (16, P) from
    ``pack_prims``; ``o``, ``d`` (R, 3) f32; ``kinds`` the scene's
    ``kinds_static``.  Returns ``(hit (R,) bool, t (R,) f32, idx (R,)
    int32)`` with ``t = T_MISS`` and ``idx = 0`` on a miss."""
    dev = _check_inputs("closest_hit", table, o, d, kinds)
    if dev.type == "cpu":
        return closest_hit_plain(table, o, d, kinds=kinds, t_min=t_min)
    out = _launch("closest_hit", table, o, d, t_min, False)
    global hit_launches
    hit_launches += o.shape[0] > 0
    return out["hit"], out["t"], out["idx"]


def closest_hit_record(table, o, d, *, kinds, t_min):
    """K3: the closest hit and its hit record.  Arguments as
    ``closest_hit``.  Returns ``(hit, t, idx, HitRecord)`` with
    ``t = 1`` and ``idx = 0`` on a miss; the record's ``valid`` is
    ``hit``, its normal faces the ray, its ``mat`` and ``prim`` are
    int32."""
    dev = _check_inputs("closest_hit_record", table, o, d, kinds)
    if dev.type == "cpu":
        return closest_hit_record_plain(table, o, d, kinds=kinds, t_min=t_min)
    out = _launch("closest_hit_record", table, o, d, t_min, True)
    global record_launches
    record_launches += o.shape[0] > 0
    hit, t, idx = out["hit"], out["t"], out["idx"]
    rec = HitRecord(valid=hit, t=t, point=out["point"], normal=out["normal"],
                    front_face=out["front"], u=out["u"], v=out["v"], mat=out["mat"],
                    prim=idx)
    return hit, t, idx, rec


def carve(buf, R, record):
    """The typed views of a launch's output buffer (``buf``, f32 of
    ``OUT_BYTES_A_LANE[record]`` x Rp bytes) over R lanes: one view of
    the buffer a dtype, and one strided view of it a plane."""
    rp = -(-R // PAD_LANES) * PAD_LANES
    typed = {torch.float32: buf, torch.int32: buf.view(torch.int32),
             torch.bool: buf.view(torch.bool)}
    views = {}
    for name, (at, width, dtype) in (K3_PLANES if record else K4_PLANES).items():
        x = typed[dtype]
        offset = at * rp // x.element_size()
        views[name] = (x.as_strided((R, 3), (3, 1), offset) if width == 12
                       else x.as_strided((R,), (1,), offset))
    return views


def _launch(name, table, o, d, t_min, record):
    """One launch of K3 (``record``) or K4 on CUDA tensors; returns the
    output planes by name (``carve``)."""
    global _entry
    if _entry is None:
        from rust_pathtracer_tpu_torch.ops._build import load_library

        _entry = load_library("closest_hit").closest_hit_launch
    table, o, d = table.contiguous(), o.contiguous(), d.contiguous()
    R = o.shape[0]
    dev = o.device
    # one block of the caching allocator, no fill: the kernel writes every
    # lane of every plane
    buf = torch.empty(OUT_BYTES_A_LANE[record] * (-(-R // PAD_LANES) * PAD_LANES) // 4,
                      dtype=torch.float32, device=dev)
    current = dev.index is None or dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(dev):
        err = _entry(table.data_ptr(), table.shape[1], o.data_ptr(), d.data_ptr(),
                     float(t_min), int(record), buf.data_ptr(), R,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        from rust_pathtracer_tpu_torch.ops._build import load_library

        raise RuntimeError(f"{name} kernel launch failed: "
                           f"{load_library('closest_hit').error_string(err).decode()}")
    return carve(buf, R, record)
