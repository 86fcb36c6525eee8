"""Hit records on the primitive tables, in plain tensor ops.

Counterpart of ``rust_pathtracer_tpu/ops/intersect.py``: the constants,
``HitRecord``, ``gather_prim_rows``, ``record_from_rows``,
``hit_record`` and the differentiable re-intersection of one primitive
a lane, ``prim_intersect_t`` (``sphere_t``, ``rect_t``, ``triangle_t``),
which the geometry gradient (``integrator``, ``diff_t="rederive"``)
runs on the winner's row.  The record is the differentiable route's:
sphere uv through ``safe_acos`` / ``safe_atan2``, rect uv through
``_safe_div``, so that no branch that ``where`` leaves out puts a NaN
into the backward; the distances keep the JAX package's guards for the
same reason.  The distances are K4's to the bit: a sphere's quadratic
in f64 with ``closest_hit.sphere_roots``' operations in its order (the
JAX package's is f32), rects and triangles in f32 in the kernel's order,
sums written out, the rect's fixed axis picked by index.  The
closest-hit search itself is the kernels' work (``closest_hit.py``, K3
and K4).

Not ported: the JAX brute-force and BVH searches (ROADMAP queue 1,
item 10).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from rust_pathtracer_tpu_torch import vecmath as vm
from rust_pathtracer_tpu_torch.scene.types import (
    PRIM_RECT,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    Primitives,
)

# sentinel "no hit" distance: large but finite, so arithmetic stays
# NaN-free
T_MISS = 3.0e38

TRI_DET_EPS = 1e-4  # one-sided cull threshold (geometry.rs:526)

# largest static primitive list (the kernels' table width)
MAX_PRIMS = 128

# rect fixed axis -> the two free axes (a, b), ascending (types.py layout)
RECT_FREE = {0: (1, 2), 1: (0, 2), 2: (0, 1)}

# f32 1/(2 pi) and 1/pi, the sphere-uv scale factors
INV_TWO_PI = 0.15915494
INV_PI = 0.31830987


class HitRecord(NamedTuple):
    """Vectorized HitRecord (geometry.rs:9-41)."""

    valid: torch.Tensor       # bool (R,)
    t: torch.Tensor           # f32 (R,)
    point: torch.Tensor       # f32 (R, 3)
    normal: torch.Tensor      # f32 (R, 3), flipped to oppose the ray
    front_face: torch.Tensor  # bool (R,)
    u: torch.Tensor           # f32 (R,)
    v: torch.Tensor           # f32 (R,)
    mat: torch.Tensor         # int32 (R,)
    prim: torch.Tensor        # int32 (R,)


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    den = torch.where(torch.abs(den) < 1e-30, torch.ones_like(den), den)
    return num / den


def axis_onehot(axis: torch.Tensor) -> torch.Tensor:
    """(R,) axis index -> (R, 3) f32 one-hot."""
    return (axis[..., None].long()
            == torch.arange(3, device=axis.device)).to(torch.float32)


def gather_prim_rows(prims: Primitives, idx: torch.Tensor):
    """The primitive rows at per-lane indices (clipped into range):
    (kind, aux, data (R, 12), mat)."""
    i = idx.long().clamp(0, prims.kind.shape[0] - 1)
    return prims.kind[i], prims.aux[i], prims.data[i], prims.mat[i]


def record_from_rows(kind, aux, data, mat, idx, o, d, t, valid,
                     prim_types=None) -> HitRecord:
    """The hit record on already-gathered primitive rows
    (``intersect.record_from_rows``): front-face flip
    (geometry.rs:29-41), sphere uv (geometry.rs:120-128), rect uv
    (geometry.rs:225-230) and the triangle's flat normal with uv = 0
    (geometry.rs:550-558).  Every kind's formulas run on every lane and
    ``where`` picks, as in the JAX package."""
    types = prim_types if prim_types is not None else (0, 1, 2)
    point = o + t[..., None] * d
    outward = torch.zeros_like(point)
    u = torch.zeros_like(t)
    v = torch.zeros_like(t)

    if PRIM_SPHERE in types:
        n_s = _safe_div(point - data[..., 0:3], data[..., 3:4])  # sign(r) flips
        theta = vm.safe_acos(-n_s[..., 1])
        phi = vm.safe_atan2(-n_s[..., 2], n_s[..., 0]) + math.pi
        sel = kind == PRIM_SPHERE
        outward = vm.where(sel, n_s, outward)
        # XLA folds the JAX code's division by 2 pi (and by pi) into a
        # product with the f32 reciprocal
        u = torch.where(sel, phi * INV_TWO_PI, u)
        v = torch.where(sel, theta * INV_PI, v)

    if PRIM_RECT in types:
        n_r = axis_onehot(aux) * data[..., 5:6]
        # the free axes (a, b), ascending
        a_val = torch.where(aux == 0, point[..., 1], point[..., 0])
        b_val = torch.where(aux == 2, point[..., 1], point[..., 2])
        sel = kind == PRIM_RECT
        outward = vm.where(sel, n_r, outward)
        a0, b0, a1, b1 = data[..., 1], data[..., 2], data[..., 3], data[..., 4]
        u = torch.where(sel, _safe_div(a_val - a0, a1 - a0), u)
        v = torch.where(sel, _safe_div(b_val - b0, b1 - b0), v)

    if PRIM_TRIANGLE in types:
        outward = vm.where(kind == PRIM_TRIANGLE, data[..., 9:12], outward)

    front_face = vm.dot(d, outward) < 0.0
    normal = vm.where(front_face, outward, -outward)
    return HitRecord(valid=valid, t=t, point=point, normal=normal,
                     front_face=front_face, u=u, v=v, mat=mat, prim=idx)


def hit_record(prims: Primitives, idx, o, d, t, valid, prim_types=None) -> HitRecord:
    """The shading payload of the chosen primitive per lane."""
    idx = idx.clamp(0, prims.kind.shape[0] - 1)
    kind, aux, data, mat = gather_prim_rows(prims, idx)
    return record_from_rows(kind, aux, data, mat, idx, o, d, t, valid, prim_types)


# ---------------------------------------------------------------------------
# the differentiable re-intersection (RPT_DIFF_T=rederive in JAX)
# ---------------------------------------------------------------------------


def _miss(valid: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.where(valid, t, torch.full_like(t, T_MISS))


def sphere_t(data, o, d, t_min, t_max):
    """Sphere hit distance (geometry.rs:132-163) as ``(t, valid)``, t =
    T_MISS where invalid.  The quadratic runs in f64 on the f32 inputs,
    with ``closest_hit.sphere_roots``' operations in its order, and its
    roots round to f32, so a hit K4 found re-derives to K4's t; the
    square root is ``safe_sqrt`` (zero gradient at dis <= 0), so a miss
    lane's backward stays finite.  Autograd runs through the casts."""
    f64 = torch.float64
    ox, oy, oz = (o[..., k].to(f64) for k in range(3))
    dx, dy, dz = (d[..., k].to(f64) for k in range(3))
    cx, cy, cz, r = (data[..., k].to(f64) for k in range(4))
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    half_b = dx * ocx + dy * ocy + dz * ocz
    c = ocx * ocx + ocy * ocy + ocz * ocz - r * r
    a = dx * dx + dy * dy + dz * dz
    dis = half_b * half_b - a * c
    sqrtd = vm.safe_sqrt(dis)
    f32 = o.dtype
    root1 = ((-half_b - sqrtd) / a).to(f32)
    root2 = ((-half_b + sqrtd) / a).to(f32)
    ok1 = (root1 >= t_min) & (root1 <= t_max)
    ok2 = (root2 >= t_min) & (root2 <= t_max)
    t = torch.where(ok1, root1, root2)
    valid = (dis >= 0.0) & (ok1 | ok2)
    return _miss(valid, t), valid


# rect fixed axis -> its free axes, ascending (RECT_FREE as index rows)
_RECT_A = (1, 0, 0)
_RECT_B = (2, 2, 1)


def _component(v, axis):
    """v[..., axis] per lane: ``v`` (..., 3), ``axis`` (...) int64."""
    shape = torch.broadcast_shapes(v.shape[:-1], axis.shape)
    return torch.gather(v.expand(*shape, 3), -1,
                        axis.expand(shape)[..., None]).squeeze(-1)


def rect_t(data, aux, o, d, t_min, t_max):
    """Axis-aligned rect hit distance (geometry.rs:210-231) as ``(t,
    valid)``: the plane solve on the fixed axis ``aux``, then the bounds on
    the two free axes.  A ray parallel to the plane (|d| < 1e-30 on the
    axis) misses without an inf or a NaN that would reach the backward."""
    k = data[..., 0]
    a0, b0, a1, b1 = data[..., 1], data[..., 2], data[..., 3], data[..., 4]
    axis = aux.long()
    free = torch.tensor((_RECT_A, _RECT_B), device=axis.device)
    fa, fb = free[0][axis], free[1][axis]
    o_fix, d_fix = _component(o, axis), _component(d, axis)
    parallel = torch.abs(d_fix) < 1e-30
    t = torch.where(parallel, torch.full_like(d_fix, T_MISS),
                    (k - o_fix) / torch.where(parallel, torch.ones_like(d_fix), d_fix))
    a_val = _component(o, fa) + t * _component(d, fa)
    b_val = _component(o, fb) + t * _component(d, fb)
    valid = ((t >= t_min) & (t <= t_max) & (a_val >= a0) & (a_val <= a1)
             & (b_val >= b0) & (b_val <= b1))
    return _miss(valid, t), valid


def triangle_t(data, o, d, t_min, t_max):
    """Moller-Trumbore, one-sided (geometry.rs:519-549), as ``(t,
    valid)``; the reciprocal of det is guarded at |det| <= 1e-30 (such
    lanes are culled anyway)."""
    p1, e1, e2 = data[..., 0:3], data[..., 3:6], data[..., 6:9]
    pvec = vm.cross(d, e2)
    det = vm.dot(e1, pvec)
    inv_det = 1.0 / torch.where(torch.abs(det) > 1e-30, det, torch.ones_like(det))
    tvec = o - p1
    u = vm.dot(tvec, pvec) * inv_det
    qvec = vm.cross(tvec, e1)
    v = vm.dot(d, qvec) * inv_det
    t = vm.dot(e2, qvec) * inv_det
    valid = ((det >= TRI_DET_EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
             & (u + v <= 1.0) & (t >= t_min) & (t <= t_max))
    return _miss(valid, t), valid


def prim_intersect_t(kind, aux, data, o, d, t_min, t_max, prim_types=None):
    """Distance to one primitive a lane, dispatching on ``kind``: ``(t,
    valid)`` with t = T_MISS where invalid.  Shapes broadcast;
    ``prim_types`` (static) skips the kinds a scene lacks.  Every kind's
    formula runs on every lane and ``where`` picks, so each is guarded
    against NaN in its backward."""
    types = prim_types if prim_types is not None else (0, 1, 2)
    shape = torch.broadcast_shapes(kind.shape, o.shape[:-1])
    t = torch.full(shape, T_MISS, dtype=o.dtype, device=o.device)
    valid = torch.zeros(shape, dtype=torch.bool, device=o.device)
    for ptype in (PRIM_SPHERE, PRIM_RECT, PRIM_TRIANGLE):
        if ptype not in types:
            continue
        if ptype == PRIM_SPHERE:
            tk, vk = sphere_t(data, o, d, t_min, t_max)
        elif ptype == PRIM_RECT:
            tk, vk = rect_t(data, aux, o, d, t_min, t_max)
        else:
            tk, vk = triangle_t(data, o, d, t_min, t_max)
        sel = (kind == ptype) & vk
        t = torch.where(sel, tk, t)
        valid = valid | sel
    return t, valid
