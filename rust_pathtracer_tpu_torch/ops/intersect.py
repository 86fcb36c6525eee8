"""Hit records on the primitive tables, in plain tensor ops.

Counterpart of ``rust_pathtracer_tpu/ops/intersect.py``: the constants,
``HitRecord``, ``gather_prim_rows``, ``record_from_rows`` and
``hit_record``.  The record is the differentiable route's: sphere uv
through ``safe_acos`` / ``safe_atan2``, rect uv through ``_safe_div``,
so that no branch that ``where`` leaves out puts a NaN into the
backward.  The closest-hit search itself is the kernels' work
(``closest_hit.py``, K3 and K4).

Not ported: the JAX brute-force and BVH searches and the geometry
re-derivation ``prim_intersect_t`` (ROADMAP queue 1 items 8 and 10).
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
