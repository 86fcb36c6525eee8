"""Closest hit over the projected tables of a big scene: K5, and the
sweep that K5, K6 and K7 share.

Counterpart of ``rust_pathtracer_tpu/ops/projected.py``.  A scene of
more than 128 primitives carries ``ProjTables``: every primitive
becomes three projection columns, grouped by type into 128-column
groups (the "clusters", in BVH-leaf order, so spatially compact):

* rays are the 8-vectors [ox oy oz dx dy dz 1 0];
* ``O_j = rays . a[j]`` and ``D_j = rays . b[j]`` (j = 0, 1, 2) give a
  column's per-type quantities: a sphere's o.c and d.c, a rect's plane
  offset and free coordinates, a triangle's Woop-transformed origin and
  direction; ``const`` holds per-column scalars (K0 = 1e30 on padding
  columns, which every formula misses);
* ``payload`` (C, 32) is each column's primitive row, its kind, aux,
  material, ORIGINAL index and flattened shading row (``PAY_*``).

The function all three kernels compute, per lane: the closest hit over
the columns, its column (-1 on a miss) and that column's payload row
(zeros on a miss), with ``t = T_MISS`` on a miss.  The sweep, as the
Pallas kernels run it:

* clusters in ascending order; a lane skips a cluster whose AABB its
  slab test (bvh.rs:18-35, entry clamped at t_min, exit at the lane's
  running best t) does not pass.  The cull is conservative, so it
  changes no result;
* each group runs its own type's formula on its 128 columns; the
  group's winner is its lowest column at the group minimum; a group
  replaces the running best only on a strictly smaller t;
* sphere groups compare in q = t |d|^2 (no division per column) and
  divide only the group winner by |d|^2.  K6 and K7 always do; K5 does
  where the group's slot is sphere or padding in every p-block
  (``col_block`` columns), so on streamed tables (more than 16,384
  columns) K5 may differ from K6 / K7 in the last ulp of a sphere hit.

The projections are the 8-term dot products ``rays . a[j]``, summed
k = 0..7 in order with no fused multiply-add, never a matmul.  The
tables are sparse by type, so the sweep reads each column's nonzero
coefficients from ``ProjTables.rows`` and sums only those terms, in the
same order, then adds +0 (``_projections``).  For finite rays that is
the dense sum bit for bit: a zero coefficient adds a product of +-0,
which changes a running sum only where it is itself a zero, and then
only its sign; the dense sum ends with the term 0 * 0 = +0, which turns
a -0 into +0, as the closing +0 does.  So K5, K6 (which still sweeps
the dense tables) and K7 agree with their plain version bit for bit.
Against the JAX package (the MXU at HIGHEST, XLA's order) t agrees to
~1e-5.

Here: ``ProjTables``, ``build_projected`` (host numpy, the JAX
package's), the plain sweep ``_sweep_plain``, K5
(``projected_sweep``; the Pallas ``_kernel`` at projected.py:455),
``closest_hit_projected`` and the forward route
``closest_hit_record_projected``.  K6 is in ``resident.py``, K7 in
``worklist.py``; the three kernels are ``csrc/projected.cu``.

Not ported: the between-bounce wavefront reorder
(``closest_hit_projected_binned``, ``cluster_entry_key``,
``passset_*``), which changes no per-lane result, and the ``RPT_*``
environment knobs; routes are overridden by arguments only.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from rust_pathtracer_tpu_torch.ops.intersect import T_MISS, TRI_DET_EPS, record_from_rows
from rust_pathtracer_tpu_torch.scene.types import (
    PRIM_RECT,
    PRIM_SPHERE,
    PRIM_TRIANGLE,
    TEX_CHECKER,
    TEX_IMAGE,
    TEX_SOLID,
)
from rust_pathtracer_tpu_torch.vecmath import sqrt

GROUP = 128          # columns of one cluster, all of one primitive type
COL_BLOCK = 2048     # columns of one p-block of a streamed table
MAX_SINGLE_COLS = 16384  # tables up to this many columns are one p-block

# payload columns: 0-11 the primitive row, 12-15 kind / aux / material /
# ORIGINAL index, 16-31 the flattened shading row: 16 material kind,
# 17 fuzz, 18 ir, 19 texture kind, 20 scale, 21-23 solid color, 24-26
# checker odd color, 27-29 checker even color, 30 image id, 31 spare
PAY_KIND, PAY_AUX, PAY_MAT, PAY_IDX = 12, 13, 14, 15
PAY_MKIND, PAY_FUZZ, PAY_IR, PAY_TKIND, PAY_TSCALE = 16, 17, 18, 19, 20
PAY_COLOR, PAY_ODD, PAY_EVEN, PAY_IMG = 21, 24, 27, 30
PAY_W = 32

# routing (projected.py:858-889, resident.py:66): the resident kernel K6
# for tables of at most RES_MAX_COLS columns, else the pair kernel K7;
# either needs at least MIN_REAL_CLUSTERS real clusters, else dense K5
RES_MAX_COLS = 12288
MIN_REAL_CLUSTERS = 2
ROUTES = ("dense", "resident", "pairs")

_RECT_FREE = {0: (1, 2), 1: (0, 2), 2: (0, 1)}
WARP = 32  # lanes of a warp, for the plain sweep's count of warp visits
# passing lanes of a warp from which K5 and K7 sweep a cluster per lane, the
# warp cooperatively below (COOP_P of csrc/projected.cu)
COOP_P = 24
_TINY = 1e-30  # slab reciprocal clamp (projected.py:501-504)

# lanes a block of the plain sweep (on the CPU, on the card): bounds its
# (lanes, clusters) slab planes and (lanes, 128) column panels
PLAIN_CHUNK = {"cpu": 1 << 15, "cuda": 1 << 20}

# K5 launches (CUDA tensors only)
launches = 0


@dataclasses.dataclass(frozen=True)
class ProjTables:
    """The projected-sweep tables of one scene (``ProjTables``).

    a, b: (3, 8, C) f32; const: (8, C); payload: (C, 32);
    cluster_bounds: (6, G) per-cluster AABB (min xyz, max xyz; padding
    clusters are degenerate points at 1e30 that no slab test passes);
    cluster_bounds_v: the JAX kernel's (n_pblocks, 6, GPAD) layout of
    the same bounds, carried for parity.  Static: ``group_kinds`` (the
    primitive type of each cluster, -1 = padding), ``shade_ready``
    (payload columns 16-31 hold a complete shading row), ``col_block``
    (columns of a p-block).  Derived on the tables' device: ``rows``
    and ``bounds8``, what K5, K7 and the plain sweep read.
    """

    a: torch.Tensor
    b: torch.Tensor
    const: torch.Tensor
    payload: torch.Tensor
    cluster_bounds: torch.Tensor
    cluster_bounds_v: torch.Tensor
    group_kinds: Tuple[int, ...] = ()
    shade_ready: bool = False
    col_block: int = COL_BLOCK

    @property
    def num_cols(self) -> int:
        return self.a.shape[-1]

    @property
    def num_groups(self) -> int:
        return len(self.group_kinds)

    @property
    def device(self) -> torch.device:
        return self.a.device

    def to(self, device) -> "ProjTables":
        return dataclasses.replace(
            self, **{f.name: getattr(self, f.name).to(device)
                     for f in dataclasses.fields(self)
                     if isinstance(getattr(self, f.name), torch.Tensor)})

    @functools.cached_property
    def dense_q(self) -> Tuple[bool, ...]:
        """Per cluster: K5 compares it in the q domain (a sphere group
        whose slot is sphere or padding in every p-block,
        projected.py:536-538)."""
        ngrp = self.col_block // GROUP
        n_pblocks = self.num_cols // self.col_block
        slot_sphere = [
            all(self.group_kinds[blk * ngrp + g] in (PRIM_SPHERE, -1)
                for blk in range(n_pblocks))
            for g in range(ngrp)
        ]
        return tuple(k == PRIM_SPHERE and slot_sphere[i % ngrp]
                     for i, k in enumerate(self.group_kinds))

    @functools.cached_property
    def kernel_ints(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """(group kinds, K5 q flags) as int32 tensors on the tables'
        device, the kernels' per-cluster inputs."""
        def t(x):
            return torch.tensor(x, dtype=torch.int32, device=self.device)

        return t(self.group_kinds), t([int(q) for q in self.dense_q])

    @functools.cached_property
    def rows(self) -> torch.Tensor:
        """(G, 4, 128, 4) f32: per cluster, four 16-byte quads of each
        column's nonzero coefficients, quad q of column j at [g, q, j],
        so a warp reads a quad of 32 columns in one coalesced load.  The
        words are copies of the f32 values of ``a`` and ``const`` (``b``
        holds the same values, see ``build_projected``):

        * sphere, quad 0: A[0, 0:3] (the centre) and K0;
        * rect, quads 0-2: (f, A[0, 6], K0, K1), (K2, K3, A[0, f],
          A[1, fa]), (A[2, fb], B[0, 3 + f], B[1, 3 + fa], B[2, 3 + fb])
          with f the fixed axis and (fa, fb) the free ones; the
          coefficients are 1 on a real column and 0 on padding, so a
          padding column's projections are the dense ones, 0;
        * triangle, quads 0-3: (A[j, 0:3], A[j, 6]) for j = 0, 1, 2,
          then (K0, 0, 0, 0);
        * padding columns of a real cluster: zeros and K0 = 1e30.
        """
        a, b, k = self.a, self.b, self.const
        C, dev = self.num_cols, self.device
        kind = torch.tensor(self.group_kinds, device=dev).repeat_interleave(GROUP)
        rows = torch.zeros((C, 16), dtype=torch.float32, device=dev)
        sph, rect, tri = (kind == x for x in (PRIM_SPHERE, PRIM_RECT, PRIM_TRIANGLE))
        rows[sph, 0:3] = a[0, 0:3][:, sph].T
        rows[sph, 3] = k[0, sph]
        for j in range(3):
            rows[tri, 4 * j:4 * j + 3] = a[j, 0:3][:, tri].T
            rows[tri, 4 * j + 3] = a[j, 6, tri]
        rows[tri, 12] = k[0, tri]
        f = (a[0, 0:3] != 0).to(torch.int64).argmax(dim=0)  # 0 on padding
        fa, fb = _free_axes(f)
        cols = torch.arange(C, device=dev)
        quads = torch.stack([
            f.to(torch.float32), a[0, 6], k[0], k[1], k[2], k[3],
            a[0, f, cols], a[1, fa, cols], a[2, fb, cols],
            b[0, 3 + f, cols], b[1, 3 + fa, cols], b[2, 3 + fb, cols]], dim=1)
        rows[rect, 0:12] = quads[rect]
        return rows.view(-1, GROUP, 4, 4).permute(0, 2, 1, 3).contiguous()

    @functools.cached_property
    def bounds8(self) -> torch.Tensor:
        """(G, 8) f32: each cluster's AABB as two 16-byte quads, (min
        xyz, 0) and (max xyz, 0), copied from ``cluster_bounds``."""
        cb = self.cluster_bounds
        out = torch.zeros((self.num_groups, 8), dtype=torch.float32, device=self.device)
        out[:, 0:3] = cb[0:3].T
        out[:, 4:7] = cb[3:6].T
        return out


def _free_axes(f):
    """The free axes (fa, fb) of rects whose fixed axis is ``f`` (an
    int64 tensor), ``_RECT_FREE`` elementwise."""
    lut = torch.tensor([_RECT_FREE[i] for i in range(3)], device=f.device)
    return lut[f, 0], lut[f, 1]


def default_route(tables: ProjTables) -> str:
    """The JAX package's routing with its defaults (``use_resident``,
    ``use_worklist``): "resident" (K6) for tables of at most
    RES_MAX_COLS columns, "pairs" (K7) beyond, either with at least two
    real clusters; "dense" (K5) otherwise."""
    if sum(k != -1 for k in tables.group_kinds) < MIN_REAL_CLUSTERS:
        return "dense"
    return "resident" if tables.num_cols <= RES_MAX_COLS else "pairs"


def _pad_up(n: int, m: int) -> int:
    return -(-n // m) * m


# ---------------------------------------------------------------------------
# table build (host numpy, projected.py:144-334)
# ---------------------------------------------------------------------------


def build_projected(kind, aux, data, mat, mats=None, texs=None,
                    max_single_cols=MAX_SINGLE_COLS, device="cpu") -> ProjTables:
    """Tables from flattened primitive arrays, on ``device``.

    ``mats``: optional (kind, tex, fuzz, ir) material arrays and
    ``texs``: (kind, color, child, scale, image_id) texture arrays; with
    both, payload columns 16-31 carry each primitive's shading row and
    ``shade_ready`` says whether every checker's children are solid.
    Tables of more than ``max_single_cols`` padded columns stream in
    COL_BLOCK-column p-blocks (tests pass a small value)."""
    kind = np.asarray(kind)
    aux = np.asarray(aux)
    data = np.asarray(data, np.float64)  # inverses in f64
    mat = np.asarray(mat)

    order = []  # original indices grouped by type, each type padded
    group_kinds = []
    for tk in (PRIM_SPHERE, PRIM_RECT, PRIM_TRIANGLE):
        idxs = np.nonzero(kind == tk)[0]
        if len(idxs) == 0:
            continue
        n_pad = _pad_up(len(idxs), GROUP)
        order.extend(int(i) for i in idxs)
        order.extend([-1] * (n_pad - len(idxs)))
        group_kinds.extend([tk] * (n_pad // GROUP))
    C = _pad_up(max(len(order), 1), GROUP)
    if C > max_single_cols:
        C = _pad_up(C, COL_BLOCK)
        col_block = COL_BLOCK
    else:
        col_block = C
    while len(order) < C:
        order.append(-1)
        if len(order) % GROUP == 0:
            group_kinds.append(-1)
    while len(group_kinds) < C // GROUP:
        group_kinds.append(-1)

    A = np.zeros((3, 8, C), np.float64)
    B = np.zeros((3, 8, C), np.float64)
    K = np.zeros((8, C), np.float64)
    pay = np.zeros((C, PAY_W), np.float64)
    K[0, :] = 1.0e30  # padding columns: every formula misses

    order_np = np.asarray(order, np.int64)
    cols = np.nonzero(order_np >= 0)[0]
    prm = order_np[cols]
    pay[cols, :12] = data[prm]
    pay[cols, PAY_KIND] = kind[prm]
    pay[cols, PAY_AUX] = aux[prm]
    pay[cols, PAY_MAT] = mat[prm]
    pay[cols, PAY_IDX] = prm

    shade_ready = False
    if mats is not None and texs is not None:
        mkind, mtex, mfuzz, mir = (np.asarray(x) for x in mats)
        tkind, tcolor, tchild, tscale, timg = (np.asarray(x) for x in texs)
        m = mat[prm]
        tex = mtex[m]
        pay[cols, PAY_MKIND] = mkind[m]
        pay[cols, PAY_FUZZ] = mfuzz[m]
        pay[cols, PAY_IR] = mir[m]
        pay[cols, PAY_TKIND] = tkind[tex]
        pay[cols, PAY_TSCALE] = tscale[tex]
        pay[cols, PAY_COLOR:PAY_COLOR + 3] = tcolor[tex]
        is_ck = tkind[tex] == TEX_CHECKER
        odd, even = tchild[tex, 0], tchild[tex, 1]
        pay[cols, PAY_ODD:PAY_ODD + 3] = np.where(is_ck[:, None], tcolor[odd], 0.0)
        pay[cols, PAY_EVEN:PAY_EVEN + 3] = np.where(is_ck[:, None], tcolor[even], 0.0)
        pay[cols, PAY_IMG] = np.where(tkind[tex] == TEX_IMAGE, timg[tex], -1)
        bad = is_ck & ((tkind[odd] != TEX_SOLID) | (tkind[even] != TEX_SOLID))
        shade_ready = not bool(bad.any())

    # spheres: K0 = |c|^2 - r^2
    sm = kind[prm] == PRIM_SPHERE
    sc, sp = cols[sm], prm[sm]
    ctr = data[sp, 0:3]
    A[0, 0:3, sc] = ctr  # the advanced index comes first: (n, 3)
    B[0, 3:6, sc] = ctr
    K[0, sc] = np.einsum("ij,ij->i", ctr, ctr) - data[sp, 3] ** 2

    # rects, by fixed axis
    rm = kind[prm] == PRIM_RECT
    for f, (fa, fb) in _RECT_FREE.items():
        fm = rm & (aux[prm] == f)
        rc, rp = cols[fm], prm[fm]
        A[0, f, rc] = 1.0
        A[0, 6, rc] = -data[rp, 0]
        B[0, 3 + f, rc] = 1.0
        A[1, fa, rc] = 1.0
        B[1, 3 + fa, rc] = 1.0
        A[2, fb, rc] = 1.0
        B[2, 3 + fb, rc] = 1.0
        K[0, rc] = data[rp, 1]
        K[1, rc] = data[rp, 3]
        K[2, rc] = data[rp, 2]
        K[3, rc] = data[rp, 4]

    # triangles: the Woop transform W = [e1 e2 n]^-1 by cross products
    tm = kind[prm] == PRIM_TRIANGLE
    tc, tp = cols[tm], prm[tm]
    if len(tc):
        v0, e1, e2 = data[tp, 0:3], data[tp, 3:6], data[tp, 6:9]
        n = np.cross(e1, e2)
        n2 = np.einsum("ij,ij->i", n, n)
        good = n2 > 1e-30
        n2safe = np.where(good, n2, 1.0)[:, None]
        ws = (n / n2safe, np.cross(e2, n) / n2safe, np.cross(n, e1) / n2safe)
        for j, w in enumerate(ws):
            w = np.where(good[:, None], w, 0.0)
            A[j, 0:3, tc] = w
            A[j, 6, tc] = -np.einsum("ij,ij->i", w, v0)
            B[j, 3:6, tc] = w
        K[0, tc] = np.where(good, n2, 0.0)  # degenerate: det 0, culled

    # per-column AABBs -> per-cluster AABBs
    col_min = np.full((C, 3), 1.0e30)
    col_max = np.full((C, 3), -1.0e30)
    if len(sc):
        ar = np.abs(data[sp, 3])[:, None]
        col_min[sc] = data[sp, 0:3] - ar
        col_max[sc] = data[sp, 0:3] + ar
    for f, (fa, fb) in _RECT_FREE.items():
        fm = rm & (aux[prm] == f)
        rc, rp = cols[fm], prm[fm]
        if not len(rc):
            continue
        lo = np.empty((len(rc), 3))
        hi = np.empty((len(rc), 3))
        lo[:, f] = hi[:, f] = data[rp, 0]
        lo[:, fa], hi[:, fa] = data[rp, 1], data[rp, 3]
        lo[:, fb], hi[:, fb] = data[rp, 2], data[rp, 4]
        col_min[rc], col_max[rc] = lo, hi
    if len(tc):
        vs = np.stack([v0, v0 + e1, v0 + e2], axis=1)
        col_min[tc] = vs.min(axis=1)
        col_max[tc] = vs.max(axis=1)
    glo = col_min.reshape(-1, GROUP, 3).min(axis=1)
    ghi = col_max.reshape(-1, GROUP, 3).max(axis=1)
    # a conservative epsilon, so that f32 rounding never culls a hit
    pad = 1e-5 * (1.0 + np.maximum(np.abs(glo), np.abs(ghi)))
    nonempty = (glo <= ghi).all(axis=1, keepdims=True)
    glo = np.where(nonempty, glo - pad, glo)
    ghi = np.where(nonempty, ghi + pad, ghi)
    # all-padding clusters: degenerate points at +1e30, which the sorted
    # slab test fails for every real ray (an inverted box would pass all)
    glo = np.where(nonempty, glo, 1.0e30)
    ghi = np.where(nonempty, ghi, 1.0e30)
    cb = np.concatenate([glo, ghi], axis=1).T  # (6, C / GROUP)

    n_pblocks = C // col_block
    ngrp = col_block // GROUP
    gpad = _pad_up(ngrp, 128)
    cbv = np.full((n_pblocks, 6, gpad), 1.0e30)
    for blk in range(n_pblocks):
        cbv[blk, :, :ngrp] = cb[:, blk * ngrp:(blk + 1) * ngrp]

    def t(x):
        return torch.as_tensor(np.ascontiguousarray(x.astype(np.float32)),
                               device=device)

    return ProjTables(
        a=t(A), b=t(B), const=t(K), payload=t(pay), cluster_bounds=t(cb),
        cluster_bounds_v=t(cbv), group_kinds=tuple(group_kinds),
        shade_ready=shade_ready, col_block=col_block,
    )


# ---------------------------------------------------------------------------
# the plain sweep, shared by the plain versions of K5, K6 and K7
# ---------------------------------------------------------------------------


def slab_bounds(cluster_bounds, o, d, t_min):
    """(lo, hi) (R, G): each lane's slab entry and exit for every cluster
    AABB (bvh.rs:18-35), entry clamped below at t_min and exit above at
    T_MISS; the reciprocal of |d| < 1e-30 is clamped.  NaN-propagating
    max / min, as jnp.maximum / minimum."""
    f32 = torch.float32
    tiny = torch.tensor(_TINY, dtype=f32, device=d.device)
    dsafe = torch.where(torch.abs(d) < tiny, torch.where(d < 0.0, -tiny, tiny), d)
    inv_d = torch.reciprocal(dsafe)
    R, G = o.shape[0], cluster_bounds.shape[1]
    lo = torch.full((R, G), t_min, dtype=f32, device=o.device)
    hi = torch.full((R, G), T_MISS, dtype=f32, device=o.device)
    for ax in range(3):
        b0 = (cluster_bounds[ax][None, :] - o[:, ax:ax + 1]) * inv_d[:, ax:ax + 1]
        b1 = (cluster_bounds[3 + ax][None, :] - o[:, ax:ax + 1]) * inv_d[:, ax:ax + 1]
        lo = torch.maximum(lo, torch.minimum(b0, b1))
        hi = torch.minimum(hi, torch.maximum(b0, b1))
    return lo, hi


def _projections(tables: ProjTables, kind, g, o, d):
    """The projections and constants of cluster ``g`` (of type ``kind``)
    for the lanes (o, d) (n, 3): (O, D, K) with O = [O_0..], D = [D_0..]
    the (n, 128) projections a type reads (1 a sphere, 3 a rect or a
    triangle) and K its (128,) constants (K0, or K0-K3 a rect).  Each
    projection sums its nonzero terms from ``tables.rows`` in the k
    order of ``rays . a[j]`` (a coefficient 1 multiplies as the dense
    product does), then adds +0: the dense 8-term sum bit for bit on
    finite rays (see the module note).  The kernel's ``column_value``."""
    q = tables.rows[g]  # (4, 128, 4)
    ox, oy, oz = (o[:, i:i + 1] for i in range(3))
    dx, dy, dz = (d[:, i:i + 1] for i in range(3))
    if kind == PRIM_SPHERE:
        cx, cy, cz, k0 = q[0].unbind(1)
        return ([((ox * cx + oy * cy) + oz * cz) + 0.0],
                [((dx * cx + dy * cy) + dz * cz) + 0.0], (k0,))
    if kind == PRIM_TRIANGLE:
        O, D = [], []
        for j in range(3):
            w0, w1, w2, c = q[j].unbind(1)
            O.append((((ox * w0 + oy * w1) + oz * w2) + c) + 0.0)
            D.append(((dx * w0 + dy * w1) + dz * w2) + 0.0)
        return O, D, (q[3, :, 0],)
    if kind == PRIM_RECT:
        f, c, k0, k1 = q[0].unbind(1)
        k2, k3, a0, a1 = q[1].unbind(1)
        a2, b0, b1, b2 = q[2].unbind(1)
        f = f.to(torch.int64)
        fa, fb = _free_axes(f)
        return ([(o[:, f] * a0 + c) + 0.0, o[:, fa] * a1 + 0.0, o[:, fb] * a2 + 0.0],
                [d[:, f] * b0 + 0.0, d[:, fa] * b1 + 0.0, d[:, fb] * b2 + 0.0],
                (k0, k1, k2, k3))
    raise ValueError(f"no formula for cluster kind {kind}")


def _group_values(kind, q, O, D, K, onorm, odot, dnorm, tmin):
    """(n, 128) candidate values of one cluster, T_MISS where invalid:
    q = t |d|^2 for a sphere group compared in the q domain
    (``_group_q_sphere``), else t (``_group_t``).  O, D, K: as
    ``_projections`` returns them; norms (n, 1); tmin: f32 scalar
    tensor."""
    k0 = K[0]
    if kind == PRIM_SPHERE:
        half_b = odot - D[0]
        cterm = onorm - 2.0 * O[0] + k0
        dis = half_b * half_b - dnorm * cterm
        sqrtd = sqrt(torch.where((dis > 0.0) | torch.isnan(dis), dis,
                                 torch.zeros_like(dis)))
        if q:
            tmin_a = tmin * dnorm
            r1 = -half_b - sqrtd
            r2 = -half_b + sqrtd
        else:
            tmin_a = tmin
            r1 = (-half_b - sqrtd) / dnorm
            r2 = (-half_b + sqrtd) / dnorm
        ok1 = r1 >= tmin_a
        val = torch.where(ok1, r1, r2)
        valid = (dis >= 0.0) & (ok1 | (r2 >= tmin_a))
    elif kind == PRIM_RECT:
        val = -O[0] / D[0]  # NaN / inf when parallel: the bounds fail
        av = O[1] + val * D[1]
        bv = O[2] + val * D[2]
        valid = ((val >= tmin) & (av >= k0) & (av <= K[1])
                 & (bv >= K[2]) & (bv <= K[3]))
    else:  # triangle
        det = -D[0] * k0  # d . -n; the one-sided cull needs det >= eps
        val = -O[0] / D[0]
        u = O[1] + val * D[1]
        v = O[2] + val * D[2]
        valid = ((det >= TRI_DET_EPS) & (u >= 0.0) & (u <= 1.0) & (v >= 0.0)
                 & (u + v <= 1.0) & (val >= tmin))
    return torch.where(valid, val, torch.full_like(val, T_MISS))


def _sweep_plain(tables: ProjTables, o, d, t_min, *, q_flags, listed=None,
                 rb=None, tie_break=False, stats=None):
    """The sweep of K5 / K6 / K7 in tensor ops; runs on any device.

    ``q_flags``: per cluster, compare in the q domain.  ``listed``: None
    (every lane may visit every cluster: K5), or a (nblocks, G) bool of
    the clusters each block of ``rb`` lanes lists (K6, K7).
    ``tie_break``: K6's take rule, which also takes an equal t at a
    lower column (a no-op in ascending order, kept as the kernel has
    it).  Lanes run in chunks of PLAIN_CHUNK; a cluster no lane of a
    chunk passes is skipped, and only the passing lanes are computed
    (the per-lane cull).  ``stats``, a dict, gets the work the kernel
    does on these inputs added in: "slab_tests" (lane-cluster slab
    tests), "swept" (per cluster, the lanes that sweep its 128 columns)
    and "warp_visits" (33 counts: entry p counts the visits of a warp of
    32 lanes to a cluster that p of its lanes pass, p >= 1; the kernels
    skip a cluster no lane of the warp passes).
    Returns (t (R,), column (R,) int32, payload (R, 32))."""
    dev = o.device
    f32, i32 = torch.float32, torch.int32
    R = o.shape[0]
    tmin = torch.tensor(t_min, dtype=f32, device=dev)
    t_out = torch.full((R,), T_MISS, dtype=f32, device=dev)
    c_out = torch.full((R,), -1, dtype=i32, device=dev)
    iota = torch.arange(GROUP, dtype=i32, device=dev)
    big = torch.full((), 2 ** 30, dtype=i32, device=dev)
    chunk = PLAIN_CHUNK.get(dev.type, PLAIN_CHUNK["cpu"])
    for s in range(0, R, chunk):
        oc, dc = o[s:s + chunk], d[s:s + chunk]
        n = oc.shape[0]
        onorm = ((oc[:, 0] * oc[:, 0] + oc[:, 1] * oc[:, 1]) + oc[:, 2] * oc[:, 2])[:, None]
        odot = ((oc[:, 0] * dc[:, 0] + oc[:, 1] * dc[:, 1]) + oc[:, 2] * dc[:, 2])[:, None]
        dnorm = ((dc[:, 0] * dc[:, 0] + dc[:, 1] * dc[:, 1]) + dc[:, 2] * dc[:, 2])[:, None]
        lo, hi = slab_bounds(tables.cluster_bounds, oc, dc, t_min)
        blk = (torch.arange(s, s + n, device=dev) // rb) if listed is not None else None
        tb = torch.full((n,), T_MISS, dtype=f32, device=dev)
        cb = torch.full((n,), -1, dtype=i32, device=dev)
        for g, kind in enumerate(tables.group_kinds):
            if kind < 0:
                continue
            m = torch.minimum(hi[:, g], tb) >= lo[:, g]
            if listed is not None:
                tested = listed[blk, g]
                m = m & tested
            idx = m.nonzero().squeeze(1)
            if stats is not None:
                n_tested = n if listed is None else int(tested.sum())
                stats["slab_tests"] = stats.get("slab_tests", 0) + n_tested
                swept = stats.setdefault("swept", [0] * tables.num_groups)
                swept[g] += idx.numel()
                per_warp = torch.unique((s + idx) // WARP, return_counts=True)[1]
                visits = stats.setdefault("warp_visits", [0] * (WARP + 1))
                for p, c in enumerate(torch.bincount(per_warp, minlength=WARP + 1).tolist()):
                    visits[p] += c
            if idx.numel() == 0:
                continue
            q = q_flags[g]
            O, D, K = _projections(tables, kind, g, oc[idx], dc[idx])
            dn = dnorm[idx]
            vals = _group_values(kind, q, O, D, K, onorm[idx], odot[idx], dn, tmin)
            raw = vals.min(dim=1, keepdim=True).values
            gc = torch.where(vals <= raw, iota, big).min(dim=1).values
            gt = raw[:, 0]
            if q:
                gt = torch.where(gt >= T_MISS, torch.full_like(gt, T_MISS), gt / dn[:, 0])
            cur, cur_c = tb[idx], cb[idx]
            gcol = gc + g * GROUP
            take = gt < cur
            if tie_break:
                take = take | ((gt == cur) & (gcol < cur_c))
            tb[idx] = torch.where(take, gt, cur)
            cb[idx] = torch.where(take, gcol, cur_c)
        t_out[s:s + n] = torch.where(cb >= 0, tb, torch.full_like(tb, T_MISS))
        c_out[s:s + n] = cb
    hit = c_out >= 0
    pay = tables.payload[c_out.clamp(min=0).long()]
    pay = torch.where(hit[:, None], pay, torch.zeros_like(pay))
    return t_out, c_out, pay


# ---------------------------------------------------------------------------
# K5: the dense cluster-culled sweep
# ---------------------------------------------------------------------------


def projected_sweep_plain(tables: ProjTables, o, d, t_min, stats=None):
    """K5 in tensor ops: every cluster in ascending order, K5's q rule.
    ``stats``: see ``_sweep_plain``."""
    return _sweep_plain(tables, o, d, t_min, q_flags=tables.dense_q, stats=stats)


def check_inputs(name, tables: ProjTables, o, d):
    """The wrappers' checks: f32 (R, 3) rays on the tables' device, a
    CPU or CUDA device.  Returns the device."""
    dev = tables.device
    for x in (o, d, tables.a, tables.b, tables.const, tables.payload,
              tables.cluster_bounds):
        if x.device != dev:
            raise ValueError(f"{name}: tensors on {x.device} and {dev}")
        if x.dtype != torch.float32:
            raise TypeError(f"{name}: dtype {x.dtype}, want float32")
    if o.dim() != 2 or o.shape[1] != 3 or d.shape != o.shape:
        raise ValueError(f"{name}: rays of shape {tuple(o.shape)} and "
                         f"{tuple(d.shape)}, want (R, 3) both")
    C, G = tables.num_cols, tables.num_groups
    if (tables.a.shape != (3, 8, C) or tables.b.shape != (3, 8, C)
            or tables.const.shape != (8, C) or tables.payload.shape != (C, PAY_W)
            or tables.cluster_bounds.shape != (6, G) or C != G * GROUP):
        raise ValueError(f"{name}: inconsistent projected tables "
                         f"(C = {C}, G = {G})")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {dev}")
    return dev


def projected_sweep(tables: ProjTables, o, d, t_min):
    """K5 (replaces ``projected.py::_kernel``): (t, column, payload) of
    each ray's closest hit, t = T_MISS, column -1 and payload 0 on a
    miss.  CUDA tensors launch the kernel and count in ``launches``;
    CPU tensors run ``projected_sweep_plain``."""
    dev = check_inputs("projected_sweep", tables, o, d)
    if dev.type == "cpu":
        return projected_sweep_plain(tables, o, d, t_min)
    kinds, qflags = tables.kernel_ints
    out = launch_sweep("dense", tables, o, d, t_min, kinds, qflags)
    global launches
    launches += 1
    return out


def launch_sweep(mode, tables: ProjTables, o, d, t_min, kinds, qflags,
                 words=None, counts=None, kcap=0, rb=1):
    """Launch one of the three kernels of ``csrc/projected.cu`` on the
    current stream: ``mode`` "dense" (K5), "resident" (K6: ``words``
    the packed slots, ``counts`` the real slots a block) or "pairs"
    (K7: ``words`` the (2, W) slot table).  Returns (t, column,
    payload); raises when the launch fails."""
    import ctypes

    from rust_pathtracer_tpu_torch.ops._build import load_library

    lib = load_library("projected")
    R = o.shape[0]
    dev = o.device
    o, d = o.contiguous(), d.contiguous()
    t = torch.empty(R, dtype=torch.float32, device=dev)
    col = torch.empty(R, dtype=torch.int32, device=dev)
    pay = torch.empty((R, PAY_W), dtype=torch.float32, device=dev)
    tabs = [x.contiguous() for x in (tables.a, tables.b, tables.const,
                                     tables.payload, tables.cluster_bounds)]
    ptrs = (ctypes.c_void_p * 9)(*[x.data_ptr() for x in tabs],
                                 kinds.data_ptr(), qflags.data_ptr(),
                                 tables.rows.data_ptr(), tables.bounds8.data_ptr())
    W = 0 if words is None else words.shape[-1]
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.projected_launch(
            ROUTES.index(mode), ptrs, tables.num_cols, tables.num_groups,
            None if words is None else words.data_ptr(),
            None if counts is None else counts.data_ptr(),
            int(kcap), int(rb), W, o.data_ptr(), d.data_ptr(), float(t_min),
            t.data_ptr(), col.data_ptr(), pay.data_ptr(), R, stream)
    if err != 0:
        raise RuntimeError(f"projected kernel ({mode}) launch failed: "
                           f"{lib.error_string(err).decode()}")
    return t, col, pay


def closest_hit_projected(tables: ProjTables, o, d, t_min):
    """K5's closest hit: (hit, t, payload (R, 32)), t = T_MISS on a
    miss.  The differentiable route's detached search."""
    t, col, pay = projected_sweep(tables, o, d, t_min)
    return col >= 0, t, pay


def closest_hit_routed(tables: ProjTables, o, d, t_min, route: Optional[str] = None):
    """(t, column, payload) by ``route`` ("dense" K5, "resident" K6,
    "pairs" K7 with its K5 fallback); None takes ``default_route``.  The
    argument is an override for tests and measurements."""
    route = default_route(tables) if route is None else route
    if route == "resident":
        from rust_pathtracer_tpu_torch.ops.resident import closest_hit_resident

        return closest_hit_resident(tables, o, d, t_min)
    if route == "pairs":
        from rust_pathtracer_tpu_torch.ops.worklist import closest_hit_pairs

        return closest_hit_pairs(tables, o, d, t_min)
    if route != "dense":
        raise ValueError(f"unknown route {route!r}; want one of {ROUTES}")
    return projected_sweep(tables, o, d, t_min)


def closest_hit_record_projected(scene, o, d, t_min, route: Optional[str] = None):
    """The forward route's search and hit record from the winner's
    payload (projected.py:892-936): (hit, t (1 on a miss), idx, HitRecord,
    shade_row).  ``shade_row`` is payload columns 16-31 when the tables
    are ``shade_ready``, else None.  Not differentiable."""
    t, col, pay = closest_hit_routed(scene.proj, o, d, t_min, route)
    hit = col >= 0
    kind = torch.round(pay[:, PAY_KIND]).to(torch.int32)
    aux = torch.round(pay[:, PAY_AUX]).to(torch.int32)
    mat = torch.round(pay[:, PAY_MAT]).to(torch.int32)
    idx = torch.round(pay[:, PAY_IDX]).to(torch.int32).clamp(min=0)
    t_safe = torch.where(hit, t, torch.ones_like(t))
    rec = record_from_rows(kind, aux, pay[:, :12], mat, idx, o, d, t_safe, hit,
                           prim_types=scene.prim_types)
    shade_row = pay[:, PAY_MKIND:] if scene.proj.shade_ready else None
    return hit, t_safe, idx, rec, shade_row
