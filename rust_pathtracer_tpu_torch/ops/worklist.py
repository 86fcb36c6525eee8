"""The per-block cluster worklist and K7, the fixed-capacity pair sweep.

Counterpart of ``rust_pathtracer_tpu/ops/worklist.py``.

``build_pair_worklist`` (tensor code, worklist.py:88-166, the "cid"
order): each lane's slab test against every cluster AABB, OR-reduced
over blocks of ``rb`` lanes, then each block's passing clusters
compacted into ``kcap`` slots, ascending, empty slots of kind -1.  A
block that passes more than ``kcap`` clusters sets ``overflow``.

K7 (``pair_sweep``, replaces ``worklist.py::_pair_kernel``) runs the
projected sweep (``projected.py``) over each lane's block's ``kcap``
slots, empty slots as no-ops, spheres always in the q domain, a strict
``t < best`` take.  ``closest_hit_pairs`` falls back to K5 when the
worklist overflows, as worklist.py:331-353 does; on a single-p-block
table the two give the same result bit for bit.

The block ``rb`` and the capacity ``kcap`` are the card's choices; they
change which clusters a lane tests and whether the worklist overflows,
never a result (every kernel also culls each lane by its own slab
test).  A block is one warp, WL_RB = 32 lanes (the TPU kernel's 1,024
lanes were 8 x 128 rows of its vector unit).  The capacity is WL_KCAP =
64 slots, not the TPU kernel's 12: on the
20,000-triangle ModelTest at 800x800, a 32-lane block passes up to 32
clusters at the first bounce and up to 118 at the second, so 12 slots
overflowed on all 20 bounces and K7 never ran, where 64 run it on 11 of
20 (slot counts of ``build_pair_worklist`` on the CPU).  An empty slot
costs K7 one load.
"""

from __future__ import annotations

import torch

from rust_pathtracer_tpu_torch.ops.projected import (
    ProjTables,
    _sweep_plain,
    check_inputs,
    launch_sweep,
    projected_sweep,
    slab_bounds,
)
from rust_pathtracer_tpu_torch.scene.types import PRIM_SPHERE
from rust_pathtracer_tpu_torch.utils.metrics import span

WL_KCAP = 64  # cluster slots a block (the TPU's worklist.py:82 had 12)
WL_RB = 32    # lanes a block on the card: one warp
M_CID, M_KIND = 0, 1  # slot table rows
# lanes a slab chunk of the worklist build: bounds its (lanes, G) planes
BUILD_CHUNK = 1 << 17

# K7 launches (CUDA tensors only); the overflow fallback's K5 launches
# count in projected.launches
launches = 0


def build_pair_worklist(cluster_bounds, group_kinds, o, d, t_min, rb, kcap):
    """Per-block cluster slots.  o, d: (Rp, 3) with Rp a multiple of
    ``rb``.  Returns (meta (2, W) int32, overflow (bool tensor)) with
    W = (Rp / rb) * min(kcap, G); meta rows are [cluster id (0 on an
    empty slot), cluster kind (-1 = empty)]."""
    R = o.shape[0]
    if R % rb:
        raise ValueError(f"{R} lanes is not a multiple of the block {rb}")
    G = cluster_bounds.shape[1]
    nblocks = R // rb
    kcap = min(kcap, G)
    dev = o.device
    step = max(rb, BUILD_CHUNK // rb * rb)
    blockpass = torch.empty((nblocks, G), dtype=torch.bool, device=dev)
    for s in range(0, R, step):
        lo, hi = slab_bounds(cluster_bounds, o[s:s + step], d[s:s + step], t_min)
        rowpass = hi >= lo
        blockpass[s // rb:(s + rowpass.shape[0]) // rb] = (
            rowpass.view(-1, rb, G).any(dim=1))
    count = blockpass.sum(dim=1)
    overflow = (count > kcap).any()
    W = nblocks * kcap
    pos = torch.cumsum(blockpass.to(torch.int64), dim=1) - 1
    rowbase = torch.arange(nblocks, dtype=torch.int64, device=dev)[:, None] * kcap
    slot = torch.where(blockpass & (pos < kcap), rowbase + pos,
                       torch.full_like(pos, W))
    colid = torch.arange(G, dtype=torch.int64, device=dev).expand(nblocks, G)
    cid = torch.full((W + 1,), -1, dtype=torch.int64, device=dev)
    cid.scatter_(0, slot.reshape(-1), colid.reshape(-1))  # slot W: dropped
    cid = cid[:W]
    lut = torch.tensor((-1,) + tuple(group_kinds), dtype=torch.int64, device=dev)
    kind = lut[cid + 1]
    return torch.stack([cid.clamp(min=0), kind]).to(torch.int32), overflow


def listed_clusters(cids, real, nblocks, G):
    """(nblocks, G) bool: the clusters each block's real slots list.
    ``cids``, ``real``: (nblocks, kcap)."""
    listed = torch.zeros((nblocks, G + 1), dtype=torch.bool, device=cids.device)
    col = torch.where(real, cids.long(), torch.full_like(cids, G).long())
    listed.scatter_(1, col, torch.ones_like(real))
    return listed[:, :G]


def pair_sweep_plain(tables: ProjTables, o, d, t_min, meta, rb, stats=None):
    """K7 in tensor ops: the sweep over each block's real slots.
    ``stats``: see ``projected._sweep_plain``."""
    nblocks = -(-o.shape[0] // rb)
    kcap = meta.shape[1] // nblocks
    listed = listed_clusters(meta[M_CID].view(nblocks, kcap),
                             meta[M_KIND].view(nblocks, kcap) >= 0,
                             nblocks, tables.num_groups)
    q = tuple(k == PRIM_SPHERE for k in tables.group_kinds)
    return _sweep_plain(tables, o, d, t_min, q_flags=q, listed=listed, rb=rb,
                        stats=stats)


def pair_sweep(tables: ProjTables, o, d, t_min, meta, rb):
    """K7: (t, column, payload) over the slot table ``meta`` (2, W) of
    blocks of ``rb`` lanes (``build_pair_worklist``).  CUDA tensors
    launch the kernel and count in ``launches``; CPU tensors run
    ``pair_sweep_plain``."""
    dev = check_inputs("pair_sweep", tables, o, d)
    nblocks = -(-o.shape[0] // rb)
    if (meta.dim() != 2 or meta.shape[0] != 2 or meta.dtype != torch.int32
            or meta.device != dev or meta.shape[1] % nblocks):
        raise ValueError(f"pair_sweep: slot table of shape {tuple(meta.shape)} "
                         f"({meta.dtype}), want (2, {nblocks} * kcap) int32 "
                         f"on {dev}")
    if dev.type == "cpu":
        return pair_sweep_plain(tables, o, d, t_min, meta, rb)
    if rb % 32:
        raise ValueError(f"pair_sweep: blocks of {rb} lanes; the kernel's warps of 32 "
                         f"need a multiple of 32")
    out = launch_sweep("pairs", tables, o, d, t_min, words=meta.contiguous(),
                       kcap=meta.shape[1] // nblocks, rb=rb)
    global launches
    launches += 1
    return out


def closest_hit_pairs(tables: ProjTables, o, d, t_min, kcap=WL_KCAP):
    """The worklist closest hit (worklist.py:311-353): build the slots
    of blocks of WL_RB lanes, run K7, or K5 when a block overflows
    ``kcap``.  Returns the sweep's (t, column, payload)."""
    check_inputs("closest_hit_pairs", tables, o, d)
    R, rb = o.shape[0], WL_RB
    Rp = -(-R // rb) * rb
    pad = torch.zeros((Rp - R, 3), dtype=o.dtype, device=o.device)
    meta, overflow = build_pair_worklist(
        tables.cluster_bounds, tables.group_kinds, torch.cat([o, pad]),
        torch.cat([d, pad]), t_min, rb, kcap)
    with span("rpt.sync"):
        overflowed = bool(overflow)
    if not overflowed:
        return pair_sweep(tables, o, d, t_min, meta, rb)
    return projected_sweep(tables, o, d, t_min)
