"""K6, the resident-table sweep over each block's passing clusters.

Counterpart of ``rust_pathtracer_tpu/ops/resident.py`` with its
defaults (no block t-pruning, no per-slot epilogue skip, capacity = every
cluster).  K6 (``resident_sweep``, replaces ``resident.py::_res_kernel``)
runs the projected sweep (``projected.py``) over the first
``counts[block]`` slots of the lane's block, each slot a packed word
``cid * 4 + kind``, spheres always in the q domain, and takes a group
on a strictly smaller t or on an equal t at a lower column
(resident.py:159; a no-op in ascending order).  With a capacity of G
slots no block can overflow, so ``closest_hit_resident`` needs no
fallback.  The tables stay in global memory (L2-resident: 3.6 MB for
ModelTest's 10,240 columns); the TPU's VMEM residency has no
counterpart to carry.

The worklist is ``worklist.build_pair_worklist`` with blocks of WL_RB
lanes (one warp; the TPU kernel used 1,024).
"""

from __future__ import annotations

import torch

from rust_pathtracer_tpu_torch.ops.projected import (
    ProjTables,
    _sweep_plain,
    check_inputs,
    launch_sweep,
)
from rust_pathtracer_tpu_torch.ops.worklist import (
    M_CID,
    M_KIND,
    WL_RB,
    build_pair_worklist,
    listed_clusters,
)
from rust_pathtracer_tpu_torch.scene.types import PRIM_SPHERE

# K6 launches (CUDA tensors only)
launches = 0


def pack_slots(meta, nblocks):
    """(packed (W,) int32 ``cid * 4 + kind``, counts (nblocks,) int32 of
    real slots) from a worklist's (2, W) slot table."""
    kcap = meta.shape[1] // nblocks
    counts = (meta[M_KIND].view(nblocks, kcap) >= 0).sum(dim=1).to(torch.int32)
    packed = meta[M_CID] * 4 + meta[M_KIND].clamp(0, 3)
    return packed.to(torch.int32), counts


def resident_sweep_plain(tables: ProjTables, o, d, t_min, packed, counts, rb,
                         stats=None):
    """K6 in tensor ops: the sweep over each block's first counts slots.
    ``stats``: see ``projected._sweep_plain``."""
    nblocks = counts.shape[0]
    kcap = packed.shape[0] // nblocks
    words = packed.view(nblocks, kcap)
    real = torch.arange(kcap, device=packed.device)[None, :] < counts[:, None]
    listed = listed_clusters(words >> 2, real, nblocks, tables.num_groups)
    q = tuple(k == PRIM_SPHERE for k in tables.group_kinds)
    return _sweep_plain(tables, o, d, t_min, q_flags=q, listed=listed, rb=rb,
                        tie_break=True, stats=stats)


def resident_sweep(tables: ProjTables, o, d, t_min, packed, counts, rb):
    """K6: (t, column, payload) over the packed slots ``packed`` (W,)
    and real-slot ``counts`` (nblocks,) of blocks of ``rb`` lanes
    (``pack_slots``).  CUDA tensors launch the kernel and count in
    ``launches``; CPU tensors run ``resident_sweep_plain``."""
    dev = check_inputs("resident_sweep", tables, o, d)
    nblocks = -(-o.shape[0] // rb)
    for x in (packed, counts):
        if x.dim() != 1 or x.dtype != torch.int32 or x.device != dev:
            raise ValueError(f"resident_sweep: slots of shape {tuple(x.shape)} "
                             f"({x.dtype}, {x.device}), want 1-d int32 on {dev}")
    if counts.shape[0] != nblocks or packed.shape[0] % nblocks:
        raise ValueError(f"resident_sweep: {counts.shape[0]} counts and "
                         f"{packed.shape[0]} slots for {nblocks} blocks")
    if dev.type == "cpu":
        return resident_sweep_plain(tables, o, d, t_min, packed, counts, rb)
    kinds, qflags = tables.kernel_ints
    out = launch_sweep("resident", tables, o, d, t_min, kinds, qflags,
                       words=packed.contiguous(), counts=counts.contiguous(),
                       kcap=packed.shape[0] // nblocks, rb=rb)
    global launches
    launches += 1
    return out


def closest_hit_resident(tables: ProjTables, o, d, t_min):
    """The resident closest hit (resident.py:299-393, capacity = G):
    build the slots of blocks of WL_RB lanes and run K6.  Returns
    ``resident_sweep``'s (t, column, payload)."""
    check_inputs("closest_hit_resident", tables, o, d)
    R, rb = o.shape[0], WL_RB
    Rp = -(-R // rb) * rb
    pad = torch.zeros((Rp - R, 3), dtype=o.dtype, device=o.device)
    meta, _ = build_pair_worklist(
        tables.cluster_bounds, tables.group_kinds, torch.cat([o, pad]),
        torch.cat([d, pad]), t_min, rb, tables.num_groups)
    packed, counts = pack_slots(meta, Rp // rb)
    return resident_sweep(tables, o, d, t_min, packed, counts, rb)
