"""K6, the resident-table sweep.

Counterpart of ``rust_pathtracer_tpu/ops/resident.py`` with its
defaults (no block t-pruning, no per-slot epilogue skip, capacity = every
cluster).  K6 (``resident_sweep``, replaces ``resident.py::_res_kernel``)
runs the projected sweep (``projected.py``) over every cluster, spheres
always in the q domain, and takes a group on a strictly smaller t or on
an equal t at a lower column (resident.py:159; a no-op in ascending
order, kept as K6's rule).  The tables stay in global memory
(L2-resident: ModelTest's 10,240 columns are 0.66 MB of compact rows and
1.3 MB of payload); the TPU's VMEM residency has no counterpart to carry.

The TPU kernel sweeps the slots its block of 1,024 lanes lists
(``build_pair_worklist`` at capacity G), because a grid step needs a
static slot list.  On the card each warp's ballot of its lanes' slab
tests is that list, so no worklist is built, and no bit moves: a lane
sweeps a cluster where its own test passes at its running best tb
(``min(hi, tb) >= lo``), which implies ``hi >= lo`` (a NaN fails both),
the test that lists the cluster for the lane's block; at capacity G no
block overflows.  So the block list removes nothing the lane's own test
keeps (``tests/test_torch_projected_rows.py`` holds the plain sweep with
the list against the sweep without it).
"""

from __future__ import annotations

from rust_pathtracer_tpu_torch.ops.projected import (
    ProjTables,
    _sweep_plain,
    check_inputs,
    launch_sweep,
)
from rust_pathtracer_tpu_torch.scene.types import PRIM_SPHERE

# K6 launches (CUDA tensors only)
launches = 0


def resident_sweep_plain(tables: ProjTables, o, d, t_min, stats=None):
    """K6 in tensor ops: every cluster, spheres in q, K6's tie-break
    take.  ``stats``: see ``projected._sweep_plain``."""
    q = tuple(k == PRIM_SPHERE for k in tables.group_kinds)
    return _sweep_plain(tables, o, d, t_min, q_flags=q, tie_break=True, stats=stats)


def resident_sweep(tables: ProjTables, o, d, t_min):
    """K6: (t, column, payload) of each ray's closest hit, t = T_MISS,
    column -1 and payload 0 on a miss.  CUDA tensors launch the kernel
    and count in ``launches``; CPU tensors run ``resident_sweep_plain``."""
    dev = check_inputs("resident_sweep", tables, o, d)
    if dev.type == "cpu":
        return resident_sweep_plain(tables, o, d, t_min)
    out = launch_sweep("resident", tables, o, d, t_min)
    global launches
    launches += 1
    return out


def closest_hit_resident(tables: ProjTables, o, d, t_min):
    """The resident closest hit (resident.py:299-393, capacity = G): K6
    on the lanes as they are, no worklist.  Returns ``resident_sweep``'s
    (t, column, payload)."""
    return resident_sweep(tables, o, d, t_min)
