"""K1's bytes in its per-lane form, the regen wavefront's launch.

``yardstick.py`` is frozen; this module adds what it lacks and edits it
not at all.  The regen pool (``rust_pathtracer_tpu_torch/wavefront.py``)
launches K1 (``ops/csrc/fused_bounce.cu``, ``fused_bounce_kernel``) over
the whole pool at every bounce with a depth row: each lane reads its own
int32 path depth (``depth[i]``) where a chunk's launch takes one bounce
index.  So a per-lane launch moves ``yardstick.k1_bytes`` of the pool
(the shading table and the background read once a launch, the 13 state
rows and 2 key rows read, the 13 state rows written; no residuals, no
winner row) plus the depth row.  As in ``k1_bytes``, every lane is
counted as live: a lane that is dead on entry reads and writes its state
but skips its keys and depth; and the operations, which need each lane's
winner, are left out, so a share from this bound is a lower bound of the
launch's roofline share.
"""

from __future__ import annotations

from benchmark.yardstick import K1_TABLE_ROWS, KEY_ROWS, STATE_ROWS, bound

DEPTH_ROWS = 1  # the int32 path depth a lane


def k1_lane_bytes(lanes: int, n_prims: int) -> int:
    """The bytes one per-lane K1 launch over a pool of ``lanes`` moves."""
    table = K1_TABLE_ROWS * n_prims * 4
    reads = table + 3 * 4 + (STATE_ROWS + KEY_ROWS + DEPTH_ROWS) * 4 * lanes
    return reads + STATE_ROWS * 4 * lanes


def k1_lane_bound(lanes: int, n_prims: int):
    """(ms, "bytes"): the least time of one per-lane launch, by its bytes."""
    return bound(k1_lane_bytes(lanes, n_prims), 0)
