"""The yardstick: the card's peaks, the least-time bound, and byte counts.

Frozen copies, so that a later change to the scripts they come from does
not move the benchmark's numbers.  From ``chip_smoke.py`` at commit
305d6da3becbf006a816fecd12ece25b3c47b12a: the peaks ``PEAK_*``, ``bound``,
the byte counts of K1's ``k1_work`` (its operations are left out, see
``k1_bytes``), K2's bound (its ``phase_bench_step``), and the per-lane and
per-cluster constants of ``proj_bound``.  From ``profile_port.py`` at the
same commit: ``busy_ms``.
"""

from __future__ import annotations

import math

# The card's peaks (NVIDIA H100 SXM data sheet, dense, at 700 W; f64
# outside the tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12
# int32 operations: not a data-sheet figure but derived from issue rates:
# one warp instruction a clock on each of an SM's four schedulers (128 lanes
# a clock) on each of 132 SMs at the 1.98 GHz boost clock
PEAK_INT32_PER_S = 128 * 132 * 1.98e9

# K2 a lane (fused_bounce_bwd.cu's header): 150 f32 operations; its planes:
# 28 read, 9 written
K2_LANE_OPS = 150
K2_PLANES_IN, K2_PLANES_OUT = 28, 9
# K1's shading table (fused_bounce.PAY_W rows a primitive) and state rows
K1_TABLE_ROWS, STATE_ROWS, KEY_ROWS = 32, 13, 2
# K1 with residuals writes nine f32 planes and a flags word besides
K1_RESIDUAL_PLANES = 10
# the projected sweep (K5, K6, K7): a slab test 12 f32 operations, a
# lane's set-up 9 f32 and 5 f64; bytes a lane: rays in (24), t, column and
# payload out (4 + 4 + 128)
SLAB_OPS, PROJ_LANE_OPS, PROJ_LANE_F64_OPS = 12, 9, 5
PROJ_LANE_BYTES = 24 + 136
GROUP = 128  # columns of a projected cluster, all of one primitive type
# the words of a real column's compact row by primitive type (sphere,
# rect, triangle), and its payload row of 32 floats
ROW_WORDS = (4, 12, 13)


def bound(n_bytes, n_ops, n_int_ops=0, n_f64_ops=0):
    """The least time in ms the card could take: the larger of the bytes
    over the memory rate and the operations' time, the larger of the f32
    operations over the f32 peak plus the int32 operations over the int32
    rate, and the f64 operations over the f64 peak (an SM's FP64 units
    are a pipe of their own).  Returns (ms, "bytes" or "operations")."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(n_ops / PEAK_F32_PER_S + n_int_ops / PEAK_INT32_PER_S,
                n_f64_ops / PEAK_F64_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def k1_bytes(lanes: int, n_prims: int, residual_planes: int = 0) -> int:
    """The bytes one K1 launch moves (``k1_work``'s byte count): the
    shading table, the background, the 13 state rows and 2 key rows read
    once, the 13 state rows (and with residuals their planes) written
    once.  Roulette is off in every configuration here.  ``k1_work``'s
    operations need each lane's winner and are left out, so a share from
    this bound is a lower bound of K1's roofline share; on every lane set
    measured (PR 18) the bytes bound K1, 2-12x the operations."""
    table = K1_TABLE_ROWS * n_prims * 4
    reads = table + 3 * 4 + (STATE_ROWS + KEY_ROWS) * 4 * lanes
    return reads + (STATE_ROWS + residual_planes) * 4 * lanes


def k2_bound(lanes: int, n_prims: int):
    """K2's bound at ``lanes`` lanes (both of its kernels together)."""
    return bound((K2_PLANES_IN + K2_PLANES_OUT) * 4 * lanes + (9 * n_prims + 3) * 4 + 12,
                 K2_LANE_OPS * lanes)


def search_bound(lanes: int, cluster_counts, table_bytes: int):
    """A lower bound of one K5 / K6 sweep over ``lanes`` lanes: ``proj_bound``
    with the work every lane does whatever it hits (its set-up and a slab
    test of every real cluster) and the bytes (rays in, outputs out, the
    tables read once); the clusters a lane's slabs pass and their columns
    need the lanes' own rays, and are left out."""
    clusters = sum(cluster_counts)
    return bound(lanes * PROJ_LANE_BYTES + table_bytes,
                 lanes * (PROJ_LANE_OPS + SLAB_OPS * clusters),
                 n_f64_ops=lanes * PROJ_LANE_F64_OPS)


def clusters_of(counts_by_type) -> list:
    """Real clusters a type of primitive fills: GROUP columns each."""
    return [math.ceil(n / GROUP) for n in counts_by_type if n]


def proj_table_bytes(counts_by_type) -> int:
    """``table_bytes``: each real column's row words and payload row, each
    real cluster's AABB (6 floats), read once."""
    cols = sum(n * (ROW_WORDS[k] + 32) * 4 for k, n in enumerate(counts_by_type))
    return cols + 4 * 6 * sum(clusters_of(counts_by_type))


def busy_ms(intervals):
    """Union of device intervals ((start, end) in microseconds), in ms."""
    spans = sorted((s, e) for s, e in intervals if e > s)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3
