"""The frozen bound arithmetic against hand counts at small shapes."""

import pytest

from benchmark import yardstick as ys


def test_bound_takes_the_larger_of_bytes_and_operations():
    assert ys.bound(3.35e12, 0) == pytest.approx((1000.0, "bytes"))
    assert ys.bound(0, 67e12) == pytest.approx((1000.0, "operations"))
    assert ys.bound(0, 0, 0, 34e12) == pytest.approx((1000.0, "operations"))
    # f32 and int32 share the time; f64 is its own pipe
    t, kind = ys.bound(1.0, 67e12, ys.PEAK_INT32_PER_S, 34e12)
    assert kind == "operations" and t == pytest.approx(2000.0)


def test_k1_bytes_by_hand():
    # table 32 rows x 2 prims x 4 B, background 12 B, 13 state + 2 key rows
    # read and 13 state rows written, 10 lanes
    assert ys.k1_bytes(10, 2) == 256 + 12 + 15 * 4 * 10 + 13 * 4 * 10
    assert ys.k1_bytes(10, 2, ys.K1_RESIDUAL_PLANES) == 1388 + 10 * 4 * 10


def test_k2_bound_by_hand():
    ms, kind = ys.k2_bound(1000, 20)
    assert kind == "bytes"
    assert ms == pytest.approx((37 * 4 * 1000 + (9 * 20 + 3) * 4 + 12) / 3.35e12 * 1e3)


def test_search_bound_by_hand():
    counts = [560, 0, 0]
    assert ys.clusters_of(counts) == [5]
    assert ys.proj_table_bytes(counts) == 560 * (4 + 32) * 4 + 24 * 5
    ms, kind = ys.search_bound(100, [5], 80760)
    by_bytes = (100 * 160 + 80760) / 3.35e12 * 1e3
    by_ops = max(100 * (9 + 12 * 5) / 67e12, 100 * 5 / 34e12) * 1e3
    assert ms == pytest.approx(max(by_bytes, by_ops))
    assert kind == ("bytes" if by_bytes >= by_ops else "operations")


def test_busy_is_the_union_of_intervals():
    assert ys.busy_ms([(0, 10), (5, 20), (30, 40), (35, 36), (50, 50)]) == pytest.approx(0.03)
    assert ys.busy_ms([]) == 0.0
