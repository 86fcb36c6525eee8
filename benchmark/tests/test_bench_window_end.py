"""The regen window end's two readers on hand-built traces whose answers
are known, and on traces without the kernels (a parent commit, the
tensor-op window end) or without window ends, where they read None and do
not raise."""

import pytest

from benchmark import profiling, spec

FINISH = ("void (anonymous namespace)::window_end_finish_kernel(float const*, int const*, "
          "long long const*, int const*, long long, int, long long, unsigned int*, int*, "
          "int*, int*, float*, int*)")
ADD = "void (anonymous namespace)::window_end_add_kernel(unsigned int const*, ...)"
RESPAWN = "void (anonymous namespace)::window_end_respawn_kernel(float*, int*, ...)"
SORT = "void cub::CUB_200_NS::DeviceRadixSortOnesweepKernel<...>(...)"
# two windows: bounces, then a window end of the three kernels around the
# sort, and a copy of the device block
OPS = [("fused_bounce_kernel", 0.0, 200.0), (FINISH, 200.0, 230.0), (SORT, 230.0, 300.0),
       (ADD, 300.0, 340.0), (RESPAWN, 340.0, 400.0), ("Memcpy DtoH", 400.0, 401.0),
       ("fused_bounce_kernel", 410.0, 600.0), (FINISH, 600.0, 625.0), (SORT, 625.0, 690.0),
       (ADD, 690.0, 735.0), (RESPAWN, 735.0, 790.0)]
HOST = [(0.0, 190.0, "rpt.bounce"), (190.0, 205.0, "rpt.flush"),
        (205.0, 400.0, "rpt.bounce"), (400.0, 420.0, "rpt.flush"),
        (405.0, 415.0, "rpt.sync"), (0.0, 800.0, "rpt.frame")]
NAMES = ("window_end_launches_per_window.regen", "window_end_ms_per_window.regen")


def _read(name, ops=OPS, host=HOST, trace=True):
    tr = profiling.Trace.__new__(profiling.Trace)
    tr.ops, tr.host = list(ops), sorted(host)
    return spec.reader(name)(dict(trace=tr if trace else None, answers=1, renderer="regen",
                                  lanes=1000, bounces=4, segments=3000.0))


def test_launches_per_window():
    assert _read(NAMES[0]) == 3.0
    one_more = OPS + [(FINISH, 800.0, 810.0), (ADD, 830.0, 840.0), (RESPAWN, 840.0, 850.0)]
    assert _read(NAMES[0], one_more, HOST + [(795.0, 799.0, "rpt.flush")]) == 3.0


def test_ms_per_window():
    # (30 + 70 + 40 + 60) + (25 + 65 + 45 + 55) us over 2 window ends: the
    # sort between the finish and the add counted, the bounces and the copy not
    assert _read(NAMES[1]) == pytest.approx((200.0 + 190.0) / 2 / 1e3)
    # a trace that ends inside a window end: its finish and sort left out
    cut = OPS + [(FINISH, 800.0, 810.0), (SORT, 810.0, 870.0)]
    assert _read(NAMES[1], cut) == pytest.approx((200.0 + 190.0) / 2 / 1e3)


@pytest.mark.parametrize("name", NAMES)
def test_without_the_kernels_reads_none(name):
    parent = [op for op in OPS if "window_end_" not in op[0]]
    assert _read(name, parent) is None
    assert _read(name, host=[h for h in HOST if h[2] != "rpt.flush"]) is None
    assert _read(name, ops=(), host=()) is None
    assert _read(name, trace=False) is None
