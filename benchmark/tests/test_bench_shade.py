"""The shade kernel's two readers on hand-built traces whose answers are
known, and on traces without the kernel (a parent commit, a route that
bypasses it), where they read None and do not raise."""

import types

import pytest

from benchmark import profiling, spec

NAME = ("void (anonymous namespace)::shade_bounce_kernel((anonymous namespace)::Args, "
        "int, int, long long)")
OPS = [("void (anonymous namespace)::sweep_kernel<1>(...)", 0.0, 2200.0),
       (NAME, 2300.0, 2600.0), ("bounce_draws_kernel", 2600.0, 2650.0),
       ("void (anonymous namespace)::sweep_kernel<1>(...)", 3000.0, 5000.0),
       (NAME, 5100.0, 5350.0)]


def _read(name, ops, bounces=2, trace=True):
    tr = types.SimpleNamespace(ops=list(ops))
    tr.device_seconds = types.MethodType(profiling.Trace.device_seconds, tr)
    return spec.reader(name)(dict(trace=tr if trace else None, bounces=bounces))


def test_launches_per_bounce():
    assert _read("shade_launches_per_bounce.render", OPS) == 1.0
    assert _read("shade_launches_per_bounce.render", OPS, bounces=4) == 0.5


def test_ms_per_bounce():
    # (300 + 250) us of the kernel over 2 bounces
    assert _read("shade_ms_per_bounce.render", OPS) == pytest.approx(0.275)


@pytest.mark.parametrize("name", ["shade_launches_per_bounce.render",
                                  "shade_ms_per_bounce.render"])
def test_without_the_kernel_reads_none(name):
    others = [op for op in OPS if "shade" not in op[0]]
    assert _read(name, others) is None
    assert _read(name, OPS, bounces=0) is None
    assert _read(name, OPS, trace=False) is None
