"""The span metrics' readers and ``benchmark/spans.py`` on hand-built
traces whose answers are known: nested and overlapping syncs, idle time
partly inside a span, and no spans at all (the reader returns None);
then a toy traced run of a render cell through the harness."""

import types

import pytest

from benchmark import harness, spans, spec

SPAN_METRICS = ("host_ms_per_bounce.render", "loop_idle_ms_per_bounce.render",
                "syncs_per_frame.render", "forward_idle_ms.step", "backward_idle_ms.step")


def _trace(ops=(), host=()):
    """A ``profiling.Trace`` as the readers see it: device ops (name,
    start, end) and host events (start, end, name), in microseconds."""
    return types.SimpleNamespace(ops=list(ops), host=sorted(host))


def _ctx(trace, answers=2):
    return dict(trace=trace, answers=answers)


def _read(name, ctx):
    return spec.reader(name)(ctx)


# two frames, two bounces: bounce 0 at [0, 100] with a sync inside at
# [10, 30] and a second sync overlapping it at [20, 40]; a liveness sync
# between bounces at [150, 180]; bounce 1 at [200, 300] with a sync at
# [250, 300]; the device busy over [0, 50], [40, 90] and [260, 400]
HOST = [(0.0, 100.0, "rpt.bounce"), (10.0, 30.0, "rpt.sync"), (20.0, 40.0, "rpt.sync"),
        (150.0, 180.0, "rpt.sync"), (200.0, 300.0, "rpt.bounce"), (250.0, 300.0, "rpt.sync"),
        (0.0, 180.0, "rpt.frame"), (190.0, 400.0, "rpt.frame"), (5.0, 8.0, "aten::add")]
OPS = [("k1", 0.0, 50.0), ("cat", 40.0, 90.0), ("k1", 260.0, 400.0)]


def test_union_intersect_length():
    u = spans.union([(5.0, 9.0), (0.0, 2.0), (1.0, 3.0), (9.0, 10.0)])
    assert u == [(0.0, 3.0), (5.0, 10.0)]
    assert spans.intersect(u, [(2.0, 6.0), (8.0, 20.0)]) == [(2.0, 3.0), (5.0, 6.0),
                                                              (8.0, 10.0)]
    assert spans.intersect(u, []) == [] and spans.union([]) == []
    assert spans.length(u) == 8.0


def test_named_and_idle_within():
    tr = _trace(OPS, HOST)
    assert spans.named(tr, "rpt.bounce") == [(0.0, 100.0), (200.0, 300.0)]
    assert spans.named(tr, "rpt.chunk") == []
    # [0, 100]: busy to 90; [200, 300]: busy from 260
    assert spans.idle_within(tr, spans.named(tr, "rpt.bounce")) == 10.0 + 60.0


def test_host_ms_per_bounce():
    # 200 us of bounces less the syncs inside them: [10, 40] and [250, 300]
    assert _read("host_ms_per_bounce.render", _ctx(_trace(OPS, HOST))) == pytest.approx(
        (200.0 - 30.0 - 50.0) / 2 / 1e3)
    # the host's time reads without device operations (a CPU run)
    assert _read("host_ms_per_bounce.render", _ctx(_trace((), HOST))) == pytest.approx(0.06)


def test_loop_idle_ms_per_bounce():
    # the loop: [0, 100], [150, 180], [200, 300]; idle in it: [90, 100],
    # [150, 180], [200, 260]
    got = _read("loop_idle_ms_per_bounce.render", _ctx(_trace(OPS, HOST)))
    assert got == pytest.approx((10.0 + 30.0 + 60.0) / 2 / 1e3)
    assert _read("loop_idle_ms_per_bounce.render", _ctx(_trace((), HOST))) is None


def test_syncs_per_frame():
    assert _read("syncs_per_frame.render", _ctx(_trace(OPS, HOST))) == 4 / 2
    assert _read("syncs_per_frame.render", _ctx(_trace(OPS, HOST), answers=4)) == 4 / 4
    # syncs without frame spans: not a frame's count
    no_frames = [h for h in HOST if h[2] != "rpt.frame"]
    assert _read("syncs_per_frame.render", _ctx(_trace(OPS, no_frames))) is None


def test_step_idle():
    host = [(0.0, 120.0, "rpt.forward"), (130.0, 300.0, "rpt.backward"),
            (400.0, 500.0, "rpt.forward"), (510.0, 600.0, "rpt.backward"),
            (300.0, 390.0, "Optimizer.step#Adam.step")]
    ops = [("k1", 0.0, 100.0), ("k2", 150.0, 280.0), ("adam", 300.0, 390.0),
           ("k1", 400.0, 490.0), ("k2", 520.0, 600.0)]
    tr = _trace(ops, host)
    # forward idle: [100, 120] and [490, 500]; backward: [130, 150],
    # [280, 300] and [510, 520]; Adam's time in neither
    assert _read("forward_idle_ms.step", _ctx(tr)) == pytest.approx(30.0 / 2 / 1e3)
    assert _read("backward_idle_ms.step", _ctx(tr)) == pytest.approx(50.0 / 2 / 1e3)
    assert _read("backward_idle_ms.step", _ctx(_trace((), host))) is None


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_no_spans_reads_none(name):
    """A program without the spans (a parent commit), no trace, and no
    answers each read None and do not raise."""
    plain = [(0.0, 1000.0, "aten::add"), (10.0, 20.0, "aten::item")]
    assert _read(name, _ctx(_trace(OPS, plain))) is None
    assert _read(name, _ctx(_trace(OPS, []))) is None
    assert _read(name, _ctx(None)) is None


def test_toy_render_run_reads_the_host_span_metrics():
    """A traced toy run of ``cornell-render`` on the CPU: the host-side
    span metrics read, the device-idle one does not (no device ops)."""
    out = harness.run_cell("cornell-render", 3000000019, 0.1, True, device="cpu", toy=True)
    assert out["correct"] is True
    got = out["metrics"]
    assert got["host_ms_per_bounce.render"]["value"] > 0
    assert got["syncs_per_frame.render"]["value"] >= 1
    assert got["syncs_per_frame.render"]["unit"] == "syncs"
    assert "loop_idle_ms_per_bounce.render" not in got
