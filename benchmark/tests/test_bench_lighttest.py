"""The ``lighttest-regen`` cell on the CPU: the real cell at its toy size
reads ``correct`` traced and untraced, and false with a fault planted
under the regen renderer; its three readers on hand-built traces whose
answers are known, and on traces without what they read (None, as on a
program without the ``rpt.flush`` span); the per-lane K1 bytes against
a hand count."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness, profiling, spec
from benchmark import yardstick as ys
from benchmark import yardstick_regen as ysr
from benchmark.tests import faults

CELL = "lighttest-regen"
# faults.py's frame faults as the regen renderer meets them: the frame
# altered where it is produced; half the samples left out (the paths of odd
# work ids spawn with no throughput), the mean over the rest
REGEN_FAULTS = {
    "regen_altered": (
        "from rust_pathtracer_tpu_torch import wavefront\n"
        "real = wavefront.render_radiance_regen\n"
        "def regen(*a, **kw):\n"
        "    img, stats = real(*a, **kw)\n"
        "    return img * 1.01, stats\n"
        "wavefront.render_radiance_regen = regen\n"),
    "regen_half": (
        "from rust_pathtracer_tpu_torch import wavefront\n"
        "real = wavefront._spawn\n"
        "def spawn(fr, wid):\n"
        "    pixel, keys, state = real(fr, wid)\n"
        "    state[6:9] *= 2.0 * (wid % 2 == 0)\n"
        "    return pixel, keys, state\n"
        "wavefront._spawn = spawn\n")}


def _read(name, ctx):
    return spec.reader(name)(ctx)


def _trace(ops=(), host=()):
    """A ``profiling.Trace`` of device ops (name, start, end) and host
    events (start, end, name), in microseconds."""
    tr = profiling.Trace.__new__(profiling.Trace)
    tr.ops, tr.host = list(ops), sorted(host)
    return tr


def _ctx(trace, **kw):
    ctx = dict(trace=trace, answers=1, renderer="regen", lanes=1000, bounces=8,
               segments=6000.0, counts={"total": 5})
    ctx.update(kw)
    return ctx


@pytest.mark.parametrize("trace", [False, True])
def test_the_cell_reads_correct_at_its_toy_size(trace):
    out = harness.run_cell(CELL, 3000000031, 0.1, trace, device="cpu", toy=True)
    assert out["correct"] is True and out["failed"] == 0, out["check"]
    assert set(out["check"]) == {"pixel_mae", "pixel_max"}
    got = out["metrics"]
    if trace:
        # a count: the readers' segments over the toy pool's lane-bounces
        assert 0.0 < got["pool_occupancy.regen"]["value"] <= 1.0
        assert got["pool_occupancy.regen"]["unit"] == "share"
        # no device operations on the CPU: the device readers find nothing
        assert "flush_idle_ms_per_window.regen" not in got and "k1_lane_roofline" not in got
    else:
        assert set(got) == {"render_samples_per_s", "setup_s", "peak_mem_gib"}


@pytest.mark.parametrize("fault", faults.PERLIN_FAULTS + tuple(sorted(REGEN_FAULTS)))
def test_a_planted_fault_reads_incorrect(fault, tmp_path):
    plant = REGEN_FAULTS.get(
        fault, "from benchmark.tests import faults\nfaults.plant(os.environ['BENCH_FAULT'])\n")
    (tmp_path / "sitecustomize.py").write_text(
        f"import os, sys\nsys.path.insert(0, {spec.ROOT!r})\n" + plant)
    env = dict(os.environ, BENCH_FAULT=fault,
               PYTHONPATH=os.pathsep.join([str(tmp_path), spec.ROOT]))
    code = ("import json; from benchmark import harness; "
            f"print(json.dumps(harness.run_cell({CELL!r}, 2 ** 33 + 11, 0.1, False, "
            "device='cpu', toy=True)))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is False and out["failed"] >= 1


def test_pool_occupancy():
    tr = _trace()
    assert _read("pool_occupancy.regen", _ctx(tr)) == 6000.0 / (8 * 1000)
    assert _read("pool_occupancy.regen", _ctx(tr, bounces=3, lanes=4, segments=6.0)) == 0.5
    # a count: it reads with or without device operations, and only traced
    assert _read("pool_occupancy.regen", _ctx(None)) is None
    assert _read("pool_occupancy.regen", _ctx(tr, renderer="chunked")) is None
    assert _read("pool_occupancy.regen", _ctx(tr, bounces=0)) is None


# two windows of two bounces each: bounces at [0, 100] and [110, 200], the
# first window end at [200, 260] with a sync at [210, 250]; bounces at
# [260, 300] and [300, 400], the second end at [400, 500] with syncs at
# [410, 430] and [440, 480]; the device busy over [0, 205], [240, 270],
# [300, 420] and [470, 490]
HOST = [(0.0, 100.0, "rpt.bounce"), (110.0, 200.0, "rpt.bounce"),
        (200.0, 260.0, "rpt.flush"), (210.0, 250.0, "rpt.sync"),
        (260.0, 300.0, "rpt.bounce"), (300.0, 400.0, "rpt.bounce"),
        (400.0, 500.0, "rpt.flush"), (410.0, 430.0, "rpt.sync"), (440.0, 480.0, "rpt.sync"),
        (0.0, 500.0, "rpt.frame")]
OPS = [("fused_bounce_kernel", 0.0, 205.0), ("nonzero", 240.0, 270.0),
       ("fused_bounce_kernel", 300.0, 420.0), ("index_put", 470.0, 490.0)]


def test_flush_idle_ms_per_window():
    # idle inside [200, 260]: [205, 240]; inside [400, 500]: [420, 470], [490, 500]
    got = _read("flush_idle_ms_per_window.regen", _ctx(_trace(OPS, HOST)))
    assert got == pytest.approx((35.0 + 50.0 + 10.0) / 2 / 1e3)
    # no flush spans (a program without them), no device operations, no trace
    parent = [h for h in HOST if h[2] != "rpt.flush"]
    assert _read("flush_idle_ms_per_window.regen", _ctx(_trace(OPS, parent))) is None
    assert _read("flush_idle_ms_per_window.regen", _ctx(_trace((), HOST))) is None
    assert _read("flush_idle_ms_per_window.regen", _ctx(None)) is None


def test_k1_lane_roofline():
    # two launches over 1,000 lanes of a 5-primitive table, 325 us of device time
    least_ms = ((32 * 5 * 4 + 12 + 16 * 4 * 1000 + 13 * 4 * 1000) / 3.35e12) * 1e3
    got = _read("k1_lane_roofline", _ctx(_trace(OPS, HOST)))
    assert got == pytest.approx(100.0 * 2 * least_ms / 325e-3)
    # without K1's launches, untraced, or on the chunked renderer: None
    no_k1 = [op for op in OPS if op[0] != "fused_bounce_kernel"]
    assert _read("k1_lane_roofline", _ctx(_trace(no_k1, HOST))) is None
    assert _read("k1_lane_roofline", _ctx(None)) is None
    assert _read("k1_lane_roofline", _ctx(_trace(OPS, HOST), renderer="chunked")) is None


@pytest.mark.parametrize("lanes", [1, 8_388_608])
def test_k1_lane_bytes_by_hand(lanes):
    # table 32 rows x 5 prims x 4 B, background 12 B; read: 13 state rows,
    # 2 key rows, 1 depth row; written: 13 state rows, 4 B a lane each
    want = 640 + 12 + (13 + 2 + 1) * 4 * lanes + 13 * 4 * lanes
    assert ysr.k1_lane_bytes(lanes, 5) == want
    # the chunked launch's count and the depth row, nothing else
    assert ysr.k1_lane_bytes(lanes, 5) == ys.k1_bytes(lanes, 5) + 4 * lanes
    assert ysr.k1_lane_bound(lanes, 5) == (want / 3.35e12 * 1e3, "bytes")
