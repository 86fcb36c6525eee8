"""The check fails what it must: each cell run at a toy size on the CPU
with a fault planted under the timed path reads ``correct`` false, and
the control (the reference in bfloat16 in the program's place) fails one
of each cell's numbers."""

import json
import os
import subprocess
import sys

import pytest
import torch

from benchmark import check, loops, spec
from benchmark.reference.threefry import frame_key
from benchmark.tests import faults

CASES = []
for w in spec.benchmark()["workloads"]:
    cell = spec.Cell(w["name"])
    if cell.traffic["loop"] == "steps":
        CASES += [(w["name"], f) for f in faults.STEP_FAULTS]
    elif cell.traffic.get("mesh"):
        CASES += [(w["name"], f) for f in faults.MESH_FAULTS]
    else:
        CASES += [(w["name"], f) for f in faults.FRAME_FAULTS]


@pytest.mark.parametrize("workload, fault", CASES)
def test_a_planted_fault_reads_incorrect(workload, fault, tmp_path):
    (tmp_path / "sitecustomize.py").write_text(
        "import os, sys\n"
        f"sys.path.insert(0, {spec.ROOT!r})\n"
        "from benchmark.tests import faults\n"
        "faults.plant(os.environ['BENCH_FAULT'])\n")
    env = dict(os.environ, BENCH_FAULT=fault,
               PYTHONPATH=os.pathsep.join([str(tmp_path), spec.ROOT]))
    code = ("import json; from benchmark import harness; "
            f"print(json.dumps(harness.run_cell({workload!r}, 11, 0.1, False, "
            "device='cpu', toy=True)))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is False and out["failed"] >= 1


@pytest.mark.parametrize("workload", [w["name"] for w in spec.benchmark()["workloads"]])
def test_the_control_fails_a_number(workload):
    cell = spec.Cell(workload)
    limits = cell.limits()
    seed = 21
    if cell.traffic["loop"] == "frames":
        img = loops.image(cell, True)
        pixels = loops.check_pixels(cell, seed, img, True)
        t = loops.orbit_time(cell, seed, 0)
        want = check.reference_pixels(cell, frame_key(seed, 0), t, pixels, img, "cpu")
        got = check.reference_pixels(cell, frame_key(seed, 0), t, pixels, img, "cpu",
                                     check.BF16)
        numbers = check.frame_numbers([got], [want])
    else:
        ref = check.reference_steps(cell, seed, "cpu", toy=True)
        ctl = check.reference_steps(cell, seed, "cpu", toy=True, precision=check.BF16)
        numbers = check.step_numbers(ctl, ref)
    assert any(v > limits[n]["limit"] for n, v in numbers.items()), numbers


def test_the_reference_agrees_with_itself():
    cell = spec.Cell("cornell-step")
    ref = check.reference_steps(cell, 21, "cpu", toy=True)
    numbers = check.step_numbers(ref, ref)
    assert all(v == 0.0 for v in numbers.values())
    assert torch.isfinite(torch.tensor(ref[0])).all()
