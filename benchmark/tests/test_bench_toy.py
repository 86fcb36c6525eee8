"""Every cell's code path at a toy size on the CPU through ``run_cell``,
the measuring command without a card, and the modules a run loads."""

import json
import os
import subprocess
import sys

import pytest

from benchmark import harness, spec

WORKLOADS = [w["name"] for w in spec.benchmark()["workloads"]]
SEED = 3000000017


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_runs_at_a_toy_size(workload, trace):
    cell = spec.Cell(workload)
    out = harness.run_cell(workload, SEED, 0.2, bool(trace), device="cpu", toy=True)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "check"
    assert out["correct"] is True and out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["check"]) == set(cell.limits())
    assert out["device"]["platform"] == "cpu" and out["device"]["count"] == cell.chips
    if trace:
        assert set(out["metrics"]) <= {m["name"] for m in cell.per_layer}
        assert "scene_build_s" in out["metrics"]
        assert out["device"]["window_s"] > 0 and "breakdown" in out
    else:
        assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in out["metrics"].values():
        assert m["value"] == m["value"] and m["unit"]


def test_measuring_command_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is here")
    proc = subprocess.run(
        [sys.executable, os.path.join(spec.ROOT, "benchmark", "run.py"), "--workload",
         "cornell-render", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.ROOT, timeout=300)
    assert proc.returncode != 0 and proc.stdout == ""
    assert "CUDA" in proc.stderr


def test_a_run_loads_no_jax_module():
    """A frames cell and the step cell at toy sizes in a fresh process;
    then no module whose top-level name is jax, jaxlib, flax or
    rust_pathtracer_tpu (compared whole) is loaded."""
    code = ("import json, sys; from benchmark import harness; "
            "[harness.run_cell(w, 9, 0.1, False, device='cpu', toy=True) "
            "for w in ('spherefield-render', 'cornell-step')]; "
            "print(json.dumps([harness.forbidden_modules(), "
            "'rust_pathtracer_tpu_torch' in sys.modules]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, check=True, timeout=600).stdout
    found, port_loaded = json.loads(out.splitlines()[-1])
    assert found == [] and port_loaded


def test_a_rank_with_jax_loaded_fails_the_run(tmp_path):
    """A rank other than 0 of the grid that has a forbidden module loaded
    once the window closed fails the run, which prints no result."""
    (tmp_path / "sitecustomize.py").write_text(
        "import os, sys, types\n"
        "if os.environ.get('RANK') == '2':\n"
        "    sys.modules['flax'] = types.ModuleType('flax')\n")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(tmp_path), spec.ROOT]))
    code = ("import json; from benchmark import harness; "
            "print(json.dumps(harness.run_cell('spherefield-render-4chip', 13, 0.1, False, "
            "device='cpu', toy=True)))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode != 0 and proc.stdout.strip() == ""
    assert "modules loaded in rank 2" in proc.stderr and "flax" in proc.stderr


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "rust_pathtracer_tpu_torch_fake", sys)
    monkeypatch.setitem(sys.modules, "jaxlibrary_fake", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jax.fake", sys)
    assert harness.forbidden_modules() == ["jax.fake"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", [w for w in WORKLOADS
                                      if spec.Cell(w).chips == 1])
def test_run_on_the_card(card, workload):
    proc = subprocess.run(
        [sys.executable, os.path.join(spec.ROOT, "benchmark", "run.py"), "--workload",
         workload, "--seed", str(SEED), "--seconds", "2", "--trace", "0"],
        capture_output=True, text=True, cwd=spec.ROOT, timeout=1500)
    assert proc.returncode == 0, proc.stderr[-4000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is True and out["device"]["platform"] == "gpu"
