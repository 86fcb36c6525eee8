"""The benchmark as data: BENCHMARK.json keeps the contract's shapes, every
cell's files load by name, and a cell added as new files only runs."""

import json
import os
import re
import shutil

import pytest

from benchmark import harness, spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WORKLOADS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"][1].startswith("benchmark/")
    assert os.path.getsize(os.path.join(spec.ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_entries():
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source", "workloads"},
            "per_layer": {"name", "unit", "better", "source", "layer", "moves", "workloads"}}
    for section, allowed in keys.items():
        names = [e["name"] for e in BENCH[section]]
        assert len(names) == len(set(names))
        for e in BENCH[section]:
            assert set(e) <= allowed, (section, e["name"])
            assert NAME.match(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for text in (e.get("why"), e.get("layer"), e.get("source")):
                assert text is None or (0 < len(text) <= 200 and "\n" not in text)
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in BENCH["end_to_end"])


def test_every_cell_reports_what_it_moves():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    four = [w for w in BENCH["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(BENCH["workloads"]) // 4)
    for w in BENCH["workloads"]:
        cell = spec.Cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in names and m["moves"] in e2e


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_load_by_name(workload):
    cell = spec.Cell(workload)
    assert cell.traffic["loop"] in ("frames", "steps")
    assert cell.limits()
    readers = cell.readers()
    ctx = dict(cell=cell, trace=None, answers=0, bounces=0, scene_build_s=1.0, ranks=1,
               counts={"by_type": [0, 0, 0], "total": 0}, lanes=0, img={})
    for name, read in readers.items():
        assert read(ctx) is None or name == "scene_build_s"
    conf = next(c for c in BENCH["configs"] if c["name"] == cell.entry["config"])
    with open(os.path.join(spec.ROOT, conf["file"])) as f:
        data = json.load(f)
    assert set(conf["reduced"]) == set(data["reduced"])


def test_a_cell_added_as_files_runs(tmp_path):
    """A new traffic mix, limits file, metric reader and entries, and no
    edit to a file that is there: the harness finds and runs them."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads(json.dumps(BENCH))
    traffic = spec.traffic("frames-bigchunk")
    traffic["spp_chunk"] = 20
    traffic["toy"]["spp_chunk"] = 2
    (root / "benchmark" / "traffic" / "frames-small-chunk.json").write_text(json.dumps(traffic))
    shutil.copy(root / "benchmark" / "limits" / "cornell-render.json",
                root / "benchmark" / "limits" / "cornell-small-chunk.json")
    (root / "benchmark" / "metrics" / "answers_traced.py").write_text(
        "def read(ctx):\n    return float(ctx['answers'])\n")
    bench["workloads"].append({"name": "cornell-small-chunk", "config": "cornellbox",
                               "traffic": "frames-small-chunk", "chips": 1, "why": "a fixture"})
    bench["per_layer"].append({"name": "answers_traced", "unit": "frames", "better": "higher",
                               "source": "program_counter", "layer": "frame / step",
                               "moves": "render_samples_per_s",
                               "workloads": ["cornell-small-chunk"]})
    for m in bench["end_to_end"]:
        if "workloads" in m and "cornell-render" in m["workloads"]:
            m["workloads"].append("cornell-small-chunk")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    out = harness.run_cell("cornell-small-chunk", 5, 0.1, True, device="cpu", toy=True,
                           root=str(root))
    assert out["correct"] is True
    assert out["metrics"]["answers_traced"]["value"] == 1.0
