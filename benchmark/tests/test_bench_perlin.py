"""A perlin scene and the regen renderer added as files alone: the
reference's marble is the port's, a LightTest cell reads ``correct`` on
both renderers and fails on a planted perlin fault, and what the
harness cannot run raises when the cell is loaded."""

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import harness, loops, spec
from benchmark.reference import pathtracer as pt
from benchmark.reference import perlin as rp
from benchmark.reference import scene as rs
from benchmark.tests import faults

LIGHTTEST = os.path.join(os.path.dirname(os.path.abspath(__file__)), "lighttest.json")
TOY = {"width": 16, "height": 9, "samples_per_pixel": 8, "max_bounces": 50, "pixels": 60,
       "trace_frames": 1}
RENDERERS = {"chunked": {"spp_chunk": 8, "toy": dict(TOY, spp_chunk=4)},
             "regen": {"renderer": "regen", "lanes": 1 << 20, "toy": dict(TOY, lanes=256)}}
SEED = 3000000017


def lighttest_root(tmp_path, renderers=RENDERERS) -> str:
    """A checkout with a LightTest configuration and one cell a renderer
    (``lighttest-<renderer>``) added as files and entries, and a reader
    that reports what the readers' ``ctx`` holds."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(spec.ROOT, "benchmark"), root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = spec.benchmark()
    cfg = json.load(open(LIGHTTEST))
    (root / "benchmark" / "configs" / "lighttest.json").write_text(json.dumps(cfg))
    bench["configs"].append({"name": "lighttest", "source": cfg["source"],
                             "file": "benchmark/configs/lighttest.json", "reduced": [],
                             "why": "a fixture"})
    (root / "benchmark" / "metrics" / "ctx_seen.py").write_text(
        "import json\n"
        "def read(ctx):\n"
        "    print('ctx ' + json.dumps({k: ctx[k] for k in ('segments', 'renderer', 'lanes')}))\n"
        "    return 1.0\n")
    cells = []
    for name, tr in renderers.items():
        cell = f"lighttest-{name}"
        cells.append(cell)
        traffic = {"loop": "frames", "why": "a fixture", "clients": 1, "trace_frames": 2,
                   "check": {"frames": 1, "pixels": 4096}, **tr}
        (root / "benchmark" / "traffic" / f"{cell}.json").write_text(json.dumps(traffic))
        shutil.copy(root / "benchmark" / "limits" / "cornell-render.json",
                    root / "benchmark" / "limits" / f"{cell}.json")
        bench["workloads"].append({"name": cell, "config": "lighttest", "traffic": cell,
                                   "chips": 1, "why": "a fixture"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "cornell-render" in m["workloads"]:
            m["workloads"] += cells
    bench["per_layer"].append({"name": "ctx_seen", "unit": "runs", "better": "higher",
                               "source": "program_counter", "layer": "frame / step",
                               "moves": "render_samples_per_s", "workloads": cells})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return str(root)


@pytest.mark.parametrize("seed", [0, 7])
def test_the_hash_is_the_ports_bit_for_bit(seed):
    from rust_pathtracer_tpu_torch.perlin import _hash3

    g = torch.Generator().manual_seed(seed + 1)
    ix, iy, iz = (torch.randint(-(1 << 31), 1 << 31, (100_000,), generator=g)
                  for _ in range(3))
    ix[:10] = torch.arange(-5, 5)  # small negatives and zero among them
    assert bool((ix < 0).any() and (iy < 0).any() and (iz < 0).any())
    assert torch.equal(rp.hash3(ix, iy, iz, seed), _hash3(ix, iy, iz, seed))


@pytest.mark.parametrize("seed", [0, 7])
def test_the_marble_is_the_ports(seed):
    from rust_pathtracer_tpu_torch.perlin import marble

    g = torch.Generator().manual_seed(seed + 11)
    near = (torch.rand((50_000, 3), generator=g) - 0.5) * 16.0
    far = (torch.rand((50_000, 3), generator=g) - 0.5) * 2000.0
    points = torch.cat([near, far])
    scale = torch.full((points.shape[0],), 4.0)
    gap = (rp.marble(points, seed, scale) - marble(points, seed, scale)).abs().max()
    assert float(gap) <= 1e-6


def test_a_scene_without_perlin_never_reads_the_marble(monkeypatch):
    """CornellBox and SphereField shade exactly as before: the marble is
    not computed on their lanes."""
    def no_marble(*a, **kw):
        raise AssertionError("the marble was read")
    monkeypatch.setattr(pt, "marble", no_marble)
    for name, t in (("cornellbox", 0.0), ("spherefield", 0.37)):
        cfg = spec.config(name)
        assert rs.TEX_PERLIN not in rs.scene_tensors(cfg, "cpu")["tex_kind"].tolist()
        pt.render_pixels(rs.scene_tensors(cfg, "cpu"),
                         rs.camera_frame(rs.camera_params(cfg, t), "cpu"), (1, 2),
                         torch.arange(40), width=8, height=5, spp=2, spp_chunk=1,
                         max_bounces=6, background=cfg["background"])


def test_the_perlin_seed_reaches_the_reference():
    cfg = json.load(open(LIGHTTEST))
    assert rs.scene_tensors(cfg, "cpu")["perlin_seed"] == 0
    assert rs.scene_tensors(dict(cfg, perlin_seed=7), "cpu")["perlin_seed"] == 7
    del cfg["perlin_seed"]
    assert rs.scene_tensors(cfg, "cpu")["perlin_seed"] == 0
    assert rs.scene_tensors(cfg, "cpu")["tex_kind"].tolist() == [rs.TEX_PERLIN, rs.TEX_SOLID]


def test_lighttest_reads_correct_on_both_renderers(tmp_path, capsys):
    root = lighttest_root(tmp_path)
    seen = {}
    for name in RENDERERS:
        cell = f"lighttest-{name}"
        for trace in (False, True):
            out = harness.run_cell(cell, SEED, 0.1, trace, device="cpu", toy=True, root=root)
            assert out["correct"] is True and out["failed"] == 0, (cell, out["check"])
            assert set(out["check"]) == {"pixel_mae", "pixel_max"}
        line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("ctx ")]
        seen[name] = json.loads(line[-1][4:])
    assert seen["chunked"]["renderer"] == "chunked" and seen["regen"]["renderer"] == "regen"
    assert seen["chunked"]["lanes"] == 16 * 9 * 4  # a chunk's lanes
    assert seen["regen"]["lanes"] == 256  # the toy's pool
    # the same frame's paths on either renderer: the same segments
    assert seen["chunked"]["segments"] == seen["regen"]["segments"] > 16 * 9 * 8


def test_the_regen_pool_is_the_one_the_port_runs(tmp_path, capsys, monkeypatch):
    """``ctx["lanes"]`` on the regen renderer is the pool the port's
    queue builds, and a pool the port would cut raises."""
    from rust_pathtracer_tpu_torch import wavefront

    pools = []
    real = wavefront._Pool

    def spy(**kw):
        pools.append(int(kw["depth"].shape[0]))
        return real(**kw)

    monkeypatch.setattr(wavefront, "_Pool", spy)
    root = lighttest_root(tmp_path)
    out = harness.run_cell("lighttest-regen", 19, 0.1, True, device="cpu", toy=True, root=root)
    assert out["correct"] is True, out["check"]
    seen = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("ctx ")]
    assert pools and set(pools) == {json.loads(seen[-1][4:])["lanes"]} == {256}

    cell = spec.Cell("lighttest-regen", root)
    img = loops.image(cell, False)
    assert img["spp_chunk"] == img["samples_per_pixel"]  # no chunks: one in the check
    assert loops.regen_lanes(cell, img, False) == 1 << 20
    assert loops.regen_lanes(cell, loops.image(cell, True), True) == 256
    for small in (dict(img, width=4, height=3, samples_per_pixel=2), dict(img, width=0)):
        with pytest.raises(ValueError, match="a pool of 1048576 lanes"):
            loops.regen_lanes(cell, small, False)
    cell.traffic["toy"]["lanes"] = 16 * 9 * 8 + 1
    with pytest.raises(ValueError, match="frame's 1152"):
        loops.regen_lanes(cell, loops.image(cell, True), True)


@pytest.mark.parametrize("renderer", sorted(RENDERERS))
@pytest.mark.parametrize("fault", faults.PERLIN_FAULTS)
def test_a_perlin_fault_reads_incorrect(renderer, fault, tmp_path):
    root = lighttest_root(tmp_path, {renderer: RENDERERS[renderer]})
    (tmp_path / "sitecustomize.py").write_text(
        "import os, sys\n"
        f"sys.path.insert(0, {spec.ROOT!r})\n"
        "from benchmark.tests import faults\n"
        "faults.plant(os.environ['BENCH_FAULT'])\n")
    env = dict(os.environ, BENCH_FAULT=fault,
               PYTHONPATH=os.pathsep.join([str(tmp_path), spec.ROOT]))
    code = ("import json; from benchmark import harness; "
            f"print(json.dumps(harness.run_cell('lighttest-{renderer}', 11, 0.1, False, "
            f"device='cpu', toy=True, root={root!r})))")
    proc = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, env=env,
                          capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["correct"] is False and out["failed"] >= 1


def test_settings_reach_the_ports_render_settings(tmp_path):
    root = lighttest_root(tmp_path)
    path = os.path.join(root, "benchmark", "traffic", "lighttest-chunked.json")
    tr = json.load(open(path))
    tr["settings"] = {"cascade_schedule": "5:8", "diff_t": "rederive"}
    json.dump(tr, open(path, "w"))
    cell = spec.Cell("lighttest-chunked", root)
    img = loops.image(cell, True)
    _, _, settings, _ = loops.port_scene(cell, "cpu", img)
    assert (settings.cascade_schedule, settings.diff_t) == ("5:8", "rederive")
    assert (settings.width, settings.spp_chunk, settings.max_bounces) == (16, 4, 50)
    plain = spec.Cell("cornell-render")
    _, _, default, _ = loops.port_scene(plain, "cpu", loops.image(plain, True))
    assert (default.cascade_schedule, default.diff_t) == (None, "analytic")


BAD_CONFIGS = [
    ("textures", 0, {"kind": "image", "image": 0}, "no 'image' texture"),
    ("textures", 0, {"kind": "perlin"}, "needs its scale"),
    ("textures", 1, {"kind": "checker", "odd": 0, "even": 2, "scale": 1.0}, "child is a checker"),
    ("materials", 0, {"kind": "isotropic", "texture": 0}, "no 'isotropic' material"),
    ("primitives", 0, {"kind": "obj", "path": "model.obj", "material": 0}, "no 'obj' primitive"),
]


@pytest.mark.parametrize("section, index, entry, message", BAD_CONFIGS)
def test_a_kind_the_reference_cannot_render_raises(section, index, entry, message, tmp_path):
    cfg = json.load(open(LIGHTTEST))
    if message == "child is a checker":
        cfg["textures"].append({"kind": "checker", "odd": 0, "even": 1, "scale": 1.0})
    cfg[section][index] = entry
    with pytest.raises(ValueError, match=message):
        rs.scene_tensors(cfg, "cpu")
    root = lighttest_root(tmp_path)
    json.dump(cfg, open(os.path.join(root, "benchmark", "configs", "lighttest.json"), "w"))
    with pytest.raises(ValueError, match=message):
        spec.Cell("lighttest-chunked", root)


BAD_TRAFFIC = [
    ({"renderers": "regen"}, "unknown key"),
    ({"toy": dict(TOY, seconds=1)}, "unknown toy key"),
    ({"settings": {"spp_chunk": 4}}, "unknown setting"),
    ({"settings": {"reorder": False}}, "unknown setting"),
    ({"renderer": "cascade"}, "renderer 'cascade'"),
    ({"renderer": "regen", "mesh": [2, 2]}, "takes no mesh"),
    ({"renderer": "regen", "loop": "steps"}, "forward only"),
    ({"renderer": "regen"}, "needs its pool"),
    ({"mode": "stripe"}, "unknown key"),
    ({"lanes": 4096}, "belong to the regen renderer"),
    ({"toy": dict(TOY, lanes=64)}, "belong to the regen renderer"),
]


@pytest.mark.parametrize("change, message", BAD_TRAFFIC)
def test_a_traffic_the_harness_cannot_run_raises(change, message, tmp_path):
    root = lighttest_root(tmp_path)
    path = os.path.join(root, "benchmark", "traffic", "lighttest-chunked.json")
    tr = dict(json.load(open(path)), **change)
    json.dump(tr, open(path, "w"))
    with pytest.raises(ValueError, match=message):
        spec.Cell("lighttest-chunked", root)
