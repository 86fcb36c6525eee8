"""The benchmark as data: ``BENCHMARK.json`` and the files it names.

A cell (a ``workloads`` entry) names a configuration and a traffic mix;
each is a file of its own, found by name:

* ``benchmark/configs/<config>.json``: the scene, its published settings
  and the data the reference builds it from;
* ``benchmark/traffic/<traffic>.json``: the loop, its sizes, the
  renderer and render settings, and how many answers the check samples;
* ``benchmark/limits/<workload>.json``: the limit of each number the
  check compares, with the readings it was set from;
* ``benchmark/metrics/<metric>.py``: a per-layer metric's reader, a
  function ``read(ctx)`` that returns the number or None.

Adding a cell, a mix or a metric adds files and entries; no code here
names one.  A traffic key, renderer or render setting that the harness
does not know, and a texture, material or primitive kind that the
reference cannot render, raise when the cell is loaded.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, Optional

from benchmark.reference.scene import scene_lists

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TRAFFIC_KEYS = {"loop", "why", "clients", "width", "height", "samples_per_pixel",
                "max_bounces", "spp_chunk", "trace_frames", "trace_steps", "check", "toy",
                "orbit", "mesh", "unknown", "guess", "learning_rate", "first_steps",
                "renderer", "lanes", "settings"}
TOY_KEYS = {"width", "height", "samples_per_pixel", "spp_chunk", "max_bounces", "pixels",
            "trace_frames", "trace_steps", "lanes"}
RENDERERS = ("chunked", "regen")
# the RenderSettings fields a traffic file may set under "settings"
SETTINGS = ("cascade_schedule", "diff_t")


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str = ROOT) -> dict:
    """``BENCHMARK.json`` at ``root``."""
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def _file(root: str, kind: str, name: str, ext: str = ".json") -> str:
    return os.path.join(root, "benchmark", kind, name + ext)


def config(name: str, root: str = ROOT) -> dict:
    return _load_json(_file(root, "configs", name))


def traffic(name: str, root: str = ROOT) -> dict:
    return _load_json(_file(root, "traffic", name))


def limits(workload: str, root: str = ROOT) -> dict:
    """The workload's limits: number name -> {"limit": ...}."""
    return _load_json(_file(root, "limits", workload))["limits"]


def check_traffic(name: str, tr: dict) -> None:
    """Raise on what the harness cannot run as asked: an unknown key, a
    renderer or render setting it does not know, ``lanes`` off the regen
    renderer, and regen with a ``mesh``, steps or no ``lanes``."""
    def unknown(keys, known, where):
        extra = sorted(set(keys) - set(known))
        if extra:
            raise ValueError(f"traffic {name!r}: unknown {where} {extra}; "
                             f"known: {sorted(known)}")

    unknown(tr, TRAFFIC_KEYS, "key(s)")
    unknown(tr.get("toy", {}), TOY_KEYS, "toy key(s)")
    unknown(tr.get("settings", {}), SETTINGS, "setting(s)")
    renderer = tr.get("renderer", "chunked")
    if renderer not in RENDERERS:
        raise ValueError(f"traffic {name!r}: renderer {renderer!r}, want one of {RENDERERS}")
    if renderer == "regen":
        if tr.get("mesh"):
            raise ValueError(f"traffic {name!r}: the regen renderer runs on one card; "
                             "it takes no mesh")
        if tr["loop"] != "frames":
            raise ValueError(f"traffic {name!r}: the regen renderer is forward only; "
                             "it runs frames")
        if "lanes" not in tr:
            raise ValueError(f"traffic {name!r}: the regen renderer needs its pool, lanes")
    elif "lanes" in tr or "lanes" in tr.get("toy", {}):
        raise ValueError(f"traffic {name!r}: lanes belong to the regen renderer")


def reader(metric: str, root: str = ROOT) -> Callable:
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = _file(root, "metrics", metric, ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


class Cell:
    """One workload: its entry, configuration, traffic and metrics."""

    def __init__(self, name: str, root: str = ROOT):
        bench = benchmark(root)
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; have {sorted(entries)}")
        self.name, self.root = name, root
        self.entry = entries[name]
        self.chips = int(self.entry["chips"])
        self.config = config(self.entry["config"], root)
        self.traffic = traffic(self.entry["traffic"], root)
        check_traffic(self.entry["traffic"], self.traffic)
        scene_lists(self.config)  # raises on a kind the reference cannot render

        def mine(m):
            return "workloads" not in m or name in m["workloads"]

        self.end_to_end = [m for m in bench["end_to_end"] if mine(m)]
        self.per_layer = [m for m in bench["per_layer"] if mine(m)]

    def limits(self) -> Dict[str, dict]:
        return limits(self.name, self.root)

    def readers(self) -> Dict[str, Callable]:
        return {m["name"]: reader(m["name"], self.root) for m in self.per_layer}

    def unit(self, metric: str) -> Optional[str]:
        for m in self.end_to_end + self.per_layer:
            if m["name"] == metric:
                return m["unit"]
        return None
