"""One run of one cell: set-up, the window, the check, the result line.

``run_cell`` is the whole run on a device it is given.  ``run.py`` calls
it on the card after checking that the cell's cards are there; the CPU
tests call it with ``device="cpu"`` and ``toy=True`` (the traffic's toy
sizes), which measures nothing that is reported as the card's.

A cell whose traffic has a ``mesh`` runs one process a rank
(``sharded.py``); this process starts them and returns rank 0's result.
"""

from __future__ import annotations

import gc
import math
import sys
import time
from typing import Optional

import torch

from benchmark import check, loops, profiling
from benchmark.reference import scene as rs
from benchmark.spec import ROOT, Cell

GIB = float(1 << 30)
# top-level module names that may not be loaded once the window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "rust_pathtracer_tpu")


def log(msg: str) -> None:
    """A progress line on standard error (before the check's lines)."""
    print(f"[benchmark] {msg}", file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of FORBIDDEN, compared
    whole (``rust_pathtracer_tpu_torch`` is not ``rust_pathtracer_tpu``)."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def device_info(device, count: int, peak_bytes: int) -> dict:
    dev = torch.device(device)
    if dev.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": count,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": count,
            "memory_peak_bytes": int(peak_bytes)}


def peak_bytes(device) -> int:
    dev = torch.device(device)
    return torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0


def scene_counts(cell) -> dict:
    """Primitive counts by type and in all, from the configuration."""
    lists = rs.scene_lists(cell.config)
    kinds = [p["kind"] for p in lists.prims]
    return {"by_type": [kinds.count("sphere"), kinds.count("rect"), kinds.count("triangle")],
            "total": len(kinds)}


def percentile(values, q: float) -> float:
    """The nearest-rank ``q`` percentile."""
    s = sorted(values)
    return s[max(0, math.ceil(q / 100.0 * len(s)) - 1)]


def metric(cell, name: str, value: float) -> dict:
    return {"value": value, "unit": cell.unit(name)}


def read_per_layer(cell, ctx: dict) -> dict:
    """Each per-layer metric of the cell that its reader finds."""
    out = {}
    for name, read in cell.readers().items():
        value = read(ctx)
        if value is not None:
            out[name] = metric(cell, name, value)
    return out


def judge_and_report(numbers: dict, cell, result: dict) -> dict:
    """Put the compared numbers beside their limits into ``result`` (last
    key) and on standard error (last lines)."""
    ok, lines = check.judge(numbers, cell.limits())
    result["correct"] = bool(ok)
    result["check"] = {n: {"value": v, "limit": lim} for n, v, lim, _ in lines}
    for n, v, lim, good in lines:
        print(f"check {n} {v!r} limit {lim!r} {'ok' if good else 'FAILED'}",
              file=sys.stderr, flush=True)
    return result


def frame_window(loop, trace, seconds, toy, go_on=None):
    """The frames' window: for ``seconds``, or traced for the traffic's
    ``trace_frames``.  Returns (the Window, its Trace or None)."""
    cell, device = loop.cell, loop.device
    if trace:
        n = (cell.traffic["toy"] if toy else cell.traffic)["trace_frames"]
        win = loops.Window(device, count=n, go_on=go_on)
        with profiling.profiled(device) as prof:
            win.run(loop.frame)
        return win, profiling.Trace(prof, win.seconds_to_last)
    win = loops.Window(device, seconds=seconds, go_on=go_on)
    win.run(loop.frame)
    return win, None


def frame_result(loop, win, tr, setup_s, peak, ranks, rank_busy_s=None) -> dict:
    """``attempted`` and ``metrics`` of a frames window: the end-to-end
    metrics, or traced the per-layer metrics its readers find
    (``rank_busy_s``: a grid's device busy seconds a rank outside the
    collectives).  The readers' ``segments`` (the window's ray segments,
    read from the frames' device counts once the window has closed) and
    ``renderer`` are the frames' alone; ``lanes`` is a chunk's lanes on
    a rank, or the regen renderer's pool."""
    cell = loop.cell
    result = {"attempted": len(loop.answers)}
    if tr is not None:
        lanes = (loop.lanes if loop.renderer == "regen"
                 else loop.pixels_per_rank * loop.img["spp_chunk"])
        ctx = dict(cell=cell, img=loop.img, trace=tr, answers=len(loop.answers),
                   bounces=loop.bounces, scene_build_s=loop.scene_build_s,
                   counts=scene_counts(cell), ranks=ranks, rank_busy_s=rank_busy_s,
                   lanes=lanes, renderer=loop.renderer,
                   segments=float(torch.stack(loop.segments).double().sum()))
        result["metrics"] = read_per_layer(cell, ctx)
    else:
        rate = len(loop.answers) * loop.samples_per_frame / win.seconds_to_last
        rate_name = next(m["name"] for m in cell.end_to_end if m["unit"] == "samples/s")
        result["metrics"] = {
            rate_name: metric(cell, rate_name, rate),
            "setup_s": metric(cell, "setup_s", setup_s),
            "peak_mem_gib": metric(cell, "peak_mem_gib", peak / GIB)}
    return result


def check_frames(cell, seed, answers, pixels, device, toy, result, count, peak, tr):
    """The check of a frames window's answers, then ``finish``."""
    c0 = time.perf_counter()
    numbers, n_checked = check.check_frames(cell, seed, answers, pixels, device, toy)
    log(f"check of {n_checked} frame(s) took {time.perf_counter() - c0:.3f} s")
    return finish(cell, result, numbers, n_checked, device, count, peak, tr)


def run_frames(cell, seed, seconds, trace, device, toy, t0) -> dict:
    loop = loops.FrameLoop(cell, seed, device, toy)
    log(f"scene built in {loop.scene_build_s:.3f} s; at {time.perf_counter() - t0:.3f} s")
    loop.warm()
    setup_s = time.perf_counter() - t0
    log(f"warm-up frame done at {setup_s:.3f} s")
    win, tr = frame_window(loop, trace, seconds, toy)
    peak = peak_bytes(device)
    result = frame_result(loop, win, tr, setup_s, peak, 1)
    answers, pixels = loop.answers, loop.pixels
    log(f"window: {len(answers)} frames in {win.seconds_to_last:.3f} s; peak {peak} B")
    del loop
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return check_frames(cell, seed, answers, pixels, device, toy, result, 1, peak, tr)


def run_steps(cell, seed, seconds, trace, device, toy, t0) -> dict:
    loop = loops.StepLoop(cell, seed, device, toy)
    log(f"scene built in {loop.scene_build_s:.3f} s; target at {time.perf_counter() - t0:.3f} s")
    loop.first()
    log(f"first steps done at {time.perf_counter() - t0:.3f} s")
    first = (loop.losses, loop.first_grads, loop.theta_first, loop.theta0)
    start = cell.traffic["first_steps"]
    tr = None
    if trace:
        n = (cell.traffic["toy"] if toy else cell.traffic)["trace_steps"]
        win = loops.Window(device, count=n)
        with profiling.profiled(device) as prof:
            win.run(lambda i: loop.step(start + i))
        tr = profiling.Trace(prof, win.seconds_to_last)
    else:
        setup_s = time.perf_counter() - t0
        win = loops.Window(device, seconds=seconds)
        win.run(lambda i: loop.step(start + i))
    peak = peak_bytes(device)
    img = loop.img
    ctx = dict(cell=cell, img=img, trace=tr, answers=len(win.times), bounces=None,
               scene_build_s=loop.scene_build_s, counts=scene_counts(cell), ranks=1,
               lanes=img["width"] * img["height"] * img["spp_chunk"])
    result = {"attempted": len(win.times)}
    if trace:
        result["metrics"] = read_per_layer(cell, ctx)
    else:
        steps_ms = [(b - a) * 1e3 for a, b in win.times]
        result["metrics"] = {
            "step_ms": metric(cell, "step_ms", win.seconds_to_last * 1e3 / len(win.times)),
            "step_p95_ms": metric(cell, "step_p95_ms", percentile(steps_ms, 95.0)),
            "setup_s": metric(cell, "setup_s", setup_s),
            "peak_mem_gib": metric(cell, "peak_mem_gib", peak / GIB)}
    first = tuple([y.detach().cpu() for y in x] for x in first)
    del loop
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    log(f"window: {len(win.times)} steps in {win.seconds_to_last:.3f} s; peak {peak} B")
    c0 = time.perf_counter()
    ref = check.reference_steps(cell, seed, device, toy)
    numbers = check.step_numbers(first, ref)
    log(f"check of the first steps took {time.perf_counter() - c0:.3f} s")
    return finish(cell, result, numbers, 1, device, 1, peak, tr)


def finish(cell, result, numbers, n_checked, device, count, peak, tr) -> dict:
    """The result line's keys: ``correct`` and ``failed`` from the check,
    ``device`` (with ``busy_s`` and ``window_s`` when traced), and the
    breakdown of a trace."""
    result = judge_and_report(numbers, cell, result)
    result["failed"] = 0 if result["correct"] else n_checked
    result["device"] = device_info(device, count, peak)
    if tr is not None:
        result["device"].update(busy_s=tr.busy_s, window_s=tr.window_s)
        result["breakdown"] = tr.breakdown()
    return result


def ordered(result: dict) -> dict:
    """The result with its keys in the contract's order, ``check`` last."""
    keys = ("correct", "attempted", "failed", "metrics", "device", "breakdown", "check")
    return {k: result[k] for k in keys if k in result}


def run_cell(workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             toy: bool = False, t0: Optional[float] = None, t0_epoch: Optional[float] = None,
             root: str = ROOT) -> dict:
    """One run of ``workload`` (of the benchmark at ``root``): the result
    line as a dict."""
    t0 = time.perf_counter() if t0 is None else t0
    cell = Cell(workload, root)
    if cell.traffic.get("mesh"):
        from benchmark import sharded

        return sharded.launch(cell, seed, seconds, trace, device, toy,
                              time.time() if t0_epoch is None else t0_epoch)
    kind = cell.traffic["loop"]
    if kind == "frames":
        result = run_frames(cell, seed, seconds, trace, device, toy, t0)
    elif kind == "steps":
        result = run_steps(cell, seed, seconds, trace, device, toy, t0)
    else:
        raise ValueError(f"traffic {cell.entry['traffic']!r}: unknown loop {kind!r}")
    return ordered(result)
