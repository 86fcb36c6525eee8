"""Render metrics, stage timers, a frame progress bar, the profiler and
the program's spans.

Counterpart of ``rust_pathtracer_tpu/utils/metrics.py``; plain host
code.  The CLI reports ray segments per second, the occupancy curve by
bounce and wall-clock seconds by stage, and ``--profile-dir`` writes a
``torch.profiler`` Chrome trace.  ``span`` names a stretch of the
program's host work in such a trace (``rpt.frame``, ``rpt.chunk``,
``rpt.bounce``, ``rpt.sync``, ``rpt.flush``, ``rpt.forward``,
``rpt.backward``, ``rpt.stage.<name>``), and costs one flag read where
no profiler runs.
The JAX package's roofline model (``CHIP_PEAKS``, ``StageRoofline``,
``bounce_roofline``, ``roofline_report``) is not ported: its peaks and
its cost model are the TPU's; the kernels' bounds on the card live in
``chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import torch

# the context ``span`` returns while no profiler runs: stateless, so one
# instance serves every call and every nesting
_NO_SPAN = contextlib.nullcontext()


def span(name: str, args=None):
    """A ``torch.profiler.record_function`` range named ``name`` (every
    name starts with ``rpt.``), ``args`` shown as its input, while a
    profiler runs; else one shared no-op context, which allocates
    nothing.  A range costs 10-30 us of host time even where no profiler
    runs (torch 2.11-2.13), the flag read under 1 us."""
    if torch._C._autograd._profiler_enabled():
        return torch.profiler.record_function(name, None if args is None else str(args))
    return _NO_SPAN


@dataclass
class RenderMetrics:
    width: int = 0
    height: int = 0
    spp: int = 0
    segments: float = 0.0
    wall_seconds: float = 0.0
    frames: int = 0
    occupancy: Optional[List[float]] = None  # alive lanes per bounce

    def add_occupancy(self, occ) -> None:
        occ = [float(x) for x in occ]
        if self.occupancy is None:
            self.occupancy = occ
        else:
            self.occupancy = [a + b for a, b in zip(self.occupancy, occ)]

    @property
    def rays_per_sec(self) -> float:
        return self.segments / self.wall_seconds if self.wall_seconds else 0.0

    @property
    def avg_path_length(self) -> float:
        lanes = self.width * self.height * self.spp * max(self.frames, 1)
        return self.segments / lanes if lanes else 0.0

    def report(self, file=None) -> None:
        file = file or sys.stderr
        print(
            f"[metrics] {self.width}x{self.height}@{self.spp}spp x{max(self.frames, 1)} "
            f"frames: {self.segments:.3g} ray segments in {self.wall_seconds:.2f}s "
            f"=> {self.rays_per_sec:.3g} rays/s, avg path length "
            f"{self.avg_path_length:.2f}",
            file=file,
        )
        if self.occupancy and self.occupancy[0] > 0:
            total = self.occupancy[0]
            frac = [x / total for x in self.occupancy if x > 0][:16]
            curve = " ".join(f"{x:.2f}" for x in frac)
            print(f"[metrics] wavefront occupancy by bounce: {curve}", file=file)


@dataclass
class StageTimer:
    """Named wall-clock stages (scene build, schedule probe, render, io),
    each also a span ``rpt.stage.<name>`` in a profiler's trace."""

    stages: Dict[str, float] = field(default_factory=dict)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            with span("rpt.stage." + name):
                yield
        finally:
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def report(self, file=None) -> None:
        for name, dt in self.stages.items():
            print(f"[timing] {name}: {dt:.2f}s", file=file or sys.stderr)


@contextlib.contextmanager
def profiler_trace(log_dir: Optional[str], device, rank: Optional[int] = None):
    """Profile the block with ``torch.profiler`` (the CPU's activity, and
    the card's where ``device`` is a CUDA device) and write its Chrome
    trace to ``log_dir/trace.json``, or ``trace.rank{rank}.json`` for a
    rank of a mesh; nothing without ``log_dir``."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    name = "trace.json" if rank is None else f"trace.rank{rank}.json"
    prof.export_chrome_trace(os.path.join(log_dir, name))


class ProgressBar:
    """Frame-level progress (indicatif counterpart, main.rs:42-49)."""

    def __init__(self, total: int, prefix: str = "rendering", file=None):
        self.total = total
        self.done = 0
        self.prefix = prefix
        self.file = file or sys.stderr
        self.t0 = time.perf_counter()

    def tick(self, n: int = 1) -> None:
        self.done += n
        elapsed = time.perf_counter() - self.t0
        rate = self.done / elapsed if elapsed > 0 else 0.0
        eta = (self.total - self.done) / rate if rate > 0 else float("inf")
        pct = 100.0 * self.done / self.total if self.total else 100.0
        print(
            f"\r{self.prefix}: {self.done}/{self.total} ({pct:.0f}%) "
            f"elapsed {elapsed:.0f}s eta {eta:.0f}s",
            end="",
            file=self.file,
            flush=True,
        )

    def finish(self) -> None:
        print(file=self.file)
