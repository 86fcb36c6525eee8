"""What the traced run reads from ``torch.profiler``.

The window runs under the profiler with CPU and CUDA activities.  From
its events: every device operation (kernels, copies, sets) with its
interval, the device busy time (``yardstick.busy_ms``: the union of the
intervals), and the idle gaps between device operations inside the
window, each named by the host operation that was running at the gap's
middle (the innermost CPU event around it).
"""

from __future__ import annotations

import bisect
import collections
import contextlib
from typing import Dict, List, Tuple

import torch

from benchmark.yardstick import busy_ms

TOP = 10
COLLECTIVES = ("ncclDevKernel", "ncclKernel")  # NCCL's kernels, which spin while they wait
LABELLED_GAPS = 200  # the longest gaps are named by their host operation
HOST_LOOKBACK = 5000  # host events scanned back from a gap's middle


@contextlib.contextmanager
def profiled(device):
    """A profiler over the block: CPU and CUDA activities on a card, CPU
    alone elsewhere.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield prof


def _is_device(e) -> bool:
    """A device operation: a kernel, copy or set on the card, and not a
    user annotation's range there (``nccl:all_reduce``, an optimizer's
    step), which spans operations and the gaps between them."""
    return e.device_type.name == "CUDA" and not getattr(e, "is_user_annotation", False)


class Trace:
    """The device operations of one traced window."""

    def __init__(self, prof, window_s: float):
        events = prof.events()
        self.window_s = window_s
        self.ops: List[Tuple[str, float, float]] = [
            (e.name, e.time_range.start, e.time_range.end) for e in events
            if _is_device(e) and e.time_range.end > e.time_range.start]
        self.busy_s = busy_ms((s, e) for _, s, e in self.ops) / 1e3
        self.host = sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                           if e.device_type.name != "CUDA"
                           and e.time_range.end > e.time_range.start)
        self.host_starts = [h[0] for h in self.host]

    def device_seconds(self, match) -> Tuple[float, int]:
        """(seconds, launches) of the device operations whose name
        ``match(name)`` accepts."""
        sel = [(s, e) for n, s, e in self.ops if match(n)]
        return sum(e - s for s, e in sel) / 1e6, len(sel)

    def busy_s_of(self, match) -> float:
        """Busy seconds (the union of intervals) of the device operations
        whose name ``match(name)`` accepts."""
        return busy_ms((s, e) for n, s, e in self.ops if match(n)) / 1e3

    def by_name(self) -> List[list]:
        tot: Dict[str, float] = collections.defaultdict(float)
        for n, s, e in self.ops:
            tot[n] += (e - s) / 1e6
        return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]

    def _host_at(self, t: float) -> str:
        """The innermost host event around time ``t``."""
        hi = bisect.bisect_right(self.host_starts, t)
        inner = None
        for hs, he, name in self.host[max(0, hi - HOST_LOOKBACK):hi][::-1]:
            if he >= t and (inner is None or he - hs < inner[1] - inner[0]):
                inner = (hs, he, name)
        return inner[2] if inner else "(no host op)"

    def idle_gaps(self) -> List[list]:
        """The longest idle gaps between device operations, summed by the
        host operation running at each gap's middle, largest first."""
        spans = sorted((s, e) for _, s, e in self.ops)
        gaps = []
        cur_e = None
        for s, e in spans:
            if cur_e is not None and s > cur_e:
                gaps.append((cur_e, s))
            cur_e = e if cur_e is None else max(cur_e, e)
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:LABELLED_GAPS]
        tot: Dict[str, float] = collections.defaultdict(float)
        for g0, g1 in gaps:
            tot[self._host_at(0.5 * (g0 + g1))] += (g1 - g0) / 1e6
        return [[n, v] for n, v in sorted(tot.items(), key=lambda kv: -kv[1])[:TOP]]

    def breakdown(self) -> dict:
        return {"device_ops": self.by_name(), "idle_gaps": self.idle_gaps()}
