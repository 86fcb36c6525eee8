"""The program's own spans in a traced window, and the interval
arithmetic that the span metrics share.

While a profiler runs, the port opens ``torch.profiler.record_function``
ranges named ``rpt.*`` (``rust_pathtracer_tpu_torch/utils/metrics.py``
``span``): ``rpt.frame``, ``rpt.chunk``, ``rpt.bounce``, ``rpt.sync``,
``rpt.forward`` and ``rpt.backward``.  They come back among the window's
host events (``profiling.Trace.host``: (start, end, name)) on the clock
of its device operations (``Trace.ops``), in microseconds.  An interval
here is a (start, end) pair in those units; a program without the spans
gives none.
"""

from __future__ import annotations

from typing import Iterable, List, Tuple

Interval = Tuple[float, float]


def named(trace, name: str) -> List[Interval]:
    """Every host event called ``name``, by start."""
    return [(s, e) for s, e, n in trace.host if n == name]


def union(intervals: Iterable[Interval]) -> List[Interval]:
    """The union as disjoint intervals, by start."""
    out: List[Interval] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def intersect(a: List[Interval], b: List[Interval]) -> List[Interval]:
    """The intersection of two unions (disjoint, by start)."""
    out: List[Interval] = []
    i = j = 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def length(intervals: Iterable[Interval]) -> float:
    return sum(e - s for s, e in intervals)


def idle_within(trace, intervals: Iterable[Interval]) -> float:
    """The device's idle time inside the union of ``intervals``: its
    length less the part that the device operations' union covers."""
    within = union(intervals)
    busy = union((s, e) for _, s, e in trace.ops)
    return length(within) - length(intersect(within, busy))


def idle_ms_per_answer(ctx, name: str):
    """The device's idle time inside the ``name`` spans, in ms an answer
    traced; None without device operations (a CPU run), answers or
    spans."""
    tr = ctx["trace"]
    if tr is None or not tr.ops or not ctx["answers"]:
        return None
    ranges = named(tr, name)
    if not ranges:
        return None
    return idle_within(tr, ranges) / ctx["answers"] / 1e3
