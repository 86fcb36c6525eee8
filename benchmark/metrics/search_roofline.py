"""search_roofline: the big-scene search (``sweep_kernel``: K5, K6 or K7)
summed least time over its summed device time in the traced frames, in
percent.  A launch's least time is ``yardstick.search_bound`` at the
chunk's lanes (every lane is swept, the dead ones parked): the bytes and
the work every lane does whatever it hits, so the share is a lower bound
of the search's."""

from benchmark.yardstick import clusters_of, proj_table_bytes, search_bound


def read(ctx):
    tr = ctx["trace"]
    if tr is None:
        return None
    seconds, n = tr.device_seconds(lambda name: "sweep_kernel" in name)
    if n == 0 or seconds <= 0.0:
        return None
    counts = ctx["counts"]["by_type"]
    least_ms = search_bound(ctx["lanes"], clusters_of(counts), proj_table_bytes(counts))[0]
    return 100.0 * n * least_ms / 1e3 / seconds
