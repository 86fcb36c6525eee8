#!/usr/bin/env python3
"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload cornell-render --seed 12345 --seconds 30 --trace 0

Drives ``rust_pathtracer_tpu_torch`` on the card (never JAX).  Exits 2,
printing nothing on standard output, without a CUDA card or with fewer
cards than the cell asks for; exits non-zero, with no result, on any
error, and when ``jax``, ``jaxlib``, ``flax`` or ``rust_pathtracer_tpu``
is loaded once the window has closed.  The last line of standard output
is the result: ``correct``, ``attempted``, ``failed``, ``metrics``
(``--trace 0``: the cell's end-to-end metrics; ``--trace 1``: its
per-layer metrics), ``device`` and, traced, ``breakdown``; the numbers
the check compared, beside their limits, come last there and on
standard error.  The kernels build into the package's own ``build``
directories in this checkout on a first run, and load from there after.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()
T0_EPOCH = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    # a rank of a sharded cell, started by the run's own process
    p.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--world", type=int, default=None, help=argparse.SUPPRESS)
    p.add_argument("--store", default=None, help=argparse.SUPPRESS)
    p.add_argument("--t0", type=float, default=None, help=argparse.SUPPRESS)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    p.add_argument("--toy", action="store_true", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark import harness
    from benchmark.spec import Cell

    if args.rank is not None:
        from benchmark import sharded

        return sharded.rank_main(args)
    harness.log(f"torch imported at {time.perf_counter() - T0:.3f} s")
    cell = Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"error: {args.workload} needs {cell.chips} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, {have} found",
              file=sys.stderr)
        return 2
    harness.log(f"{torch.cuda.device_count()} card(s) found at {time.perf_counter() - T0:.3f} s")
    result = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                              device="cuda", t0=T0, t0_epoch=T0_EPOCH)
    found = harness.forbidden_modules()
    if found:
        print(f"error: modules loaded once the window closed: {found}", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
