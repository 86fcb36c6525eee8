#!/usr/bin/env python3
"""The readings the check's limits are set from, on the card.

    python3 benchmark/control.py --workload cornell-render --mode program --seeds 1,2,3
    python3 benchmark/control.py --workload cornell-render --mode control --seeds 1,2,3
    python3 benchmark/control.py --workload cornell-step --mode half --seeds 1,2,3

Prints one JSON line a seed: the numbers ``check.py`` compares, at the
cell's own sizes, for

* ``program``: the program's answers (a frame of the window's first
  index, or the first steps) against the reference: the lower readings;
* ``control``: the reference in bfloat16 with float32 sphere roots in
  the program's place: the upper readings;
* ``half`` (steps): the reference over half of the pixels, the loss the
  mean over the rest, in the program's place;
* ``scaled`` (steps): the reference's loss and gradient times 1.01 in
  the program's place (an answer altered where it is produced).

The benchmark's own runs run none of this.  A sharded cell's control
runs the reference alone, on one card; its program readings come from
the cell's own runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def frames_reading(cell, seed, mode, device):
    import torch

    from benchmark import check, loops

    img = loops.image(cell, False)
    pixels = loops.check_pixels(cell, seed, img, False)
    t = loops.orbit_time(cell, seed, 0)
    from benchmark.reference.threefry import frame_key

    key = frame_key(seed, 0)
    if mode == "program":
        loop = loops.FrameLoop(cell, seed, device)
        loop.frame(0)
        got = loop.answers[0][2]
        del loop
    elif mode == "control":
        got = check.reference_pixels(cell, key, t, pixels, img, device, check.BF16)
    else:
        raise ValueError(f"mode {mode!r} has no frames form")
    want = check.reference_pixels(cell, key, t, pixels, img, device)
    torch.cuda.empty_cache()
    return check.frame_numbers([got], [want])


def _faulty(cell, seed, mode, device):
    """The reference's first steps with the fault planted."""
    from benchmark import check

    if mode == "half":
        return check.reference_steps(cell, seed, device, stride=2)
    losses, grads, after, start = check.reference_steps(cell, seed, device)
    return [x * 1.01 for x in losses], [g * 1.01 for g in grads], after, start


def steps_reading(cell, seed, mode, device):
    from benchmark import check, loops

    ref = check.reference_steps(cell, seed, device)
    if mode == "program":
        loop = loops.StepLoop(cell, seed, device)
        loop.first()
        prog = (loop.losses, loop.first_grads, loop.theta_first, loop.theta0)
    elif mode == "control":
        prog = check.reference_steps(cell, seed, device, precision=check.BF16)
    else:
        prog = _faulty(cell, seed, mode, device)
    return check.step_numbers(prog, ref)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--mode", choices=("program", "control", "half", "scaled"), required=True)
    p.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.spec import Cell

    if not torch.cuda.is_available():
        print("error: control.py needs a CUDA card", file=sys.stderr)
        return 2
    cell = Cell(args.workload)
    reading = frames_reading if cell.traffic["loop"] == "frames" else steps_reading
    for seed in (int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        numbers = reading(cell, seed, args.mode, "cuda")
        print(json.dumps({"workload": args.workload, "mode": args.mode, "seed": seed,
                          "seconds": time.perf_counter() - t0, **numbers}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
