#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Drives ``rust_pathtracer_tpu_torch`` (never JAX) through its paths:
the fused forward render and differentiable step of ``bench.py``'s
shape (K1, K2), the generic bounce path (K3, K4) forward and
differentiable, the big-scene path (K5, K6, K7), whose main path is
the SphereField forward render at the scene's own width (phase 15), and
the regeneration wavefront (K1 at per-lane depth; the draw kernel on
the generic routes), whose main path is LightTest at its own width and
depth (phase 21), the cascade renderer with checkpoints, whose main
path is SphereField at its own width (phase 25), and the command line: the
CLI's animation loop, whose main path is SphereField's own orbit at its
width (phase 35), scene JSON and the inverse-rendering example, and the
packed RNG scheme and the geometry gradient, whose main path is the
CornellBox step with ``diff_t="rederive"`` (phase 40), and the
between-bounce reorder of big scenes with its pass-set key kernel, whose
main path is the reorder A/B of phase 43, with remat "bf16" and the
differentiable cascade (phase 45).  It checks them:

1. device: a CUDA GPU must be present (no CPU fallback); prints the
   card's name and power limit and the torch and nvcc versions;
2. build: builds K1 (``ops/csrc/fused_bounce.cu``), K2
   (``ops/csrc/fused_bounce_bwd.cu``), K3/K4 (``ops/csrc/closest_hit.cu``),
   K5/K6/K7 (``ops/csrc/projected.cu``), the draw kernel
   (``ops/csrc/draws.cu``), the pass-set key kernel
   (``ops/csrc/passset.cu``) and the lanes kernel (``ops/csrc/lanes.cu``)
   with nvcc for sm_90a, and the native BVH builder (``native.py``) with
   g++, in parallel;
3. K1 against its plain PyTorch version on the CPU on 1,000,000 random
   lanes with random keys, at bounce 0, of a scene that covers every
   branch: alive mask, hit mask and winning
   primitive equal on every lane, floats within 1e-5 relative + 1e-6
   absolute, apart from at most 10 checker lanes whose sin-product lies
   within 1e-6 of 0 (sin differs by ulps between the CPU and the card);
4. the four golden configurations rendered on the card against
   ``tests/goldens/*.npy`` (the JAX package's renders) under the image
   contract of ``utils/image.py``;
5. the serving render at full size: CornellBox 400x400, 20 bounces,
   960,000 lanes a chunk, 60 spp; finite, >= 0, deterministic, every
   bounce launched the keyed K1, every chunk the lanes kernel, and
   neither the lanes nor the bounce loops called the tensor-op threefry
   (``sampling.threefry2x32``); then the
   bench-shaped forward (512^2, 4 spp, 20 bounces) and the keyed K1's
   time (CUDA events around the wrapper, and the kernel's own device time
   from ``torch.profiler``) beside the plain version's at 960,000 lanes;
6. K1 with residuals against its plain version on the same 1,000,000
   lanes: flags exact apart from the checker flips of phase 3, residual
   floats within 1e-5 relative + 1e-6 absolute, and the 13 columns bit
   for bit those of K1 without residuals;
7. K2 against its plain version on those lanes, with numpy cotangents:
   the 9 cotangent columns and the (9P + 3) texture and background
   reductions within a stated tolerance, and the reductions bitwise equal
   between two runs;
8. the differentiable step on the card against the same step on the CPU
   (CornellBox 64x64, 4 spp, 8 bounces, roulette from bounce 4): loss and
   every gradient leaf;
9. the bench-shaped step at full width (CornellBox 512x512, 4 spp, 20
   bounces, one chunk of 1,048,576 lanes, loss = mean(img), backward):
   median time over batches as bench.py takes it, segments/s, finite
   gradients, the keyed K1 with residuals and K2 launched 20 times a
   step, the lanes kernel once, no tensor-op threefry in the lanes or the
   bounce loop; the step's split by
   CUDA events; K1-with-residuals and K2 per launch (events, and profiler
   device time: K2's two kernels summed) beside K1 and the plain versions
   at 1,048,576 lanes;
10. K4 and K3 against their plain versions on phase 3's 1,000,000 lanes,
    on the same CUDA tensors: hit, idx, the winner's kind, mat, front, t,
    point and normal bit for bit, u and v within 1e-5 rel + 1e-6 abs
    apart from at most 10 sphere-uv seam lanes; each timed beside its
    plain version (events around the wrapper, and the kernel's device
    time from ``torch.profiler``);
11. the non-differentiable generic render of an image-textured scene
    (``tests/test_grad.py::_scene_simple``) at 854x480, 2 spp, 20
    bounces, one chunk: finite, >= 0, deterministic, K3 launched once a
    bounce; 64x36 on the card against the CPU under the image contract;
    K3 against its plain version and timed (events, device time) at the
    first bounce;
12. the main path: the differentiable TwoSphereCheckers step at
    854x480, 2 spp, 20 bounces, one chunk of 819,840 lanes, loss =
    mean(img), backward: K4 launched 20 times, finite gradients, camera
    and background gradients non-zero, two steps on one key bit for bit
    equal, peak memory and the bytes remat "none" keeps a lane-bounce,
    the median step over batches as bench.py takes it (shorter batches)
    and its split by CUDA events; K4 against its plain version and timed
    (events, device time) at the first bounce; a 16x9 step on the card
    against the CPU;
13. the differentiable LightTest step at 854x480, 2 spp, 50 bounces,
    remat "auto" (which must checkpoint): K4 launched 50 times over
    forward and backward, finite gradients, time and peak memory of a
    first and a second step;
14. K5, K6 and K7 against their plain versions on the same CUDA
    tensors, on 1,000,000 lanes of each of three tables: ModelTest's
    10,240 columns, SphereField's 640 and the streamed 20,480 of the
    20,000-triangle mesh (first-bounce lanes, then random lanes in the
    scene box, every tenth parked at 3e33): t, column and payload bit for
    bit; each timed beside its plain version, with its bound, the
    clusters a lane's slab test passes and the clusters it sweeps, and
    the passing lanes of a warp visit (the plain sweep's "warp_visits");
15. the main path: SphereField forward at 854x480, 20 bounces, 2 spp
    (one chunk of 819,840 lanes), K6 once a bounce: segments/s, wall,
    finite, >= 0, deterministic; the 64x36 golden configuration on the
    card against the golden and against the CPU; K6 and K5 timed at its
    first bounce, and the whole search there by route (K6 against K5,
    equal results); K6 and K5 held bit for bit and timed on the lanes
    the frame searches at its second bounce (``path_lanes``);
16. ModelTest forward at 800x800, 20 bounces, 1 spp (K6 once a bounce);
    the 20,000-triangle mesh through the pair route: K7 launches and K5
    fallback launches (at least one K7 launch); K7 timed at its first
    bounce, and each mesh's search there by route against K5 alone; K6
    on the lanes the 10k frame hands it at its second bounce; the
    kernel the path runs at the 20k frame's second bounce (K5, K7's
    fallback, where a block passes more than WL_KCAP clusters) and K7 at
    the first later bounce the path hands it, each held bit for bit and
    timed on those lanes;
17. the differentiable SphereField step at 854x480, 2 spp, 20 bounces,
    loss = mean(img), K5 the search once a bounce: finite gradients of
    the texture colours and the background, two steps on one key bit
    for bit equal, peak memory, the median step over batches as bench.py
    takes it and its split by CUDA events;
18. K1 and K1-res (in-kernel threefry draws and roulette) against
    their plain version (``sampling.bounce_draws``, the plain bounce on
    those uniforms, ``roulette``) on the same CUDA tensors: the 13
    columns, the winners, every residual plane and the flags bit for
    bit, on 1,000,000 random
    lanes with random keys at bounces 0 and 7, roulette and residuals
    on and off, and at the serving and bench paths' first bounce (run
    after phase 7);
19. K1 at per-lane depth (the regen wavefront's) against its plain
    version on phase 3's 1,000,000 lanes, random depths 0-49, roulette
    from depth 3: the 13 columns and the winners bit for bit; timed
    (events, device time) beside the plain version, with its bound;
20. the draw kernel (``ops/draws.py``) against ``sampling.bounce_draws``
    on 1,000,000 random keys at bounce 7 and at per-lane depths 0-49, bit
    for bit; timed beside the plain version, with its bound (threefry's
    int32 operations);
21. the regen main path: LightTest regen at 854x480, 50 bounces, 16 spp
    (cut from 2000: 6,558,720 paths through the pool of 2**20 lanes), K1
    at per-lane depth once a bounce iteration, and on the card the
    window-end kernels three times a window end (the frame runs one
    window past the deciding one, so K1 launches FLUSH_EVERY more times
    than the bounces it reports): finite, >= 0, the
    occupancy every path at bounce 0, two renders bit for bit; K1
    against its plain version, bit for bit, on the pools (state, keys,
    depths) the second render hands it at its sixth, middle and last
    bounce iteration; wall, segments/s, windows, the split into bounce, spawn
    and window end by CUDA events and the device's idle share
    (profiler); the chunked render of the same key timed, held under the
    image contract and under JAX's regen-vs-chunked bounds (mean abs
    < 1e-5, max abs < 5e-3), with the same segments and occupancy (the
    two renderers trace the same paths with the same draws);
22. SphereField regen at 854x480, 20 bounces, 8 spp: K6 and the draw
    kernel once a bounce iteration, the same checks and numbers against
    the chunked render, the draw kernel held bit for bit to its plain
    version on the second render's pools as K1 is in phase 21;
23. 64x36 regen of LightTest (K1) and the image-textured scene (K3, the
    draw kernel), roulette from 3, on the card against the CPU under the
    image contract;
24. the chunked SphereField frame of phase 15 with the draw kernel
    against the same frame with the draws hoisted in tensor ops
    (``integrator._precompute_draws``; without the reorder, since the
    hoisted draws are in the lanes' first order), bit for bit, timed in
    turns;
25. the cascade main path: SphereField at 854x480, 20 bounces, 8 spp
    (as phase 22), one key three ways: ``cascade_schedule="auto"``, the
    dynamic cascade and the explicit schedule CASCADE_SF_SCHEDULE, each
    bit for bit the chunked render (image, segments, bounces, occupancy,
    ``occupancy[-1] == 0``), K6 and the draw kernel once a bounce (and
    the auto probe's); wall, segments/s and idle share beside the
    chunked and the regen render; K6 and the draw kernel held bit for
    bit to their plain versions on the compacted pools the explicit and
    the dynamic cascade hand them right after their middle and last
    boundary (``capture_bounces``, ``hold_pools``);
26. ModelTest at 800x800, 1 spp, 20 bounces on the 10k and the 20k mesh
    through CASCADE_MT_SCHEDULE, the same way (the 20k: K7, and K5 as
    its fallback, held on the pools);
27. serving CornellBox (phase 5's shape) with ``cascade_schedule="auto"``
    on the fused route: bit for bit chunked, K1 held on the pools;
28. the image-textured scene of phase 11 through the dynamic cascade:
    bit for bit chunked, K3 and the draw kernel held on its pool;
29. an explicit too-tight schedule (CASCADE_TIGHT) raises
    ``CascadeOverflowError`` on the card;
30. a checkpointed SphereField render (phase 25's shape, 4 chunks),
    stopped after 2 chunks and resumed (``utils/checkpoint.py``), plain
    and through CASCADE_SF_SCHEDULE: bit for bit the uninterrupted
    render and phase 25's chunked image;
31-34. sharded rendering (``parallel/``): four ranks started with
    torch.multiprocessing (spawn) share the card over gloo, a 2x2 grid and
    a 1x1 and a 1x2 grid over its first ranks; each rank only loads the
    kernels phase 2 built.  31: serving CornellBox (phase 5's shape, K1);
    32: the bench-shaped step (phase 9's shape, loss = mean(img), K1-res
    and K2) with its gradients; 33: the SphereField frame of phase 25
    through CASCADE_SF_SCHEDULE (K6, the draw kernel); 34: that frame
    checkpointed on 2x2, stopped as every rank starts its second half of
    chunks, resumed on 1x2.  Each against the single-process run of the
    same key: the 1x1 grid bit for bit, the 2x2 grid within JAX's atol
    2e-6 plus spp ulps of the pixel (the samples axis sums in another
    grouping; the step: the loss within 1e-6, each gradient within 1e-4
    of its leaf's largest), the resumed 1x2 render bit for bit the
    uninterrupted 2x2 one; every rank's result the same; each rank
    launched the path's kernels; K1 and K6 (with the draw kernel) held bit
    for bit to their plain versions on rank 0's own pool at bounce
    SHARD_HOLD_BOUNCE; rank 0's wall (barrier and device sync) beside the
    single process's.  A rank that fails, or the ranks not done within
    SHARD_TIMEOUT_S, fails the script.

35. the command line's main path: ``cli.main`` in this process renders
    SphereField's own orbit at 854x480, frames 297-299 of its 300, 2 of
    its 250 spp, with ``--gif`` and ``--timing-log``: each PNG byte for
    byte ``to_rgb8`` of ``render_radiance`` at ``camera_at(f / 300)``
    rendered here, the timing log's segments those renders', the GIF
    walked block by block (GIF89a, 854x480, three images, loop 0), K6 and
    the draw kernel launched and held bit for bit to their plain versions
    on frame 298's pools; again with ``--cascade auto`` (one schedule,
    printed once, every frame the chunked frame's bytes), and with
    ``--checkpoint`` at a chunk a sample, stopped in frame 298 and
    resumed (the ``.frame0297``-``.frame0299`` files, the same PNGs);
    the render, I/O and GIF seconds;
36. scene JSON: CORNELL_DOC (``tests/test_json_cli.py``'s) at the
    serving shape bit for bit the built-in CornellBox (K1, held on a
    pool); a document with checker, perlin and PNG image textures
    (``read_png`` gives back ``write_png``'s texels) at 854x480, 2 spp,
    20 bounces, without an OBJ (K3 and the draw kernel) and with
    ``write_benchmark_obj``'s 10,080 triangles (the projected route),
    each kernel held on a pool;
37. the inverse-rendering example (``examples/inverse_rendering.py``):
    150 Adam steps at 64x64, 16 spp, 5 bounces recover the albedo (0.8,
    0.2, 0.5) at 3 decimals; the first loss within 1e-5 relative of the
    CPU's; K1-res held bit for bit and K2 within phase 7's tolerance on
    the example's pools;
38. the packed RNG scheme (``rng_scheme="packed"``, the JAX package's
    ``RPT_RNG_SCHEME=packed``) on 1,000,000 random lanes of phase 3's
    scene: K1 (bounces 0 and 7, roulette and residuals on and off) and K1
    at per-lane depths 0-49 (roulette from 3) against
    ``fused_bounce_keyed_plain(..., rng_scheme="packed")``, the draw
    kernel at bounce 7 and at per-lane depths against
    ``bounce_draws_plain(..., "packed")``, bit for bit, and none of them
    the legacy stream; each timed beside the legacy kernel on the same
    inputs in one call (legacy, packed, packed, legacy), with its device
    time, its packed plain version and its bound;
39. the packed paths at full size: serving CornellBox (phase 5's shape)
    packed against legacy, in turns: finite, K1 once a bounce, no
    tensor-op threefry, the channel means within 1% of legacy's, K1 held
    bit for bit on the render's pools; the bench-shaped step (phase 9's
    shape) under both schemes: K1-res and K2 20 times, finite gradients,
    the loss within 1% of legacy's, the two steps' medians in turns;
    LightTest regen (phase 21's shape) against chunked, both packed,
    within the bounds of phase 21 and no further apart than its legacy
    pair; the SphereField cascade (phase 25's shape, CASCADE_SF_SCHEDULE)
    bit for bit the chunked render, packed, K6 and the draw kernel held
    on its pools;
40. the slice's main path, the geometry gradient (``diff_t="rederive"``):
    the CornellBox step at phase 9's shape, loss = mean(img), with
    ``scene.prims.data`` a leaf beside the DiffParams leaves: K4 and the
    draw kernel once a bounce and no K1; the re-derived t equal to K4's
    on every hit lane of the step's 20 searches; K4 bit for bit its plain
    version on the step's pools of bounces 0, 10 and 19; two steps bit for
    bit; every gradient finite; the prims.data gradient zero, as the
    estimator makes it on a scene of solid colours (JAX's too,
    ``tests/test_torch_geometry_grad.py``); the loss and the DiffParams
    gradients against the analytic (fused) step under the port's JAX
    tolerances; the step's median beside the analytic step's, peak memory
    and the row gather's backward (``index_put_`` with accumulate) timed
    alone and in the step; then the TwoSphereCheckers step at phase 12's
    shape, whose perlin sphere makes the gradient of both spheres'
    centres and radii nonzero, twice bit for bit;
41. the geometry gradient on SphereField (phase 17's shape) with K5 as
    the search: K5 and the draw kernel once a bounce, a finite prims.data
    gradient, the re-derived t within 1e-6 of K5's and never a miss,
    time and peak memory;
42. the pass-set key kernel (``ops/passset.py``, ``ops/csrc/passset.cu``)
    against its plain version (``projected.passset_sort_keys_plain``) on
    1,000,000 lanes of phase 14's three tables (SphereField's 5
    clusters, the 10k mesh's 80, the 20k mesh's 158 real of 160), every
    fifth lane dead: every word bit for bit, ``passset_perm`` of the
    kernel's keys that of the plain ones and live lanes first; timed
    beside the plain version (events, device time), with its bound and
    the time of ``passset_perm`` (keys and sorts); then the 20k table's
    lanes with an infinite or NaN o or d in about one of 100, on that
    table and on a copy with an inverted box and +inf and NaN bounds
    (the kernel's exact path), bit for bit and timed;
43. the slice's main path, the between-bounce reorder, A/B in one call
    (off, on, on, off; median walls of 3): the SphereField frame
    (854x480, 2 spp, 20 bounces, K6), ModelTest 800x800 at 1 spp on the
    10k (K6) and 20k meshes (K7, K5 fallbacks), and the SphereField frame
    of phase 25 (8 spp, four chunks): each frame with the
    reorder bit for bit the frame without it (image, segments,
    occupancy), the key kernel launched on each reordered bounce and not
    without; the search's device time a bounce and the key kernel's by
    the profiler, K7's fallbacks to K5, the reorder alone (keys, stable
    sorts, gathers) on the lanes of the first reordered bounce, and the
    pass-set sizes there;
44. SphereField regen (phase 22's shape) with and without the reorder:
    equal segments and occupancy, the image within 2e-7; the 20k mesh
    through ``cascade_schedule="auto"`` (its derived schedule starts with
    the "1:1" pass-set regrouping) bit for bit its chunked frame of phase
    43, its median wall beside the chunked one's;
45. the TwoSphereCheckers step of phase 12 under remat "bf16" and through
    a differentiable cascade whose schedule comes from the plain step's
    occupancy (``render._derive_cascade_schedule``), against remat
    "none": bf16's loss bit for bit, its gradient's normalised error in
    (1e-7, 1e-2); the cascade's overflow 0, its loss within 1e-6 and
    every gradient within rtol 1e-3 / atol 1e-7; K4 and the draw kernel
    once a bounce; peak memory and step seconds in turns;
46. the lanes kernel (``ops/lanes.py``, ``ops/csrc/lanes.cu``: every
    lane's threefry key, pixel jitter and lens-disk point, which
    ``render.camera_lanes`` draws for every chunk and regen spawn)
    against its plain twin (``camera_lane_draws_plain``, the tensor-op
    threefry) on the same CUDA tensors, bit for bit in the key words,
    s_vp, t_vp and the disk: on 1,000,000 random (pixel, sample) lanes,
    the bench step's 1,048,576, a serving chunk's 960,000 and the
    LightTest regen's first fill (``capture_lane_draws``; its refills are
    the window end's respawn, held in phase 48); each timed beside the
    plain twin (events, device time), with its bound; the kernel's launches on each path (phases 5,
    9, 21, 22 and this phase's regen);
47. the shade kernel (``ops/shade.py``, ``ops/csrc/shade.cu``: the
    big-scene forward bounce after the search, in one launch) against its
    plain twin (``integrator.shade_bounce_plain``, the tensor ops) on the
    same CUDA tensors, bit for bit in (o, d, thr, rad, alive): the
    arguments a SphereField frame of 854x480 at 16 spp (one chunk of
    6,558,720 lanes, the benchmark's) hands it at its first and second
    bounce (``shade_args``); each timed beside the plain twin (events,
    device time), with its byte bound;
48. the regen window end (``ops/window_end.py``: ``csrc/window_end.cu``'s
    finish, add and respawn kernels around CUB's sort, ``csrc/pool_sort.cu``)
    against its plain twin (``wavefront._flush_refill``, the tensor ops,
    its radiance added in lane order on the CPU with one thread) on
    copies of the pools that the benchmark's ``lighttest-regen`` frame
    (854x480, 2000 spp, 50 bounces, 8,388,608 lanes) hands it at its
    sixth window and at the window where the queue runs out: the image
    sums, the length histogram, the state rows, key words, depth, work,
    pixel and the device block bit for bit; timed (events, device time
    by kernel) beside the twin as the card runs it, with its byte bound,
    and CUB's sort beside ``torch.sort(stable=True)`` on the same keys.

Phases 11-13 and 15-17 also check that the generic routes launch the
draw kernel once a bounce; phases 5, 9, 21 and 22 that the lanes
kernel made their lanes, and 21, 22 and 39 that the regen's window ends
ran on the card; phases 15, 16, 22, 25 and 26 that the
big-scene forward bounces launch the shade kernel once a bounce (25 and
26 also hold it bit for bit on the cascade's pools), phase 17 that the
differentiable step never does.  The big-scene frames of phases 14-44 take the
default routing, which reorders SphereField's and ModelTest's lanes
between bounces.

Each path runs with every launch count set to 0 just before it and
read just after.  Any failed check exits non-zero.  On success the last
two lines are a JSON object of the kernels' numbers (time, launches,
bound, plain and library times) and the JSON verdict
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import faulthandler
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "output", "chip_smoke")  # git-ignored

K1_LANES = 1_000_000
K1_RTOL, K1_ATOL = 1e-5, 1e-6
CHECKER_SINES_EPS = 1e-6
MAX_EXPLAINED_FLIPS = 10
# K2 vs plain: the same IEEE expressions on the same inputs, so the
# cotangent columns agree to rounding (1e-5 rel + 1e-5 of the largest);
# the reductions sum 1M lanes in another order (1e-5 of the largest)
K2_RTOL, K2_ATOL_REL = 1e-5, 1e-5
# card vs CPU step (tests/test_torch_grad.py's tolerance vs JAX): an ulp
# of sin/cos can reroute a lane, so loss 2e-3 rel, gradients rtol 0.05
# and 2e-3 of the largest gradient
STEP_LOSS_RTOL, STEP_GRAD_RTOL, STEP_GRAD_ATOL_REL = 2e-3, 0.05, 2e-3

# tests/golden_utils.py GOLDEN_CONFIGS: name -> (width, height, spp, bounces)
GOLDEN_CONFIGS = {
    "TwoSphereCheckers": (64, 36, 16, 8),
    "LightTest": (64, 36, 16, 12),
    "CornellBox": (64, 64, 16, 12),
    "TriangleTest": (64, 64, 16, 12),
}
GOLDEN_SEED = 1234

SERVE = dict(width=400, height=400, spp=60, spp_chunk=6, bounces=20, seed=0)
BENCH = dict(width=512, height=512, spp=4, bounces=20, runs=5)
SMALL_STEP = dict(width=64, height=64, spp=4, bounces=8, rr_start=4)
# bench.py's protocol: batches of REPS steps, the median batch, more
# batches while the spread (max - min) / median exceeds SPREAD_TOL
STEP = dict(reps=5, batches=5, max_batches=12, spread_tol=0.10)
# calls a timed block of a plain version (each 1-200 ms on the card)
PLAIN_REPS = 3
CORNELL_CAM = ((278.0, 278.0, -800.0), (278.0, 278.0, 0.0), (0.0, 1.0, 0.0),
               40.0, 1.0, 0.0, 10.0)
KERNELS = ("fused_bounce", "fused_bounce_bwd", "closest_hit", "projected", "draws",
           "passset", "lanes", "shade", "window_end", "pool_sort")
LEAF_NAMES = ("tex_color", "tex_images", "background", "lookfrom", "lookat", "up",
              "vfov_deg", "aspect", "aperture", "focus_dist")

# K3 / K4 vs plain on the same CUDA tensors: the same IEEE expressions,
# so t, point and normal bit for bit; a sphere's u and v (acosf, atan2f)
# within 1e-5 rel + 1e-6 abs, and a sphere-uv seam lane (atan2 at +-pi:
# u = 0 on one side, 1 on the other) may flip, at most this many
CH_RTOL, CH_ATOL = 1e-5, 1e-6
MAX_SEAM_LANES = 10
# phase 11: tests/test_grad.py::_scene_simple at full width
GENERIC = dict(width=854, height=480, spp=2, bounces=20, seed=0)
SIMPLE_CAM = ((0.0, 1.0, 2.0), (0.0, 0.5, -3.0), (0.0, 1.0, 0.0), 50.0, 854.0 / 480.0,
              0.0, 10.0)
SIMPLE_BG = (0.1, 0.1, 0.1)
# phase 12 (main path): TwoSphereCheckers at the scene's own width; the
# timed batches are shorter than bench.py's (each step takes seconds)
MAIN = dict(width=854, height=480, spp=2, bounces=20, seed=0)
MAIN_STEP = dict(reps=2, batches=3, max_batches=6, spread_tol=0.10)
TSC_CAM = ((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 20.0, 854.0 / 480.0,
           0.0, 10.0)
TSC_BG = (1.0, 1.0, 1.0)
# phase 13: LightTest at the scene's own width and depth
LIGHT = dict(width=854, height=480, spp=2, bounces=50, seed=0)
LIGHT_CAM = ((26.0, 3.0, 6.0), (0.0, 2.0, 0.0), (0.0, 1.0, 0.0), 20.0, 854.0 / 480.0,
             0.0, 10.0)
# phases 14-17: the big-scene path.  SphereField at its own width, cut
# from 250 spp to 2 (one chunk); ModelTest at its own 800x800, cut to
# 1 spp; the 20,000-triangle mesh of write_benchmark_obj(rows=101, cols=100)
BIG_LANES = 1_000_000
SF = dict(width=854, height=480, spp=2, bounces=20, seed=0)
SF_CAM = ((12.0, 1.0, 0.0), (0.0, 0.5, 0.0), (0.0, 1.0, 0.0), 20.0, 854.0 / 480.0,
          0.1, 10.0)
SF_BG = (1.0, 1.0, 1.0)
MT = dict(width=800, height=800, spp=1, bounces=20, seed=0)
MESH_20K = dict(rows=101, cols=100)
# random lanes of phase 14: the box around each scene's primitives
SCENE_BOX = {"SphereField": ((-11.0, 0.05, -11.0), (11.0, 3.0, 11.0)),
             "ModelTest": ((-3.0, 0.05, -3.0), (3.0, 3.5, 3.0))}
PARKED = 3.0e33
# operations the projected sweep's function needs (compares and selects
# none; see cluster_ops for the projections): a real column's formula past
# its projections by type (a rect's plane solve and a triangle's Woop solve
# and det in f32; a sphere's quadratic in f64, no projections: o - c 3,
# half_b 5, |o - c|^2 - r^2 7, the discriminant 3, its root 1, the two
# roots 2, and in the t domain 2 divisions more in f32), a slab test, a
# lane's set-up (|d|^2, t_min |d|^2, 1 / d in f32; |d|^2 in f64, a
# sphere's a)
FORMULA_OPS = {0: 0, 1: 5, 2: 7}
SPHERE_F64_OPS, SPHERE_T_OPS = 21, 2
SLAB_OPS, PROJ_LANE_OPS, PROJ_LANE_F64_OPS = 12, 9, 5
# bytes a lane: rays in (24), t, column and payload out (4 + 4 + 128)
PROJ_LANE_BYTES = 24 + 136
# the words of a real column's compact row (ProjTables.rows) by type: a
# sphere's centre and radius; a rect's axis, its 6 coefficients and K0-K3; a
# triangle's three Woop rows with their offsets, and K0
ROW_WORDS = {0: 4, 1: 12, 2: 13}


def fail(msg: str):
    print(f"FAIL: {msg}", flush=True)
    raise SystemExit(1)


def check(cond: bool, msg: str):
    if not cond:
        fail(msg)


def log(msg: str):
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(torch):
    log("== phase 1: device")
    check(torch.cuda.is_available(), "torch.cuda.is_available() is False")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0].strip()
    log(card)
    from rust_pathtracer_tpu_torch.ops._build import nvcc_path

    nvcc = subprocess.run([nvcc_path(), "--version"], capture_output=True,
                          text=True, timeout=60)
    log(f"torch {torch.__version__} (CUDA {torch.version.cuda}); "
        f"device {torch.cuda.get_device_name(0)}; "
        f"device_count {torch.cuda.device_count()}; "
        f"nvcc: {nvcc.stdout.strip().splitlines()[-1]}")
    return card


def phase_build():
    log("== phase 2: build K1, K2, K3/K4, K5/K6/K7, the draw kernel, the pass-set key "
        "kernel, the lanes kernel, the shade kernel, the window-end kernels, CUB's pool "
        "sort and the native BVH builder")
    from concurrent.futures import ThreadPoolExecutor

    from rust_pathtracer_tpu_torch.ops import _build

    from rust_pathtracer_tpu_torch import native

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(KERNELS) + 1) as pool:
        # the host library (the BVH builder and OBJ parser) with g++ beside
        futs = [pool.submit(native.build)] + [pool.submit(_build.load_library, n)
                                              for n in KERNELS]
        for fut in futs:
            fut.result()  # one compiler a source, all at once; raises on failure
    log(f"built {', '.join(KERNELS)} and {native.library_path().name} in "
        f"{time.perf_counter() - t0:.2f} s")
    check(native.available(), "the native BVH builder does not load")
    for name in KERNELS:
        info = _build.build_info[name]
        log(f"{_build.CSRC / (name + '.cu')}: nvcc {info['seconds']:.2f} s")
        log(f"command: {info['command']}")
        for line in info["log"].splitlines():
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  ptxas: {line.strip()}")


def full_scene(device):
    """Every primitive kind, every material (metal with fuzz, dielectric,
    a hollow shell, a light) and solid / checker / perlin textures
    (tests/test_fused_bounce.py::_full_scene)."""
    from rust_pathtracer_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    checker = b.checker_texture(
        b.solid_texture((0.2, 0.3, 0.1)), b.solid_texture((0.9, 0.9, 0.9))
    )
    perlin = b.perlin_texture(4.0)
    b.add_sphere((0, -100.5, -3), 100.0, b.lambertian(checker))
    b.add_sphere((0, 0.5, -3), 0.5, b.lambertian(perlin))
    b.add_sphere((1.2, 0.5, -3), 0.5, b.metal((0.8, 0.7, 0.6), fuzz=0.2))
    b.add_sphere((-1.2, 0.5, -3), 0.5, b.dielectric(1.5))
    b.add_sphere((-1.2, 0.5, -3), -0.4, b.dielectric(1.5))  # hollow shell
    b.add_rect("xz", (-2, 3.0, -5), (2, 3.0, -1), -1.0,
               b.diffuse_light((4, 4, 4)))
    b.add_triangle((2.2, 0.0, -4), (3.2, 0.0, -4), (2.7, 1.2, -4),
                   b.lambertian((0.6, 0.2, 0.2)))
    return b.build(use_bvh=False, device=device)


def random_lanes(n: int, seed: int = 20261016):
    """Rays, throughputs, radiance, alive flags and lane keys from numpy:
    80% from a viewpoint in front of the scene, 10% from inside the glass
    shell, 10% from under the light looking up."""
    rng = np.random.default_rng(seed)
    o = np.array([0.0, 0.8, 1.5]) + rng.normal(0.0, 0.3, (n, 3))
    ang = rng.uniform(-0.6, 0.6, n)
    d = np.stack([np.sin(ang), rng.uniform(-0.9, 0.5, n), -np.cos(ang)], 1)
    d *= rng.uniform(0.5, 2.0, n)[:, None]  # directions are unnormalized
    idx = rng.permutation(n)
    shell, light = idx[: n // 10], idx[n // 10: n // 5]
    o[shell] = np.array([-1.2, 0.5, -3.0]) + rng.uniform(-0.3, 0.3, (len(shell), 3))
    d[shell] = rng.normal(0.0, 1.0, (len(shell), 3))
    o[light] = np.array([0.0, 1.5, -3.0]) + rng.uniform(-1.5, 1.5, (len(light), 3))
    d[light] = np.array([0.0, 1.0, 0.0]) + rng.normal(0.0, 0.4, (len(light), 3))
    thr = rng.uniform(0.2, 1.0, (n, 3))
    rad = rng.uniform(0.0, 0.5, (n, 3))
    alive = (rng.random(n) < 0.9).astype(np.float64)
    cols = np.concatenate([o, d, thr, rad, alive[:, None]], 1).T  # (13, n)
    lane_keys = rng.integers(0, 2**32, (n, 2), dtype=np.int64)  # uint32 words
    # C order, as the paths hand K1 its state: a transposed (13, n) array
    # would make the wrapper copy it into rows at every call
    return np.ascontiguousarray(cols, dtype=np.float32), lane_keys


def _keyed_on(torch, cols_np, keys_np, device):
    """The keyed K1's (13, R) state and (2, R) key words on ``device``."""
    from rust_pathtracer_tpu_torch.ops.fused_bounce import key_words

    return (torch.as_tensor(cols_np, device=device),
            key_words(torch.as_tensor(keys_np, device=device)))


def phase_kernel_vs_plain(torch, device, n_lanes):
    log(f"== phase 3: K1 vs plain on {n_lanes} lanes")
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
    from rust_pathtracer_tpu_torch.integrator import T_MIN

    cols_np, keys_np = random_lanes(n_lanes)
    bg = (0.2, 0.1, 0.05)
    runs = {}
    for where in ("kernel", "plain"):
        dev = device if where == "kernel" else "cpu"
        scene = full_scene(dev)
        table = fb.pack_prims_shaded(scene)
        state, keys = _keyed_on(torch, cols_np, keys_np, dev)
        win = torch.empty(n_lanes, dtype=torch.int32, device=dev)
        kw = dict(with_roulette=False, kinds=scene.kinds_static,
                  mat_types=scene.mat_types, tex_types=scene.tex_types, t_min=T_MIN,
                  winner_out=win)
        bgt = torch.tensor(bg, dtype=torch.float32, device=dev)
        fn = fb.fused_bounce_keyed if where == "kernel" else fb.fused_bounce_keyed_plain
        out = fn(table, bgt, scene.textures.perlin_seed, state, keys, 0, **kw)
        if dev != "cpu":
            torch.cuda.synchronize()
        runs[where] = (out.cpu().numpy(), win.cpu().numpy())
    (k_out, k_win), (p_out, p_win) = runs["kernel"], runs["plain"]
    table = fb.pack_prims_shaded(full_scene("cpu")).numpy()

    alive_in = cols_np[12] > 0.5
    alive_bad = (k_out[12] > 0.5) != (p_out[12] > 0.5)
    win_bad = k_win != p_win
    err = np.abs(k_out.astype(np.float64) - p_out)
    float_bad = (err > K1_ATOL + K1_RTOL * np.abs(p_out)).any(axis=0)

    # the one discrete flip allowed: a checker pick at sin-product ~ 0
    w = np.maximum(p_win, 0)
    is_ck = (p_win >= 0) & (table[fb.PAY_TKIND, w] == 1.0)
    ts = table[fb.PAY_TSCALE, w].astype(np.float64)
    hp = p_out[0:3].astype(np.float64)  # a checker lane continues from its hit point
    sines = np.sin(ts * hp[0]) * np.sin(ts * hp[1]) * np.sin(ts * hp[2])
    explained = float_bad & is_ck & (np.abs(sines) < CHECKER_SINES_EPS)
    unexplained = float_bad & ~explained
    max_abs = float(err[:, ~explained].max()) if (~explained).any() else 0.0

    hits = (p_win >= 0)
    log(f"lanes {n_lanes}: alive in {int(alive_in.sum())}, hits "
        f"{int(hits.sum())}, misses {int((alive_in & ~hits).sum())}, alive out "
        f"{int((p_out[12] > 0.5).sum())}")
    log("winner histogram (prim: lanes): " + ", ".join(
        f"{p}: {int((p_win == p).sum())}" for p in range(table.shape[1])))
    log(f"alive-out mismatches {int(alive_bad.sum())}, winner/hit mismatches "
        f"{int(win_bad.sum())}, float mismatches {int(float_bad.sum())} "
        f"(checker sines ~ 0: {int(explained.sum())}, unexplained "
        f"{int(unexplained.sum())}), max abs err {max_abs:.3e}")
    for i in np.nonzero(win_bad | alive_bad | unexplained)[0][:5]:
        log(f"  lane {i}: winner kernel {k_win[i]} plain {p_win[i]}; "
            f"kernel {k_out[:, i].tolist()}; plain {p_out[:, i].tolist()}")
    check(not alive_bad.any(), "alive-out masks differ")
    check(not win_bad.any(), "hit masks or winning primitives differ")
    check(not unexplained.any(), "floats differ beyond 1e-5 rel + 1e-6 abs")
    check(int(explained.sum()) <= MAX_EXPLAINED_FLIPS,
          f"{int(explained.sum())} checker flips > {MAX_EXPLAINED_FLIPS}")
    return max_abs


def _golden_path(name):
    return os.path.join(REPO, "tests", "goldens", f"{name}.npy")


def phase_goldens(torch, device):
    log("== phase 4: golden configurations on the card")
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.image import image_agreement

    for name, (w, h, spp, nb) in GOLDEN_CONFIGS.items():
        sd = get_scene(name)
        settings = RenderSettings(w, h, spp, nb, sd.output.image.background,
                                  spp_chunk=spp)
        img, _ = render_radiance(sd.build(device=device),
                                 sd.camera_at(0.0, device=device), settings,
                                 prng_key(GOLDEN_SEED, device=device),
                                 device=device)
        got = img.cpu().numpy()
        want = np.load(_golden_path(name))
        a = image_agreement(got, want)
        log(f"{name} {w}x{h} spp={spp} bounces={nb}: mean {got.mean():.6f} vs "
            f"golden {want.mean():.6f} (rel {a['mean_rel']:.2e}), pixels close "
            f"{a['frac_close']:.4f}, nan {a['has_nan']}")
        check(a["ok"], f"{name} breaks the image contract")


def _sync(torch, device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def phase_serve(torch, device, card, serve, bench, time_reps):
    log("== phase 5: serving render at full size")
    from rust_pathtracer_tpu_torch.integrator import T_MIN
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
    from rust_pathtracer_tpu_torch.render import (
        RenderSettings, _make_lanes, _render_chunk, render_radiance,
    )
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.image import to_rgb8, write_png

    sd = get_scene("CornellBox")
    scene = sd.build(device=device)
    cam = sd.camera_at(0.0, device=device)
    key = prng_key(serve["seed"], device=device)
    W, H = serve["width"], serve["height"]
    settings = RenderSettings(W, H, serve["spp"], serve["bounces"],
                              sd.output.image.background,
                              spp_chunk=serve["spp_chunk"])
    lanes = W * H * serve["spp_chunk"]

    _sync(torch, device)
    reset_counts()
    with count_threefry() as tf:
        t0 = time.perf_counter()
        img, stats = render_radiance(scene, cam, settings, key, device=device)
        _sync(torch, device)
        wall = time.perf_counter() - t0
    counts = read_counts()
    k1_launches = counts["K1"]
    check(counts["K1-res"] == 0, "the serving render wrote residuals")
    check(tf["loop"] == 0, f"the serving bounce loops called threefry2x32 "
          f"{tf['loop']} times in tensor ops")

    img_np = img.cpu().numpy()
    segments = float(stats.segments)
    n_chunks = -(-serve["spp"] // serve["spp_chunk"])
    log(f"CornellBox {W}x{H} spp={serve['spp']} bounces={serve['bounces']} "
        f"({n_chunks} chunks of {lanes} lanes) on {card}: wall {wall:.3f} s, "
        f"segments {segments:.0f}, segments/s {segments / wall:.4e}, mean depth "
        f"{segments / (W * H * serve['spp']):.4f}, bounces {stats.bounces}, "
        f"K1 launches {k1_launches}, lanes kernel launches {counts['lanes']}, image mean "
        f"{img_np.mean():.6f}; threefry2x32 in tensor ops: {tf['all'] - tf['loop']} calls "
        f"making lanes, {tf['loop']} in the bounce loops")
    check(np.isfinite(img_np).all(), "serving render has non-finite pixels")
    check((img_np >= 0).all(), "serving render has negative pixels")
    if torch.device(device).type == "cuda":
        check(k1_launches > 0, "the serving render launched K1 no time")
        check(k1_launches == stats.bounces,
              f"K1 launches {k1_launches} != bounces run {stats.bounces}")
        check(counts["lanes"] == n_chunks,
              f"the lanes kernel launched {counts['lanes']} times in {n_chunks} chunks")
        check(tf["all"] == 0, f"the serving render's lanes called threefry2x32 "
              f"{tf['all'] - tf['loop']} times in tensor ops")
    os.makedirs(OUT_DIR, exist_ok=True)
    png = os.path.join(OUT_DIR, f"CornellBox_{W}x{H}_{serve['spp']}spp.png")
    write_png(png, to_rgb8(img_np))
    log(f"wrote {png}")

    bg = torch.tensor(sd.output.image.background, dtype=torch.float32,
                      device=device)
    chunk_args = dict(width=W, height=H, spp_chunk=serve["spp_chunk"],
                      spp_total=serve["spp"], max_bounces=serve["bounces"],
                      rr_start=None)
    c0 = _render_chunk(scene, cam, key, 0, bg, **chunk_args)[0].cpu().numpy()
    c1 = _render_chunk(scene, cam, key, 0, bg, **chunk_args)[0].cpu().numpy()
    check(np.array_equal(c0, c1), "chunk 0 rendered twice differs")
    log("chunk 0 rendered twice: bitwise equal")

    # bench-shaped forward: bench.py's step without the backward
    bs = RenderSettings(bench["width"], bench["height"], bench["spp"],
                        bench["bounces"], (0.0, 0.0, 0.0), spp_chunk=bench["spp"])
    times = []
    for rep in range(bench["runs"] + 1):
        _sync(torch, device)
        with count_threefry() as tf:
            t0 = time.perf_counter()
            bimg, bstats = render_radiance(scene, cam, bs, key, device=device)
            bimg.sum().item()
            times.append(time.perf_counter() - t0)
        check(tf["all"] == 0, "the bench-shaped forward called threefry2x32 in tensor ops")
    med = statistics.median(times[1:])
    bseg = float(bstats.segments)
    log(f"bench-shaped forward {bench['width']}^2 spp={bench['spp']} "
        f"bounces={bench['bounces']} on {card}: median of {bench['runs']} "
        f"{med * 1e3:.2f} ms (runs {[round(t * 1e3, 2) for t in times[1:]]}), "
        f"segments {bseg:.0f}, segments/s {bseg / med:.4e}")

    # one keyed K1 launch against the keyed plain version at the serving
    # width: the first bounce of chunk 0 (camera rays, bounce 0)
    pix = torch.arange(W * H, dtype=torch.int64, device=device)
    lk, o, d, _ = _make_lanes(cam, key, pix, 0, width=W, height=H,
                              spp_chunk=serve["spp_chunk"],
                              spp_total=serve["spp"])
    state, keys = first_bounce_state(torch, o, d, lk)
    table = fb.pack_prims_shaded(scene)
    args = (table, bg, scene.textures.perlin_seed, state, keys, 0)
    kw = dict(with_roulette=False, kinds=scene.kinds_static, mat_types=scene.mat_types,
              tex_types=scene.tex_types, t_min=T_MIN)

    def k1():
        return fb.fused_bounce_keyed(*args, **kw)

    def plain():
        return fb.fused_bounce_keyed_plain(*args, **kw)

    res = time_pair(torch, device, k1, plain, time_reps, PLAIN_REPS)
    k_ms, p_ms = statistics.mean(res["kernel"]), statistics.mean(res["plain"])
    dev_ms, dev_held = _device_ms(torch, k1, time_reps, ("fused_bounce_kernel",))
    b_ms, b_by = k1_bound(torch, args, kw, residual_planes=0)
    log(f"K1 (keyed) at {lanes} lanes on {card}: {k_ms:.4f} ms per launch "
        f"(blocks {[round(x, 4) for x in res['kernel']]}; events around the "
        f"wrapper), {dev_ms:.4f} ms device time (profiler, {dev_held} of "
        f"{time_reps} launches); plain version on the "
        f"same CUDA tensors {p_ms:.4f} ms ({[round(x, 4) for x in res['plain']]}); "
        f"bound {b_ms:.4f} ms ({b_by})")
    return dict(launches=k1_launches, ms=k_ms, device_ms=(dev_ms, dev_held, time_reps),
                plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, lanes_launches=counts["lanes"],
                wall=wall)


def _checker_near_zero(np_flags, t, cols_np, table, fb):
    """Lanes whose winning checker's sin-product, at the hit point
    o + t d, lies within CHECKER_SINES_EPS of 0: there an ulp of sin
    on the card may pick the other child."""
    w = np_flags >> fb.FLG_BESTI_SHIFT
    hp = cols_np[0:3].astype(np.float64) + t.astype(np.float64) * cols_np[3:6]
    ts = table[fb.PAY_TSCALE, w].astype(np.float64)
    sines = np.sin(ts * hp[0]) * np.sin(ts * hp[1]) * np.sin(ts * hp[2])
    return ((np_flags & fb.FLG_IS_CK) != 0) & (np.abs(sines) < CHECKER_SINES_EPS)


def phase_residuals(torch, device, n_lanes):
    log(f"== phase 6: K1 with residuals vs plain on {n_lanes} lanes")
    from rust_pathtracer_tpu_torch.integrator import T_MIN
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb

    cols_np, keys_np = random_lanes(n_lanes)
    bg = (0.2, 0.1, 0.05)
    runs = {}
    for where, dev in (("kernel", device), ("plain", "cpu")):
        scene = full_scene(dev)
        args = (fb.pack_prims_shaded(scene),
                torch.tensor(bg, dtype=torch.float32, device=dev),
                scene.textures.perlin_seed, *_keyed_on(torch, cols_np, keys_np, dev), 0)
        kw = dict(with_roulette=False, kinds=scene.kinds_static,
                  mat_types=scene.mat_types, tex_types=scene.tex_types, t_min=T_MIN)
        fn = fb.fused_bounce_keyed if where == "kernel" else fb.fused_bounce_keyed_plain
        out, res = fn(*args, **kw, want_residuals=True)
        run = {"cols": out.cpu().numpy(),
               "res": {k: v.cpu().numpy() for k, v in res.items()}}
        if where == "kernel":
            run["cols0"] = fb.fused_bounce_keyed(*args, **kw).cpu().numpy()
        _sync(torch, dev)
        runs[where] = run
    k, p = runs["kernel"], runs["plain"]
    check(np.array_equal(k["cols"].view(np.uint32), k["cols0"].view(np.uint32)),
          "K1's 13 columns differ between residuals on and off")
    log("K1's 13 columns with residuals on: bit for bit those with residuals off")

    table = fb.pack_prims_shaded(full_scene("cpu")).numpy()
    kf, pf = k["res"]["flags"], p["res"]["flags"]
    near = _checker_near_zero(pf, p["res"]["t"], cols_np, table, fb)
    keys = fb._RES_KEYS[:-1]
    kr = np.stack([k["res"][n] for n in keys]).astype(np.float64)
    pr = np.stack([p["res"][n] for n in keys]).astype(np.float64)
    err = np.abs(kr - pr)
    float_bad = (err > K1_ATOL + K1_RTOL * np.abs(pr)).any(axis=0)
    flag_bad = kf != pf
    bad = flag_bad | float_bad
    explained = bad & near
    unexplained = bad & ~near
    max_abs = float(err[:, ~explained].max()) if (~explained).any() else 0.0
    bits = {n: int(((pf & getattr(fb, n)) != 0).sum()) for n in (
        "FLG_HIT", "FLG_CONT", "FLG_ALIVE", "FLG_REFLECT", "FLG_SINES_NEG",
        "FLG_LIGHT_ON", "FLG_COS_CLAMP", "FLG_REFR_ZERO", "FLG_L_NEG")}
    log(f"flags set (plain): {bits}")
    log(f"flag mismatches {int(flag_bad.sum())}, float mismatches "
        f"{int(float_bad.sum())} (checker sines ~ 0: {int(explained.sum())}, "
        f"unexplained {int(unexplained.sum())}), max abs err {max_abs:.3e}")
    for i in np.nonzero(unexplained)[0][:5]:
        log(f"  lane {i}: flags kernel {kf[i]:#x} plain {pf[i]:#x}; kernel "
            f"{kr[:, i].tolist()}; plain {pr[:, i].tolist()}")
    check(not unexplained.any(),
          "residuals differ beyond 1e-5 rel + 1e-6 abs or in a flag")
    check(int(explained.sum()) <= MAX_EXPLAINED_FLIPS,
          f"{int(explained.sum())} checker flips > {MAX_EXPLAINED_FLIPS}")
    return max_abs, cols_np, p["res"]


def _keyed_runs(torch, args, kw):
    """The keyed K1 (a check launch) and its plain version on the same
    tensors: {name: (state, winners, residuals)} as numpy, int32 views of
    the floats."""
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb

    state = args[3]
    want_res = kw.get("want_residuals", False)
    runs = {}
    for name, fn in (("kernel", fb.fused_bounce_keyed),
                     ("plain", fb.fused_bounce_keyed_plain)):
        win = torch.empty(state.shape[1], dtype=torch.int32, device=state.device)
        out = fn(*args, **kw, winner_out=win)
        out, res = out if want_res else (out, {})
        runs[name] = (out.cpu().numpy().view(np.int32), win.cpu().numpy(),
                      {k: v.cpu().numpy().view(np.int32) for k, v in res.items()})
    return runs


def _keyed_mismatches(runs):
    """Lanes where the kernel's state, winner or any residual differs in a
    bit from the plain version's."""
    (k_out, k_win, k_res), (p_out, p_win, p_res) = runs["kernel"], runs["plain"]
    check(set(k_res) == set(p_res), f"residual planes differ: {set(k_res) ^ set(p_res)}")
    lane = (k_out != p_out).any(axis=0) | (k_win != p_win)
    for k in k_res:
        lane |= k_res[k] != p_res[k]
    return lane


def phase_keyed_vs_plain(torch, device, n_lanes):
    log(f"== phase 18: the keyed K1 and K1-res vs their plain version, bit for bit, "
        f"on {n_lanes} lanes and at the serving and bench paths' first bounce")
    from rust_pathtracer_tpu_torch.integrator import T_MIN
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
    from rust_pathtracer_tpu_torch.render import _make_lanes
    from rust_pathtracer_tpu_torch.sampling import prng_key

    cols_np, _ = random_lanes(n_lanes)
    rng = np.random.default_rng(18)
    lk = torch.as_tensor(rng.integers(0, 2**32, (n_lanes, 2), dtype=np.int64),
                         device=device)
    scene = full_scene(device)
    state = torch.as_tensor(cols_np, device=device)
    args0 = (fb.pack_prims_shaded(scene), torch.tensor((0.2, 0.1, 0.05), device=device),
             scene.textures.perlin_seed, state, fb.key_words(lk))
    kw0 = dict(kinds=scene.kinds_static, mat_types=scene.mat_types,
               tex_types=scene.tex_types, t_min=T_MIN)
    cases = [(f"random lanes, bounce {b}, roulette {rr}, residuals {res}",
              args0 + (b,), dict(kw0, with_roulette=rr, want_residuals=res))
             for b in (0, 7) for rr in (False, True) for res in (False, True)]

    sd = get_scene("CornellBox")
    cb = sd.build(device=device)
    cam = sd.camera_at(0.0, device=device)
    for path, cfg, res in (("serving", SERVE, False), ("bench", BENCH, True)):
        W, H = cfg["width"], cfg["height"]
        chunk = cfg.get("spp_chunk", cfg["spp"])
        pix = torch.arange(W * H, dtype=torch.int64, device=device)
        plk, o, d, _ = _make_lanes(cam, prng_key(cfg.get("seed", 0), device=device), pix,
                                   0, width=W, height=H, spp_chunk=chunk,
                                   spp_total=cfg["spp"])
        st, keys = first_bounce_state(torch, o, d, plk)
        bg = torch.tensor(sd.output.image.background if path == "serving"
                          else (0.0, 0.0, 0.0), dtype=torch.float32, device=device)
        cases.append((f"{path} path's first bounce, {st.shape[1]} lanes",
                      (fb.pack_prims_shaded(cb), bg, cb.textures.perlin_seed, st, keys, 0),
                      dict(kinds=cb.kinds_static, mat_types=cb.mat_types,
                           tex_types=cb.tex_types, t_min=T_MIN, with_roulette=False,
                           want_residuals=res)))

    max_abs = 0.0
    for label, args, kw in cases:
        runs = _keyed_runs(torch, args, kw)
        _sync(torch, device)
        bad = _keyed_mismatches(runs)
        k_out, k_win, _ = runs["kernel"]
        max_abs = max(max_abs, float(np.abs(k_out.view(np.float32).astype(np.float64)
                                            - runs["plain"][0].view(np.float32)).max()))
        alive = k_out[12].view(np.float32) > 0.5
        log(f"{label}: lanes differing from the plain version {int(bad.sum())}; hits "
            f"{int((k_win >= 0).sum())}, alive out {int(alive.sum())}")
        for i in np.nonzero(bad)[0][:5]:
            log(f"  lane {i}: kernel {runs['kernel'][0][:, i].view(np.float32).tolist()}; "
                f"plain {runs['plain'][0][:, i].view(np.float32).tolist()}")
        check(not bad.any(), f"{label}: the keyed K1 differs from its plain version")
    return max_abs


def _bwd_args(torch, res_np, cols_np, cot, bg, device):
    """K2's arguments on ``device``: residuals, the incoming d and thr
    of ``cols_np``, the (12, n) cotangents ``cot``, the background."""
    from rust_pathtracer_tpu_torch.ops import fused_bounce_bwd as fbb

    def t(x):
        return torch.tensor(np.ascontiguousarray(x), device=device)

    return ({k: t(v) for k, v in res_np.items()},
            tuple(t(cols_np[3 + c]) for c in range(3)),
            tuple(t(cols_np[6 + c]) for c in range(3)),
            dict(zip(fbb._COT_KEYS, (t(c) for c in cot))),
            torch.tensor(bg, dtype=torch.float32, device=device))


def phase_bwd_vs_plain(torch, device, cols_np, res_np):
    n = cols_np.shape[1]
    log(f"== phase 7: K2 vs plain on {n} lanes")
    from rust_pathtracer_tpu_torch.ops import fused_bounce_bwd as fbb

    scene = full_scene("cpu")
    kw = dict(mat_types=scene.mat_types, n_prims=scene.num_prims)
    cot = np.random.default_rng(7).normal(size=(12, n)).astype(np.float32)
    bg = (0.2, 0.1, 0.05)
    p_g, p_tex, p_bg = fbb.fused_bounce_bwd_plain(
        *_bwd_args(torch, res_np, cols_np, cot, bg, "cpu"), **kw)
    args = _bwd_args(torch, res_np, cols_np, cot, bg, device)
    k_g, k_tex, k_bg = fbb.fused_bounce_bwd(*args, **kw)
    _, k_tex2, k_bg2 = fbb.fused_bounce_bwd(*args, **kw)
    _sync(torch, device)

    got = np.stack([k_g[k].cpu().numpy() for k in fbb._GRAD_KEYS]).astype(np.float64)
    want = np.stack([p_g[k].numpy() for k in fbb._GRAD_KEYS]).astype(np.float64)
    err = np.abs(got - want)
    bad = err > K2_RTOL * np.abs(want) + K2_ATOL_REL * np.abs(want).max()
    red = np.concatenate([p_tex.numpy().ravel(), p_bg.numpy()]).astype(np.float64)
    k_red = np.concatenate([k_tex.cpu().numpy().ravel(), k_bg.cpu().numpy()])
    red_err = np.abs(k_red - red)
    red_bad = red_err > K2_RTOL * np.abs(red) + K2_ATOL_REL * np.abs(red).max()
    same = torch.equal(k_tex, k_tex2) and torch.equal(k_bg, k_bg2)
    log(f"cotangent columns: max abs err {err.max():.3e} (largest value "
        f"{np.abs(want).max():.3e}), {int(bad.any(axis=0).sum())} lanes out of "
        f"tolerance; reductions ({red.size} = 9 x {scene.num_prims} + 3): max abs "
        f"err {red_err.max():.3e} (largest {np.abs(red).max():.3e}), "
        f"{int(red_bad.sum())} out of tolerance; second run bitwise equal: {same}")
    for i in np.nonzero(bad.any(axis=0))[0][:5]:
        log(f"  lane {i}: kernel {got[:, i].tolist()} plain {want[:, i].tolist()}")
    check(not bad.any(), "K2's cotangent columns differ from the plain version")
    check(not red_bad.any(), "K2's reductions differ from the plain version")
    check(same, "K2's reductions differ between two runs")
    return float(max(err.max(), red_err.max()))


def _grad_leaves(g):
    return [x.detach().cpu().numpy().astype(np.float64).ravel() for x in g.leaves()]


def _leaf_grads(leaves):
    """The .grad of each leaf as a numpy array; zeros where the step
    left none (a leaf the scene does not use, as the image texels of a
    scene without an image texture)."""
    return [np.zeros(x.shape, np.float32) if x.grad is None
            else x.grad.detach().cpu().numpy() for x in leaves]


def _zero_grads(leaves):
    for x in leaves:
        x.grad = None


def phase_small_step(torch, device):
    cfg = SMALL_STEP
    log(f"== phase 8: differentiable step on the card vs the CPU "
        f"({cfg['width']}x{cfg['height']}, {cfg['spp']} spp, {cfg['bounces']} "
        f"bounces, roulette from {cfg['rr_start']})")
    from rust_pathtracer_tpu_torch.grad import (
        CameraParams, DiffParams, render_loss_and_grad,
    )
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
    from rust_pathtracer_tpu_torch.ops import fused_bounce_bwd as fbb
    from rust_pathtracer_tpu_torch.render import RenderSettings
    from rust_pathtracer_tpu_torch.sampling import prng_key

    scene = get_scene("CornellBox").build()
    settings = RenderSettings(cfg["width"], cfg["height"], cfg["spp"],
                              cfg["bounces"], (0.5, 0.5, 0.5),
                              spp_chunk=cfg["spp"],
                              russian_roulette_start=cfg["rr_start"])
    params = DiffParams.from_scene(scene, CameraParams.create(*CORNELL_CAM),
                                   settings.background)
    target = torch.zeros(cfg["height"], cfg["width"], 3)
    out = {}
    for dev in ("cpu", device):
        fb.residual_launches = fbb.launches = 0
        t0 = time.perf_counter()
        loss, g = render_loss_and_grad(params, scene, settings, prng_key(7),
                                       target, device=dev)
        _sync(torch, dev)
        log(f"{dev}: loss {float(loss):.7f} in {time.perf_counter() - t0:.3f} s, "
            f"K1-res launches {fb.residual_launches}, K2 launches {fbb.launches}")
        if dev != "cpu":
            check(fb.residual_launches == fbb.launches == cfg["bounces"],
                  "the card's step did not launch K1-res and K2 once a bounce")
        out[dev] = (float(loss), _grad_leaves(g))
    (l0, g0), (l1, g1) = out["cpu"], out[device]
    scale = max(np.abs(x).max() for x in g0)
    for name, a, b in zip(LEAF_NAMES, g1, g0):
        err = np.abs(a - b)
        log(f"  {name}: max |grad| {np.abs(b).max():.4e}, max abs diff {err.max():.3e}")
        check(np.isfinite(a).all(), f"non-finite gradient of {name} on the card")
        check((err <= STEP_GRAD_ATOL_REL * scale + STEP_GRAD_RTOL * np.abs(b)).all(),
              f"the card's gradient of {name} differs from the CPU's")
    check(scale > 0, "the CPU step's gradients are all zero")
    check(abs(l1 - l0) <= STEP_LOSS_RTOL * abs(l0), "the card's loss differs")


def phase_bench_step(torch, device, card, time_reps):
    W, H, spp, nb = BENCH["width"], BENCH["height"], BENCH["spp"], BENCH["bounces"]
    lanes = W * H * spp
    log(f"== phase 9: bench-shaped differentiable step, CornellBox {W}x{H}, "
        f"{spp} spp, {nb} bounces, {lanes} lanes, loss = mean(img)")
    from rust_pathtracer_tpu_torch.grad import CameraParams, DiffParams, apply_params
    from rust_pathtracer_tpu_torch.integrator import T_MIN
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
    from rust_pathtracer_tpu_torch.ops import fused_bounce_bwd as fbb
    from rust_pathtracer_tpu_torch.render import (
        RenderSettings, _make_lanes, render_radiance,
    )
    from rust_pathtracer_tpu_torch.sampling import prng_key

    scene = get_scene("CornellBox").build(device=device)
    settings = RenderSettings(W, H, spp, nb, (0.0, 0.0, 0.0), spp_chunk=spp,
                              differentiable=True)
    params = DiffParams.from_scene(
        scene, CameraParams.create(*CORNELL_CAM, device=device), settings.background)
    key = prng_key(0, device=device)
    leaves = [x.detach().clone().requires_grad_(True) for x in params.leaves()]

    def forward():
        p = DiffParams.from_leaves(leaves)
        img, stats = render_radiance(apply_params(scene, p), p.camera.build(),
                                     settings, key, background=p.background,
                                     device=device)
        return img.mean(), stats

    def step():
        _zero_grads(leaves)
        loss, stats = forward()
        loss.backward()
        return loss, stats

    step()  # warm-up
    _sync(torch, device)
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with count_threefry() as tf:
        loss, stats = step()
        _sync(torch, device)
    counts = (fb.launches, fb.residual_launches, fbb.launches)
    lanes_launches = read_counts()["lanes"]
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    grads = _leaf_grads(leaves)
    segments = float(stats.segments)
    log(f"one step: loss {float(loss.detach()):.7f}, segments {segments:.0f} (mean depth "
        f"{segments / lanes:.4f}), launches K1 {counts[0]}, "
        f"K1-res {counts[1]}, K2 {counts[2]}, lanes {lanes_launches}, peak memory "
        f"{peak_gb:.3f} GB; threefry2x32 in tensor ops: {tf['all'] - tf['loop']} calls "
        f"making lanes, {tf['loop']} in the bounce loop")
    check(tf["loop"] == 0, "the step's bounce loop called threefry2x32 in tensor ops")
    check(tf["all"] == 0, "the step's lanes called threefry2x32 in tensor ops")
    check(lanes_launches == 1, f"a step launched the lanes kernel {lanes_launches} times, "
          "want 1")
    log("gradients: " + _grad_sums(grads))
    check(counts[1] == nb and counts[2] == nb and counts[0] == nb,
          f"a step launched K1 {counts[0]}, K1-res {counts[1]}, K2 {counts[2]} "
          f"times, want {nb} each")
    check(all(np.isfinite(g).all() for g in grads), "non-finite gradients")
    check(np.abs(grads[0]).sum() > 0, "tex_color's gradient is zero")

    med, spread, times = _batch_median(step, leaves, STEP)
    log(f"bench-shaped step on {card}: median {med * 1e3:.2f} ms over "
        f"{len(times)} batches of {STEP['reps']} (spread {spread:.3f}; batches "
        f"{[round(t * 1e3, 2) for t in times]} ms), segments/s {segments / med:.4e}")

    cam = DiffParams.from_leaves(leaves).camera.build()
    pix = torch.arange(W * H, dtype=torch.int64, device=device)

    def lanes_fn():
        return _make_lanes(cam, key, pix, 0, width=W, height=H, spp_chunk=spp,
                           spp_total=spp)

    split = _step_split(torch, leaves, forward, lanes_fn)
    log(f"step split on {card} (CUDA events, median of 3): forward "
        f"{split['forward']:.2f} ms = lanes {split['lanes']:.2f} + bounce loop with "
        f"residuals (K1 draws in the kernel) and the rest {split['loop']:.2f}; backward "
        f"{split['backward']:.2f} ms")

    # K1, K1 with residuals, K2 and the plain versions at the step's width:
    # the first bounce of the bench chunk
    with torch.no_grad():
        lk, o, d, _ = lanes_fn()
    state, keys = first_bounce_state(torch, o, d, lk)
    table = fb.pack_prims_shaded(scene)
    bg = torch.zeros(3, device=device)
    args = (table, bg, 0, state, keys, 0)
    kw = dict(with_roulette=False, kinds=scene.kinds_static, mat_types=scene.mat_types,
              tex_types=scene.tex_types, t_min=T_MIN)
    fns = {
        "K1": lambda: fb.fused_bounce_keyed(*args, **kw),
        "K1-res": lambda: fb.fused_bounce_keyed(*args, **kw, want_residuals=True),
        "K1-res plain": lambda: fb.fused_bounce_keyed_plain(*args, **kw,
                                                            want_residuals=True),
    }
    _, res = fns["K1-res"]()
    cot = torch.tensor(np.random.default_rng(3).normal(size=(12, lanes)).astype(np.float32),
                       device=device)
    bwd_args = (res, tuple(state[3:6]), tuple(state[6:9]),
                dict(zip(fbb._COT_KEYS, cot.unbind(0))), bg)
    bkw = dict(mat_types=scene.mat_types, n_prims=scene.num_prims)
    fns["K2"] = lambda: fbb.fused_bounce_bwd(*bwd_args, **bkw)
    fns["K2 plain"] = lambda: fbb.fused_bounce_bwd_plain(*bwd_args, **bkw)
    order = ("K1-res plain", "K1", "K1-res", "K2 plain", "K2",
             "K2", "K2 plain", "K1-res", "K1", "K1-res plain")
    ms = {}
    for name in order:
        ms.setdefault(name, []).append(_time_ms(torch, device, fns[name], time_reps))
    dev_ms = {name: (*_device_ms(torch, fns[name], time_reps, kernels), time_reps)
              for name, kernels in (("K1", ("fused_bounce_kernel",)),
                                    ("K1-res", ("fused_bounce_kernel",)),
                                    ("K2", K2_KERNELS))}
    for name, v in ms.items():
        dev = (f", {dev_ms[name][0]:.4f} ms device time (profiler, {dev_ms[name][1]} "
               f"of {time_reps} launches)" if name in dev_ms else "")
        log(f"{name} at {lanes} lanes on {card}: {statistics.mean(v):.4f} ms per "
            f"launch (blocks {[round(x, 4) for x in v]}; events){dev}")
    # K1-res: 13 columns and 2 key words in, 13 columns and 10 residual
    # planes out; K2: 28 columns in, 9 columns and the (9P + 3) reductions out
    k1res_bound = k1_bound(torch, args, kw, residual_planes=10)
    k2_bound = bound((28 + 9) * 4 * lanes + (9 * scene.num_prims + 3) * 4 + nbytes(bg),
                     K2_LANE_OPS * lanes)
    log(f"bounds at {lanes} lanes: K1-res {k1res_bound[0]:.4f} ms ({k1res_bound[1]}), "
        f"K2 {k2_bound[0]:.4f} ms ({k2_bound[1]})")
    return dict(k1res_launches=counts[1], k2_launches=counts[2],
                ms={k: statistics.mean(v) for k, v in ms.items()}, device_ms=dev_ms,
                bounds={"K1-res": k1res_bound, "K2": k2_bound},
                lanes_launches=lanes_launches, median_ms=med * 1e3, split=split)


# ---------------------------------------------------------------------------
# phases 10-13: the generic bounce path (K3, K4)
# ---------------------------------------------------------------------------


def _hit_columns(rec_or_t, hit, idx, kinds):
    """(exact, floats) numpy views of a K4 result (hit, t, idx) or a K3
    result (hit, t, idx, rec): the exact part is hit, idx, the winner's
    kind (-1 on a miss) and, for K3, mat and front; the floats are t and,
    for K3, point, normal, u, v as (lanes, k) columns."""
    hit_np, idx_np = hit.cpu().numpy(), idx.cpu().numpy()
    kind = np.where(hit_np, kinds[idx_np], -1)
    if not hasattr(rec_or_t, "point"):
        return [hit_np, idx_np, kind], rec_or_t.cpu().numpy()[:, None]
    rec = rec_or_t
    exact = [hit_np, idx_np, kind, rec.mat.cpu().numpy(), rec.front_face.cpu().numpy()]
    floats = np.concatenate([rec.t.cpu().numpy()[:, None], rec.point.cpu().numpy(),
                             rec.normal.cpu().numpy(), rec.u.cpu().numpy()[:, None],
                             rec.v.cpu().numpy()[:, None]], 1)
    return exact, floats


def compare_hits(name, kernel_out, plain_out, kinds):
    """Hold a K3 / K4 result against its plain version's: the exact part
    equal on every lane; t, point and normal bit for bit; u and v within
    CH_RTOL rel + CH_ATOL abs, apart from at most MAX_SEAM_LANES sphere-uv
    seam lanes (u = 0 on one side, 1 on the other, where atan2 meets
    +-pi).  Returns the max abs error outside the seam lanes."""
    k_ex, k_fl = _hit_columns(kernel_out[3] if len(kernel_out) == 4 else kernel_out[1],
                              kernel_out[0], kernel_out[2], kinds)
    p_ex, p_fl = _hit_columns(plain_out[3] if len(plain_out) == 4 else plain_out[1],
                              plain_out[0], plain_out[2], kinds)
    for label, a, b in zip(("hit", "idx", "kind", "mat", "front"), k_ex, p_ex):
        bad = a != b
        log(f"{name} {label}: {int(bad.sum())} mismatches")
        check(not bad.any(), f"{name}: {label} differs from the plain version")
    bits = k_fl.view(np.int32) != p_fl.view(np.int32)
    log(f"{name} floats differing in any bit, by column (t, point, normal, u, v): "
        f"{bits.sum(axis=0).tolist()}")
    check(not bits[:, :7].any(), f"{name}: t, point or normal differ from the plain "
          "version's in some bit")
    err = np.abs(k_fl.astype(np.float64) - p_fl)
    bad = (err > CH_ATOL + CH_RTOL * np.abs(p_fl)).any(axis=1)
    seam = np.zeros_like(bad)
    if k_fl.shape[1] > 1:  # K3: u is column 7
        seam = bad & (k_ex[2] == 0) & (np.abs(k_fl[:, 7] - p_fl[:, 7]) > 0.5)
    max_abs = float(err[~seam].max()) if (~seam).any() else 0.0
    hits = p_ex[0]
    log(f"{name}: {len(hits)} lanes, {int(hits.sum())} hits; float mismatches "
        f"{int(bad.sum())} (sphere-uv seam {int(seam.sum())}), max abs err "
        f"{max_abs:.3e}")
    for i in np.nonzero(bad & ~seam)[0][:5]:
        log(f"  lane {i}: kernel {k_fl[i].tolist()} plain {p_fl[i].tolist()}")
    check(not (bad & ~seam).any(),
          f"{name}: floats differ beyond {CH_RTOL} rel + {CH_ATOL} abs")
    check(int(seam.sum()) <= MAX_SEAM_LANES,
          f"{name}: {int(seam.sum())} seam lanes > {MAX_SEAM_LANES}")
    return max_abs


def time_hits(torch, device, card, name, kernel, plain, args, kw, record, reps):
    """Time one of K3 / K4 against its plain version on ``args`` and
    compute its bound; returns a dict of ms, plain_ms, blocks, bound."""
    table, o, d = args
    lanes = o.shape[0]
    ms = time_pair(torch, device, lambda: kernel(*args, **kw),
                   lambda: plain(*args, **kw), reps, PLAIN_REPS)
    out_bytes = (46 if record else 9) * lanes
    b_ms, b_by = bound(nbytes(table, o, d) + out_bytes,
                       sweep_ops(kw["kinds"], lanes, record=record))
    k_ms, p_ms = statistics.mean(ms["kernel"]), statistics.mean(ms["plain"])
    dev_ms, dev_held = _device_ms(torch, lambda: kernel(*args, **kw), reps,
                                  ("closest_hit_kernel",))
    log(f"{name} at {lanes} lanes ({table.shape[1]} primitives) on {card}: "
        f"{k_ms:.4f} ms per launch (blocks of {reps}: "
        f"{[round(x, 4) for x in ms['kernel']]}, spread {_spread(ms['kernel']):.3f}; "
        f"events around the wrapper), {dev_ms:.4f} ms device time (profiler, "
        f"{dev_held} of {reps} launches); "
        f"plain on the same CUDA tensors {p_ms:.4f} ms "
        f"({[round(x, 4) for x in ms['plain']]}); bound {b_ms:.4f} ms ({b_by})")
    return dict(ms=k_ms, device_ms=(dev_ms, dev_held, reps), plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by)


def phase_closest_hit_vs_plain(torch, device, card, n_lanes, time_reps):
    log(f"== phase 10: K3 and K4 vs plain on {n_lanes} lanes")
    from rust_pathtracer_tpu_torch.integrator import T_MIN
    from rust_pathtracer_tpu_torch.ops import closest_hit as ch

    cols_np, _ = random_lanes(n_lanes)
    scene = full_scene(device)
    args = (ch.pack_prims(scene.prims),
            torch.tensor(np.ascontiguousarray(cols_np[0:3].T), device=device),
            torch.tensor(np.ascontiguousarray(cols_np[3:6].T), device=device))
    kw = dict(kinds=scene.kinds_static, t_min=T_MIN)
    kinds = scene.prims.kind.cpu().numpy()
    out = {}
    for name, kernel, plain, record in (
            ("K4", ch.closest_hit, ch.closest_hit_plain, False),
            ("K3", ch.closest_hit_record, ch.closest_hit_record_plain, True)):
        k, p = kernel(*args, **kw), plain(*args, **kw)
        _sync(torch, device)
        err = compare_hits(name, k, p, kinds)
        out[name] = dict(time_hits(torch, device, card, name, kernel, plain, args, kw,
                                   record, time_reps), max_abs_err=err)
    return out


def simple_scene(device):
    """tests/test_grad.py::_scene_simple: a lambertian sphere, a ground
    sphere with an 8x8 image ramp, a rect light."""
    from rust_pathtracer_tpu_torch.scene.builder import SceneBuilder

    b = SceneBuilder()
    b.add_sphere((0.0, 0.5, -3.0), 0.5, b.lambertian((0.4, 0.5, 0.6)))
    ramp = np.linspace(0.1, 0.9, 8 * 8 * 3).reshape(8, 8, 3).astype(np.float32)
    b.add_sphere((0.0, -100.0, -3.0), 100.0, b.lambertian(b.image_texture(ramp)))
    b.add_rect("xz", (-2.0, 4.0, -5.0), (2.0, 4.0, -1.0), -1.0,
               b.diffuse_light((5.0, 5.0, 5.0)))
    return b.build(use_bvh=False, device=device)


def _first_bounce(torch, device, cam, key, cfg):
    """The camera rays of a one-chunk frame (its first bounce)."""
    from rust_pathtracer_tpu_torch.render import _make_lanes

    W, H, spp = cfg["width"], cfg["height"], cfg["spp"]
    pix = torch.arange(W * H, dtype=torch.int64, device=device)
    with torch.no_grad():
        _, o, d, _ = _make_lanes(cam, key, pix, 0, width=W, height=H, spp_chunk=spp,
                                 spp_total=spp)
    return o.contiguous(), d.contiguous()


def phase_generic_forward(torch, device, card, time_reps):
    cfg = GENERIC
    W, H, spp, nb = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"]
    lanes = W * H * spp
    log(f"== phase 11: non-differentiable generic render, image-textured scene "
        f"{W}x{H}, {spp} spp, {nb} bounces, one chunk of {lanes} lanes")
    from rust_pathtracer_tpu_torch.camera import make_camera
    from rust_pathtracer_tpu_torch.integrator import T_MIN
    from rust_pathtracer_tpu_torch.ops import closest_hit as ch
    from rust_pathtracer_tpu_torch.ops.fused_bounce import fused_bounce_ok
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.image import image_agreement, to_rgb8, write_png

    scene = simple_scene(device)
    check(not fused_bounce_ok(scene), "the image scene would take the fused route")
    cam = make_camera(*SIMPLE_CAM, device=device)
    key = prng_key(cfg["seed"], device=device)
    settings = RenderSettings(W, H, spp, nb, SIMPLE_BG)
    check(settings.resolve_chunk() == spp, "the frame is not one chunk")

    _sync(torch, device)
    reset_counts()
    t0 = time.perf_counter()
    img, stats = render_radiance(scene, cam, settings, key, device=device)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    counts = read_counts()
    img_np = img.cpu().numpy()
    segments = float(stats.segments)
    log(f"{W}x{H} on {card}: wall {wall:.3f} s, segments {segments:.0f}, segments/s "
        f"{segments / wall:.4e}, bounces {stats.bounces}, launches {counts}, image mean "
        f"{img_np.mean():.6f}")
    check(np.isfinite(img_np).all(), "the generic render has non-finite pixels")
    check((img_np >= 0).all(), "the generic render has negative pixels")
    check(counts["K3"] == counts["draws"] == stats.bounces > 0,
          f"K3 and the draw kernel launched {counts['K3']} and {counts['draws']} times "
          f"in {stats.bounces} bounces")
    check(counts["K1"] == counts["K4"] == 0, "the generic forward left its route")
    img2, _ = render_radiance(scene, cam, settings, key, device=device)
    check(torch.equal(img, img2), "the generic render twice differs")
    log("rendered twice: bitwise equal")
    os.makedirs(OUT_DIR, exist_ok=True)
    png = os.path.join(OUT_DIR, f"image_scene_{W}x{H}_{spp}spp.png")
    write_png(png, to_rgb8(img_np))
    log(f"wrote {png}")

    small = RenderSettings(64, 36, 8, 8, SIMPLE_BG)
    imgs = [render_radiance(simple_scene(dev), make_camera(*SIMPLE_CAM, device=dev),
                            small, prng_key(cfg["seed"], device=dev), device=dev)[0]
            for dev in (device, "cpu")]
    a = image_agreement(imgs[0].cpu().numpy(), imgs[1].numpy())
    log(f"64x36, 8 spp, 8 bounces, card vs CPU: mean rel {a['mean_rel']:.2e}, pixels "
        f"close {a['frac_close']:.4f}, nan {a['has_nan']}")
    check(a["ok"], "the card's generic render breaks the image contract against the CPU")

    # K3 against its plain version at this path's shape: the first bounce
    args = (ch.pack_prims(scene.prims), *_first_bounce(torch, device, cam, key, cfg))
    kw = dict(kinds=scene.kinds_static, t_min=T_MIN)
    err = compare_hits("K3", ch.closest_hit_record(*args, **kw),
                       ch.closest_hit_record_plain(*args, **kw),
                       scene.prims.kind.cpu().numpy())
    return dict(time_hits(torch, device, card, "K3", ch.closest_hit_record,
                          ch.closest_hit_record_plain, args, kw, True, time_reps),
                launches=counts["K3"], max_abs_err=err)


def _diff_leaves(torch, scene, cam, bg, device):
    from rust_pathtracer_tpu_torch.grad import CameraParams, DiffParams

    params = DiffParams.from_scene(scene, CameraParams.create(*cam, device=device), bg)
    return [x.detach().clone().requires_grad_(True) for x in params.leaves()]


def _diff_forward(scene, leaves, settings, key, device):
    from rust_pathtracer_tpu_torch.grad import DiffParams, apply_params
    from rust_pathtracer_tpu_torch.render import render_radiance

    p = DiffParams.from_leaves(leaves)
    img, stats = render_radiance(apply_params(scene, p), p.camera.build(), settings, key,
                                 background=p.background, device=device)
    return img.mean(), stats


def phase_main_step(torch, device, card, time_reps):
    cfg = MAIN
    W, H, spp, nb = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"]
    lanes = W * H * spp
    log(f"== phase 12 (main path): differentiable TwoSphereCheckers step {W}x{H}, "
        f"{spp} spp, {nb} bounces, one chunk of {lanes} lanes, loss = mean(img)")
    from rust_pathtracer_tpu_torch.grad import (
        CameraParams, DiffParams, render_loss_and_grad,
    )
    from rust_pathtracer_tpu_torch.integrator import T_MIN, resolve_remat_mode
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops import closest_hit as ch
    from rust_pathtracer_tpu_torch.render import RenderSettings, _make_lanes
    from rust_pathtracer_tpu_torch.sampling import prng_key

    scene = get_scene("TwoSphereCheckers").build(device=device)
    settings = RenderSettings(W, H, spp, nb, TSC_BG, differentiable=True)
    check(settings.resolve_chunk() == spp, "the frame is not one chunk")
    mode = resolve_remat_mode(settings.remat, lanes, nb)
    check(mode == "none", f"remat auto resolved to {mode!r}, want 'none'")
    key = prng_key(cfg["seed"], device=device)
    leaves = _diff_leaves(torch, scene, TSC_CAM, TSC_BG, device)

    def forward():
        return _diff_forward(scene, leaves, settings, key, device)

    def step():
        _zero_grads(leaves)
        loss, stats = forward()
        loss.backward()
        return loss, stats

    t0 = time.perf_counter()
    loss0, _ = step()  # warm-up, and the first of two steps on one key
    _sync(torch, device)
    log(f"first step {time.perf_counter() - t0:.3f} s")
    grads0 = _leaf_grads(leaves)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    loss, stats = step()
    _sync(torch, device)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    grads = _leaf_grads(leaves)
    segments = float(stats.segments)
    kept = (peak - base) / (lanes * nb)
    log(f"one step: loss {float(loss.detach()):.7f}, segments {segments:.0f} (mean depth "
        f"{segments / lanes:.4f}), launches {counts}, peak memory {peak / 1e9:.3f} GB "
        f"({(peak - base) / 1e9:.3f} GB above the {base / 1e9:.3f} GB before the step: "
        f"{kept:.1f} B a lane-bounce with remat 'none')")
    log("gradients: " + _grad_sums(grads))
    check(counts["K4"] == counts["draws"] == nb,
          f"K4 and the draw kernel launched {counts['K4']} and {counts['draws']} times, "
          f"want {nb}")
    check(counts["K1"] == counts["K1-res"] == counts["K2"] == counts["K3"] == 0,
          "the generic step left its route")
    check(all(np.isfinite(g).all() for g in grads), "non-finite gradients")
    check(np.abs(grads[2]).min() > 0, "a background gradient is zero")
    check(np.abs(np.concatenate([g.ravel() for g in grads[3:]])).max() > 0,
          "the camera gradients are zero")
    same = (float(loss0.detach()) == float(loss.detach())
            and all(np.array_equal(a, b) for a, b in zip(grads0, grads)))
    log(f"two steps on one key: loss and gradients bitwise equal: {same}")
    check(same, "two steps on one key differ")

    med, spread, times = _batch_median(step, leaves, MAIN_STEP)
    log(f"TwoSphereCheckers step on {card}: median {med * 1e3:.2f} ms over "
        f"{len(times)} batches of {MAIN_STEP['reps']} (spread {spread:.3f}; batches "
        f"{[round(t * 1e3, 2) for t in times]} ms), segments/s {segments / med:.4e}")
    cam = DiffParams.from_leaves(leaves).camera.build()
    pix = torch.arange(W * H, dtype=torch.int64, device=device)

    def lanes_fn():
        return _make_lanes(cam, key, pix, 0, width=W, height=H, spp_chunk=spp,
                           spp_total=spp)

    split = _step_split(torch, leaves, forward, lanes_fn)
    log(f"step split on {card} (CUDA events, median of 3): forward "
        f"{split['forward']:.2f} ms = lanes {split['lanes']:.2f} + bounce loop (the "
        f"draw kernel included) and the rest {split['loop']:.2f}; "
        f"backward {split['backward']:.2f} ms")

    # K4 against its plain version at this path's shape: the first bounce
    args = (ch.pack_prims(scene.prims), *_first_bounce(torch, device, cam, key, cfg))
    kw = dict(kinds=scene.kinds_static, t_min=T_MIN)
    err = compare_hits("K4", ch.closest_hit(*args, **kw), ch.closest_hit_plain(*args, **kw),
                       scene.prims.kind.cpu().numpy())
    k4 = dict(time_hits(torch, device, card, "K4", ch.closest_hit, ch.closest_hit_plain,
                        args, kw, False, time_reps),
              launches=counts["K4"], max_abs_err=err)

    # the same step at 16x9 on the card against the CPU
    small = RenderSettings(16, 9, 4, 6, TSC_BG)
    cpu_scene = get_scene("TwoSphereCheckers").build()
    params = DiffParams.from_scene(cpu_scene, CameraParams.create(*TSC_CAM), TSC_BG)
    out = {dev: render_loss_and_grad(params, cpu_scene, small, prng_key(cfg["seed"]),
                                     torch.zeros(9, 16, 3), device=dev)
           for dev in ("cpu", device)}
    (l0, g0), (l1, g1) = out["cpu"], out[device]
    g0, g1 = _grad_leaves(g0), _grad_leaves(g1)
    scale = max(np.abs(x).max() for x in g0)
    log(f"16x9 step, card vs CPU: loss {float(l1):.7f} vs {float(l0):.7f}, max abs "
        f"gradient difference {max(np.abs(a - b).max() for a, b in zip(g1, g0)):.3e} "
        f"(largest gradient {scale:.4e})")
    check(abs(float(l1) - float(l0)) <= STEP_LOSS_RTOL * abs(float(l0)),
          "the card's 16x9 loss differs")
    for name, a, b in zip(LEAF_NAMES, g1, g0):
        check((np.abs(a - b) <= STEP_GRAD_ATOL_REL * scale
               + STEP_GRAD_RTOL * np.abs(b)).all(),
              f"the card's 16x9 gradient of {name} differs from the CPU's")
    return k4


def phase_light_step(torch, device, card):
    cfg = LIGHT
    W, H, spp, nb = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"]
    lanes = W * H * spp
    log(f"== phase 13: differentiable LightTest step {W}x{H}, {spp} spp, {nb} "
        f"bounces, one chunk of {lanes} lanes, remat 'auto'")
    from rust_pathtracer_tpu_torch.integrator import resolve_remat_mode
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import RenderSettings
    from rust_pathtracer_tpu_torch.sampling import prng_key

    scene = get_scene("LightTest").build(device=device)
    settings = RenderSettings(W, H, spp, nb, (0.0, 0.0, 0.0), differentiable=True,
                              remat="auto")
    check(settings.resolve_chunk() == spp, "the frame is not one chunk")
    mode = resolve_remat_mode(settings.remat, lanes, nb)
    check(mode != "none", "remat auto did not resolve to a checkpointed mode")
    leaves = _diff_leaves(torch, scene, LIGHT_CAM, (0.0, 0.0, 0.0), device)
    key = prng_key(cfg["seed"], device=device)
    for run in ("first (warm-up of this route)", "second"):
        _zero_grads(leaves)
        _sync(torch, device)
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        reset_counts()
        t0 = time.perf_counter()
        loss, stats = _diff_forward(scene, leaves, settings, key, device)
        loss.backward()
        _sync(torch, device)
        wall = time.perf_counter() - t0
        counts = read_counts()
        peak = torch.cuda.max_memory_allocated()
        segments = float(stats.segments)
        log(f"{run} step (remat {mode!r}) on {card}: {wall:.3f} s, loss "
            f"{float(loss.detach()):.7f}, segments {segments:.0f} (mean depth "
            f"{segments / lanes:.4f}), segments/s {segments / wall:.4e}, launches "
            f"{counts}, peak memory {peak / 1e9:.3f} GB ({(peak - base) / 1e9:.3f} GB "
            f"above the {base / 1e9:.3f} GB before the step)")
    grads = _leaf_grads(leaves)
    log("gradients: " + _grad_sums(grads))
    check(counts["K4"] == counts["draws"] == nb,
          f"K4 and the draw kernel launched {counts['K4']} and {counts['draws']} times "
          f"over forward and backward, want {nb}")
    check(all(np.isfinite(g).all() for g in grads), "non-finite gradients")
    check(np.abs(grads[0]).sum() > 0, "tex_color's gradient is zero")


# ---------------------------------------------------------------------------
# phases 14-17: the big-scene path (K5, K6, K7)
# ---------------------------------------------------------------------------


def big_scenes(device):
    """SphereField, ModelTest on the 10,080-triangle asset and on the
    20,000-triangle one, built on ``device``: name -> (SceneDef, scene).
    The OBJ assets are written under OUT_DIR."""
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.scene.obj_loader import write_benchmark_obj

    os.makedirs(OUT_DIR, exist_ok=True)
    out = {}
    for name, kw in (("SphereField", None), ("ModelTest", {}),
                     ("ModelTest 20k", MESH_20K)):
        t0 = time.perf_counter()
        if kw is None:
            sd = get_scene(name)
        else:
            path = os.path.join(OUT_DIR, f"model_{'20k' if kw else '10k'}.obj")
            tris = write_benchmark_obj(path, **kw)
            sd = get_scene("ModelTest", obj_path=path)
        scene = sd.build(device=device)
        P = scene.proj
        log(f"{name}: {scene.num_prims} primitives, {P.num_cols} columns, "
            f"{sum(k != -1 for k in P.group_kinds)} real clusters, col_block "
            f"{P.col_block}, built in {time.perf_counter() - t0:.2f} s"
            + ("" if kw is None else f" ({tris} triangles)"))
        out[name] = (sd, scene)
    return out


def big_lanes(torch, device, name, sd, cfg, n_lanes, seed=20261016):
    """The first bounce of ``cfg``'s frame (its camera rays), then random
    lanes in the scene box up to ``n_lanes``, every tenth parked at
    PARKED (a dead lane of the forward route)."""
    from rust_pathtracer_tpu_torch.sampling import prng_key

    cam = sd.camera_at(0.0, device=device)
    o, d = _first_bounce(torch, device, cam, prng_key(cfg["seed"], device=device), cfg)
    n_rand = max(n_lanes - o.shape[0], 0)
    rng = np.random.default_rng(seed)
    lo, hi = SCENE_BOX["SphereField" if name == "SphereField" else "ModelTest"]
    ro = rng.uniform(lo, hi, (n_rand, 3))
    ro[::10] = PARKED
    rd = rng.normal(size=(n_rand, 3))
    o = torch.cat([o, torch.tensor(ro, dtype=torch.float32, device=device)])
    d = torch.cat([d, torch.tensor(rd, dtype=torch.float32, device=device)])
    return o[:n_lanes].contiguous(), d[:n_lanes].contiguous()


def _slab_passes(torch, tables, o, d):
    """Mean count of clusters a lane's slab test passes (entry at t_min,
    exit at T_MISS: the worklist's test)."""
    from rust_pathtracer_tpu_torch.integrator import T_MIN
    from rust_pathtracer_tpu_torch.ops.projected import slab_bounds

    total = 0
    for s0 in range(0, o.shape[0], 1 << 17):
        lo, hi = slab_bounds(tables.cluster_bounds, o[s0:s0 + (1 << 17)],
                             d[s0:s0 + (1 << 17)], T_MIN)
        total += int((hi >= lo).sum())
    return total / o.shape[0]


class _Captured(Exception):
    pass


def path_lanes(torch, device, scene, sd, cfg, bg, want):
    """The lanes the forward frame of ``cfg`` hands its projected search at
    the first bounce b (0: the camera rays) for which ``want(b, kernel)``
    holds, ``kernel`` the one the search launched there ("K5", "K6" or
    "K7"), as the path gives them (dead lanes parked): (b, kernel, o, d).
    The frame stops there."""
    from rust_pathtracer_tpu_torch import integrator
    from rust_pathtracer_tpu_torch.ops import projected as P
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key

    seen = []
    routed = P.closest_hit_routed

    def capture(tables, o, d, t_min, route=None):
        lanes, before = (o.clone(), d.clone()), read_counts()
        out = routed(tables, o, d, t_min, route)
        after = read_counts()
        kernel = next(k for k in ("K5", "K6", "K7") if after[k] > before[k])
        seen.append(kernel)
        if want(len(seen) - 1, kernel):
            raise _Captured(len(seen) - 1, kernel, *lanes)
        return out

    settings = RenderSettings(cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"], bg)
    # the forward route calls integrator's name for it, the others projected's
    P.closest_hit_routed = integrator.closest_hit_routed = capture
    try:
        render_radiance(scene, sd.camera_at(0.0, device=device), settings,
                        prng_key(cfg["seed"], device=device), device=device)
    except _Captured as c:
        return c.args
    finally:
        P.closest_hit_routed = integrator.closest_hit_routed = routed
    fail(f"no bounce of the frame gives what is wanted (kernels by bounce: {seen})")


def lanes_per_visit(stats):
    """(mean passing lanes of a warp visit, share of visits with fewer than
    ``projected.COOP_P``) from the plain sweep's "warp_visits"."""
    from rust_pathtracer_tpu_torch.ops.projected import COOP_P

    h = np.asarray(stats.get("warp_visits", [0] * 33), np.float64)
    visits = h[1:].sum()
    if visits == 0:
        return 0.0, 0.0
    return float((np.arange(33) * h).sum() / visits), float(h[1:COOP_P].sum() / visits)


def _sweep_fns(torch, tables, o, d):
    """K5, K6 and K7 and their plain versions on (o, d), K7 with the slot
    table of blocks of WL_RB lanes (WL_KCAP slots where no block
    overflows, else every cluster).  Returns {name: (kernel, plain,
    bytes of tables and slots read, note, per-cluster q-domain flags)}."""
    from rust_pathtracer_tpu_torch.integrator import T_MIN
    from rust_pathtracer_tpu_torch.ops import projected as P
    from rust_pathtracer_tpu_torch.ops import resident as RS
    from rust_pathtracer_tpu_torch.ops import worklist as WL

    rb, n = WL.WL_RB, o.shape[0]
    Rp = -(-n // rb) * rb
    pad = torch.zeros((Rp - n, 3), device=o.device)
    op, dp = torch.cat([o, pad]), torch.cat([d, pad])
    G = tables.num_groups
    meta7, ov = WL.build_pair_worklist(tables.cluster_bounds, tables.group_kinds, op,
                                       dp, T_MIN, rb, WL.WL_KCAP)
    note7 = f"kcap {min(WL.WL_KCAP, G)}"
    if bool(ov):
        meta7, _ = WL.build_pair_worklist(tables.cluster_bounds, tables.group_kinds, op,
                                          dp, T_MIN, rb, G)
        note7 = f"kcap {G} (a block passes more than {WL.WL_KCAP})"
    q_always = tuple(k == 0 for k in tables.group_kinds)  # K6, K7: spheres in q
    rows = table_bytes(tables)
    return {
        "K5": (lambda: P.projected_sweep(tables, o, d, T_MIN),
               lambda st=None: P.projected_sweep_plain(tables, o, d, T_MIN, stats=st),
               rows, "every cluster", tables.dense_q),
        "K6": (lambda: RS.resident_sweep(tables, o, d, T_MIN),
               lambda st=None: RS.resident_sweep_plain(tables, o, d, T_MIN, stats=st),
               rows, "every cluster", q_always),
        "K7": (lambda: WL.pair_sweep(tables, o, d, T_MIN, meta7, rb),
               lambda st=None: WL.pair_sweep_plain(tables, o, d, T_MIN, meta7, rb,
                                                   stats=st),
               rows + nbytes(meta7), note7, q_always),
    }


def table_bytes(tables):
    """The bytes of the tables a sweep's function reads once: each real
    column's row words (ROW_WORDS) and payload row and each real
    cluster's AABB."""
    kinds = np.repeat(np.asarray(tables.group_kinds), 128)
    real = (kinds >= 0) & (tables.const[0].cpu().numpy() != np.float32(1e30))
    words = np.select([kinds == 0, kinds == 1, kinds == 2],
                      [ROW_WORDS[0], ROW_WORDS[1], ROW_WORDS[2]], 0)
    clusters = sum(k >= 0 for k in tables.group_kinds)
    return int(4 * words[real].sum() + 4 * 32 * real.sum() + 4 * 6 * clusters)


def cluster_ops(tables, q_flags):
    """((G,) f32, (G,) f64) operations one lane's sweep of each cluster
    needs, counted from the tables' sparsity: a rect's or triangle's
    projection takes a multiply for each nonzero origin or direction
    coefficient other than +-1 and an add for each nonzero term past the
    first (the ray's 1 adds the constant, its 0 drops the eighth term); a
    real column adds its type's FORMULA_OPS, a real sphere column
    SPHERE_F64_OPS in f64 (SPHERE_T_OPS more in f32 outside the q domain)
    and no projection, a padding column (K0 = 1e30) nothing; a q-domain
    sphere cluster divides its winner once in f32."""
    G = tables.num_groups
    rows = np.concatenate([tables.a.cpu().numpy(), tables.b.cpu().numpy()])[:, :7]
    nz = rows != 0
    ops = ((nz[:, :6] & (np.abs(rows[:, :6]) != 1)).sum(axis=(0, 1))
           + np.maximum(nz.sum(axis=1) - 1, 0).sum(axis=0))
    kinds = np.repeat(np.asarray(tables.group_kinds), 128)
    q = np.repeat(np.asarray(q_flags, bool), 128)
    form = np.select([kinds == 1, kinds == 2], [FORMULA_OPS[1], FORMULA_OPS[2]], 0)
    real = tables.const[0].cpu().numpy() != np.float32(1e30)
    sphere = real & (kinds == 0)
    per_col = (np.where(kinds == 0, 0, ops) + np.where(real, form, 0)
               + np.where(sphere & ~q, SPHERE_T_OPS, 0))
    per_col64 = np.where(sphere, SPHERE_F64_OPS, 0)
    winner = (np.asarray(tables.group_kinds) == 0) & np.asarray(q_flags, bool)
    return (per_col.reshape(G, 128).sum(axis=1) + winner,
            per_col64.reshape(G, 128).sum(axis=1))


def proj_bound(tables, n_lanes, stats, read_bytes, q_flags):
    """The least time for one sweep: the bytes (rays in, outputs out, and
    ``read_bytes``: the tables and slots read once) over the memory rate
    against the operations these inputs need (the plain version's count
    of slab tests and of each cluster's sweeps, times ``cluster_ops``)
    over the f32 and f64 peaks."""
    swept = np.asarray(stats.get("swept", [0] * tables.num_groups), np.int64)
    f32_ops, f64_ops = cluster_ops(tables, q_flags)
    ops = (stats.get("slab_tests", 0) * SLAB_OPS + n_lanes * PROJ_LANE_OPS
           + int((swept * f32_ops).sum()))
    return bound(n_lanes * PROJ_LANE_BYTES + read_bytes, ops,
                 n_f64_ops=n_lanes * PROJ_LANE_F64_OPS + int((swept * f64_ops).sum()))


def time_sweep(torch, device, card, label, fns, tables, n_lanes, reps):
    """One of K5 / K6 / K7 (``fns`` = (kernel, plain, bytes read, note,
    q flags)) against its plain version: bit-for-bit equal, then timed
    (plain, kernel, kernel, plain) with the bound.  Returns a dict."""
    from rust_pathtracer_tpu_torch.ops.projected import COOP_P

    kernel, plain, read_bytes, note, q_flags = fns
    got = kernel()
    stats = {}
    want = plain(stats)
    _sync(torch, device)
    bad = sum(int((a != b).reshape(a.shape[0], -1).any(dim=1).sum())
              for a, b in zip(got, want))
    err = max(float(torch.where(a == b, 0.0, (a.double() - b.double()).abs()).max())
              for a, b in zip(got, want))
    hits = int((want[1] >= 0).sum())
    swept = sum(stats.get("swept", []))
    ms = time_pair(torch, device, kernel, plain, reps, PLAIN_REPS)
    k_ms, p_ms = statistics.mean(ms["kernel"]), statistics.mean(ms["plain"])
    b_ms, b_by = proj_bound(tables, n_lanes, stats, read_bytes, q_flags)
    per_visit, below = lanes_per_visit(stats)
    log(f"{label} ({note}) on {n_lanes} lanes, {card}: {hits} hits, {bad} lanes differ "
        f"from the plain version; slab tests {stats.get('slab_tests', 0) / n_lanes:.3f} "
        f"a lane, clusters swept {swept / n_lanes:.3f} a lane, {per_visit:.2f} lanes a "
        f"warp visit ({below:.3f} of visits under {COOP_P}); {k_ms:.4f} ms per launch "
        f"(blocks of {reps}: {[round(x, 4) for x in ms['kernel']]}); plain {p_ms:.2f} ms "
        f"({[round(x, 2) for x in ms['plain']]}); bound "
        f"{b_ms:.4f} ms ({b_by})")
    check(bad == 0, f"{label}: t, column or payload differ from the plain version "
                    f"on {bad} lanes")
    return dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by, max_abs_err=err,
                lanes_per_visit=per_visit)


def time_routes(torch, device, card, label, tables, o, d, routes, reps):
    """The forward route's whole search on the same lanes, by route: K6
    ("resident") or the worklist build and K7 ("pairs") against K5 alone
    ("dense"), bit for bit equal on a one-p-block table (streamed tables:
    K5 may compare a sphere cluster in t where K7 does in q).  CUDA
    events; outside the paths' counted runs.  Returns {route: ms a call}."""
    from rust_pathtracer_tpu_torch.integrator import T_MIN
    from rust_pathtracer_tpu_torch.ops.projected import closest_hit_routed

    outs = {r: closest_hit_routed(tables, o, d, T_MIN, r) for r in routes}
    same = all(torch.equal(a, b) for r in routes[1:]
               for a, b in zip(outs[routes[0]], outs[r]))
    ms = {r: statistics.mean(_time_ms(torch, device,
                                      lambda r=r: closest_hit_routed(tables, o, d, T_MIN, r),
                                      reps) for _ in range(2))
          for r in routes}
    log(f"{label}, the search by route on {o.shape[0]} lanes, {card}: "
        + ", ".join(f"{r} {ms[r]:.4f} ms" for r in routes)
        + f" a call (two blocks of {reps}); results equal: {same}")
    if tables.col_block == tables.num_cols:
        check(same, f"{label}: the routes' results differ")
    return ms


def phase_projected_vs_plain(torch, device, card, scenes, reps):
    log(f"== phase 14: K5, K6 and K7 vs plain on {BIG_LANES} lanes of three tables")
    out = {}
    for name, cfg in (("ModelTest", MT), ("SphereField", SF), ("ModelTest 20k", MT)):
        sd, scene = scenes[name]
        o, d = big_lanes(torch, device, name, sd, cfg, BIG_LANES)
        passes = _slab_passes(torch, scene.proj, o, d)
        log(f"{name}: {o.shape[0]} lanes ({cfg['width']}x{cfg['height']}x{cfg['spp']} "
            f"first bounce, the rest random in the scene box, a tenth of those parked); "
            f"a lane's slab test passes {passes:.3f} of "
            f"{sum(k != -1 for k in scene.proj.group_kinds)} clusters on average")
        for kname, fns in _sweep_fns(torch, scene.proj, o, d).items():
            out[(name, kname)] = time_sweep(torch, device, card, f"{kname} {name}", fns,
                                            scene.proj, o.shape[0], reps)
    return out


def phase_spherefield_forward(torch, device, card, scenes, reps):
    cfg = SF
    W, H, spp, nb = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"]
    lanes = W * H * spp
    log(f"== phase 15 (main path): SphereField forward {W}x{H}, {spp} spp, {nb} "
        f"bounces, one chunk of {lanes} lanes, the resident route (K6)")
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops.projected import default_route
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.image import image_agreement, to_rgb8, write_png

    sd, scene = scenes["SphereField"]
    check(default_route(scene.proj) == "resident", "SphereField left the K6 route")
    cam = sd.camera_at(0.0, device=device)
    key = prng_key(cfg["seed"], device=device)
    settings = RenderSettings(W, H, spp, nb, SF_BG)
    check(settings.resolve_chunk() == spp, "the frame is not one chunk")
    render_radiance(scene, cam, RenderSettings(64, 36, 1, 2, SF_BG), key, device=device)
    _sync(torch, device)
    reset_counts()
    t0 = time.perf_counter()
    img, stats = render_radiance(scene, cam, settings, key, device=device)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    counts = read_counts()
    img_np = img.cpu().numpy()
    segments = float(stats.segments)
    log(f"SphereField {W}x{H} spp={spp} bounces={nb} on {card}: wall {wall:.3f} s, "
        f"segments {segments:.0f}, segments/s {segments / wall:.4e}, mean depth "
        f"{segments / lanes:.4f}, bounces {stats.bounces}, launches {counts}, image "
        f"mean {img_np.mean():.6f}")
    check(np.isfinite(img_np).all() and (img_np >= 0).all(),
          "the SphereField frame has non-finite or negative pixels")
    check(counts["K6"] == counts["draws"] == counts["shade"] == stats.bounces > 0,
          f"K6, the draw kernel and the shade kernel launched {counts['K6']}, "
          f"{counts['draws']} and {counts['shade']} times in {stats.bounces} bounces")
    check(all(counts[k] == 0 for k in ("K1", "K1-res", "K2", "K3", "K4", "K5", "K7")),
          "the SphereField forward left the resident route")
    img2, _ = render_radiance(scene, cam, settings, key, device=device)
    check(torch.equal(img, img2), "the SphereField frame twice differs")
    log("rendered twice: bitwise equal")
    png = os.path.join(OUT_DIR, f"SphereField_{W}x{H}_{spp}spp.png")
    write_png(png, to_rgb8(img_np))
    log(f"wrote {png}")

    gw, gh, gspp, gnb = 64, 36, 8, 8  # tests/golden_utils.py GOLDEN_CONFIGS
    gs = RenderSettings(gw, gh, gspp, gnb, SF_BG, spp_chunk=gspp)
    imgs = [render_radiance(get_scene("SphereField").build(device=dev),
                            sd.camera_at(0.0, device=dev), gs,
                            prng_key(GOLDEN_SEED, device=dev), device=dev)[0].cpu().numpy()
            for dev in (device, "cpu")]
    for label, ref in (("golden", np.load(_golden_path("SphereField"))), ("CPU", imgs[1])):
        a = image_agreement(imgs[0], ref)
        log(f"SphereField {gw}x{gh} spp={gspp} bounces={gnb}, card vs {label}: mean rel "
            f"{a['mean_rel']:.2e}, pixels close {a['frac_close']:.4f}, nan {a['has_nan']}")
        check(a["ok"], f"the card's SphereField breaks the image contract against the {label}")

    # K6 and K5 at the main paths' shape: the frame's first bounce
    o, d = _first_bounce(torch, device, cam, key, cfg)
    fns = _sweep_fns(torch, scene.proj, o, d)
    k6 = time_sweep(torch, device, card, "K6 SphereField first bounce", fns["K6"],
                    scene.proj, lanes, reps)
    k5 = time_sweep(torch, device, card, "K5 SphereField first bounce", fns["K5"],
                    scene.proj, lanes, reps)
    time_routes(torch, device, card, "SphereField first bounce", scene.proj, o, d,
                ("resident", "dense"), reps)
    # K6 and K5 on the lanes of the frame's second bounce (incoherent, dead
    # lanes parked)
    _, _, o2, d2 = path_lanes(torch, device, scene, sd, cfg, SF_BG, lambda b, k: b == 1)
    label = "SphereField bounce 2"
    fns = _sweep_fns(torch, scene.proj, o2, d2)
    for name, out in (("K6", k6), ("K5", k5)):
        out["later"] = [dict(time_sweep(torch, device, card, f"{name} {label}", fns[name],
                                        scene.proj, lanes, reps), lanes=label)]
    return dict(k6, launches=counts["K6"]), k5, counts["shade"]


def phase_modeltest_forward(torch, device, card, scenes, reps):
    cfg = MT
    W, H, spp, nb = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"]
    lanes = W * H * spp
    log(f"== phase 16: ModelTest forward {W}x{H}, {spp} spp, {nb} bounces, {lanes} "
        f"lanes: the 10,080-triangle mesh (K6), the 20,000-triangle one (K7, K5)")
    from rust_pathtracer_tpu_torch.ops.projected import default_route
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.image import to_rgb8, write_png

    settings = RenderSettings(W, H, spp, nb, (1.0, 1.0, 1.0))
    out = {}
    for name, route, kernel in (("ModelTest", "resident", "K6"),
                                ("ModelTest 20k", "pairs", "K7")):
        sd, scene = scenes[name]
        check(default_route(scene.proj) == route, f"{name} left the {route} route")
        cam = sd.camera_at(0.0, device=device)
        key = prng_key(cfg["seed"], device=device)
        _sync(torch, device)
        reset_counts()
        t0 = time.perf_counter()
        img, stats = render_radiance(scene, cam, settings, key, device=device)
        _sync(torch, device)
        wall = time.perf_counter() - t0
        counts = read_counts()
        img_np = img.cpu().numpy()
        segments = float(stats.segments)
        log(f"{name} {W}x{H} spp={spp} bounces={nb} on {card}: wall {wall:.3f} s, "
            f"segments {segments:.0f}, segments/s {segments / wall:.4e}, bounces "
            f"{stats.bounces}, launches {counts}, image mean {img_np.mean():.6f}")
        check(np.isfinite(img_np).all() and (img_np >= 0).all(),
              f"{name} has non-finite or negative pixels")
        if kernel == "K6":
            check(counts["K6"] == stats.bounces > 0 and counts["K5"] == counts["K7"] == 0,
                  f"{name}: K6 launched {counts['K6']} times in {stats.bounces} bounces")
        else:
            check(counts["K7"] >= 1, f"{name}: K7 launched no time")
            check(counts["K7"] + counts["K5"] == stats.bounces and counts["K6"] == 0,
                  f"{name}: K7 {counts['K7']} + K5 fallback {counts['K5']} "
                  f"launches in {stats.bounces} bounces")
        check(counts["draws"] == counts["shade"] == stats.bounces,
              f"{name}: the draw kernel and the shade kernel launched {counts['draws']} "
              f"and {counts['shade']} times in {stats.bounces} bounces")
        write_png(os.path.join(OUT_DIR, f"{name.replace(' ', '_')}_{W}x{H}.png"),
                  to_rgb8(img_np))
        out[name] = counts

    # K7 at its path's shape: the 20k mesh's first bounce (no block
    # overflows); each mesh's search by route there
    for name, route in (("ModelTest", "resident"), ("ModelTest 20k", "pairs")):
        sd, scene = scenes[name]
        o, d = _first_bounce(torch, device, sd.camera_at(0.0, device=device),
                             prng_key(cfg["seed"], device=device), cfg)
        time_routes(torch, device, card, f"{name} first bounce", scene.proj, o, d,
                    (route, "dense"), reps)
        if name == "ModelTest":  # K6 on the lanes the 10k frame hands it at bounce 2
            _, _, o2, d2 = path_lanes(torch, device, scene, sd, cfg, (1.0, 1.0, 1.0),
                                      lambda b, k: b == 1)
            label = "ModelTest bounce 2"
            k6_later = [dict(time_sweep(
                torch, device, card, f"K6 {label}",
                _sweep_fns(torch, scene.proj, o2, d2)["K6"], scene.proj, lanes, reps),
                lanes=label)]
    fns = _sweep_fns(torch, scene.proj, o, d)
    k7 = time_sweep(torch, device, card, "K7 ModelTest 20k first bounce", fns["K7"],
                    scene.proj, lanes, reps)
    # the kernel the path runs at the frame's second bounce (K5 where a
    # block passes more than WL_KCAP clusters, K7's fallback), and K7 at the
    # first later bounce the path hands it
    later = {"K5": [], "K7": []}
    for want in (lambda b, k: b == 1, lambda b, k: b >= 1 and k == "K7"):
        b, kname, o2, d2 = path_lanes(torch, device, scene, sd, cfg, (1.0, 1.0, 1.0),
                                      want)
        label = f"ModelTest 20k bounce {b + 1}" + (" (K7's fallback)" if kname == "K5"
                                                   else "")
        if any(x["lanes"] == label for x in later[kname]):
            continue
        later[kname].append(dict(time_sweep(
            torch, device, card, f"{kname} {label}", _sweep_fns(torch, scene.proj, o2,
                                                                d2)[kname],
            scene.proj, lanes, reps), lanes=label))
    return (dict(k7, launches=out["ModelTest 20k"]["K7"],
                 fallbacks=out["ModelTest 20k"]["K5"], later=later["K7"]), later["K5"],
            k6_later)


def phase_spherefield_step(torch, device, card):
    cfg = SF
    W, H, spp, nb = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"]
    lanes = W * H * spp
    log(f"== phase 17: differentiable SphereField step {W}x{H}, {spp} spp, {nb} "
        f"bounces, one chunk of {lanes} lanes, loss = mean(img), K5 the search")
    from rust_pathtracer_tpu_torch.integrator import resolve_remat_mode
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import RenderSettings, _make_lanes
    from rust_pathtracer_tpu_torch.sampling import prng_key

    scene = get_scene("SphereField").build(device=device)
    settings = RenderSettings(W, H, spp, nb, SF_BG, differentiable=True)
    check(settings.resolve_chunk() == spp, "the frame is not one chunk")
    mode = resolve_remat_mode(settings.remat, lanes, nb)
    key = prng_key(cfg["seed"], device=device)
    leaves = _diff_leaves(torch, scene, SF_CAM, SF_BG, device)

    def forward():
        return _diff_forward(scene, leaves, settings, key, device)

    def step():
        _zero_grads(leaves)
        loss, stats = forward()
        loss.backward()
        return loss, stats

    t0 = time.perf_counter()
    loss0, _ = step()  # warm-up, and the first of two steps on one key
    _sync(torch, device)
    log(f"first step {time.perf_counter() - t0:.3f} s (remat {mode!r})")
    grads0 = _leaf_grads(leaves)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    reset_counts()
    loss, stats = step()
    _sync(torch, device)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    grads = _leaf_grads(leaves)
    segments = float(stats.segments)
    log(f"one step: loss {float(loss.detach()):.7f}, segments {segments:.0f} (mean depth "
        f"{segments / lanes:.4f}), launches {counts}, peak memory {peak / 1e9:.3f} GB "
        f"({(peak - base) / 1e9:.3f} GB above the {base / 1e9:.3f} GB before the step: "
        f"{(peak - base) / (lanes * nb):.1f} B a lane-bounce)")
    log("gradients: " + _grad_sums(grads))
    check(counts["K5"] == counts["draws"] == nb,
          f"K5 and the draw kernel launched {counts['K5']} and {counts['draws']} times, "
          f"want {nb}")
    check(all(counts[k] == 0 for k in ("K1", "K1-res", "K2", "K3", "K4", "K6", "K7",
                                       "shade")),
          "the SphereField step left its route")
    check(all(np.isfinite(g).all() for g in grads), "non-finite gradients")
    check(np.abs(grads[0]).sum() > 0, "tex_color's gradient is zero")
    check(np.abs(grads[2]).min() > 0, "a background gradient is zero")
    same = (float(loss0.detach()) == float(loss.detach())
            and all(np.array_equal(a, b) for a, b in zip(grads0, grads)))
    log(f"two steps on one key: loss and gradients bitwise equal: {same}")
    check(same, "two SphereField steps on one key differ")

    med, spread, times = _batch_median(step, leaves, MAIN_STEP)
    log(f"SphereField step on {card}: median {med * 1e3:.2f} ms over {len(times)} "
        f"batches of {MAIN_STEP['reps']} (spread {spread:.3f}; batches "
        f"{[round(t * 1e3, 2) for t in times]} ms), segments/s {segments / med:.4e}")
    from rust_pathtracer_tpu_torch.grad import DiffParams

    cam = DiffParams.from_leaves(leaves).camera.build()
    pix = torch.arange(W * H, dtype=torch.int64, device=device)

    def lanes_fn():
        return _make_lanes(cam, key, pix, 0, width=W, height=H, spp_chunk=spp,
                           spp_total=spp)

    split = _step_split(torch, leaves, forward, lanes_fn)
    log(f"step split on {card} (CUDA events, median of 3): forward "
        f"{split['forward']:.2f} ms = lanes {split['lanes']:.2f} + bounce loop (the "
        f"draw kernel included) and the rest {split['loop']:.2f}; "
        f"backward {split['backward']:.2f} ms")
    return counts["K5"]


# ---------------------------------------------------------------------------
# phases 19-24: the regen wavefront (K1 at per-lane depth, the draw kernel)
# ---------------------------------------------------------------------------

# phase 21 (main path): LightTest at its own 854x480 and 50 bounces, spp cut
# from 2000 to 16 (6,558,720 paths through the default pool of 2**20 lanes)
REGEN = dict(width=854, height=480, spp=16, bounces=50, seed=0)
# phase 22: SphereField at its own width, spp cut from 250 to 8
SF_REGEN = dict(width=854, height=480, spp=8, bounces=20, seed=0)
# phases 19-20: random depths 0-49 (LightTest's 50 bounces), roulette from 3
REGEN_DEPTHS, REGEN_RR_START = 50, 3
DRAWS_SCALAR, DRAWS_PER_LANE = "bounce 7", f"per-lane depths 0-{REGEN_DEPTHS - 1}"
# wavefront.FLUSH_EVERY: bounces a window.  On the card in queue mode the
# host reads a window's counts one window late, so the frame runs one
# window over the all-dead pool after the deciding one, which its
# TraceStats.bounces leaves out
FLUSH_EVERY = 2


def regen_window_end_launches(stats):
    """The window-end kernels' launches in a regen frame on the card in
    queue mode: three a window end, the window after the deciding one
    included."""
    return 3 * (stats.bounces // FLUSH_EVERY + 1)


def phase_k1_per_lane(torch, device, card, n_lanes, reps):
    log(f"== phase 19: K1 at per-lane depth vs its plain version on {n_lanes} lanes "
        f"(phase 3's), random depths 0-{REGEN_DEPTHS - 1}, roulette from depth "
        f"{REGEN_RR_START}, bit for bit")
    from rust_pathtracer_tpu_torch.integrator import T_MIN
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb

    cols_np, keys_np = random_lanes(n_lanes)
    depth = torch.as_tensor(np.random.default_rng(19).integers(
        0, REGEN_DEPTHS, n_lanes).astype(np.int32), device=device)
    scene = full_scene(device)
    state, keys = _keyed_on(torch, cols_np, keys_np, device)
    args = (fb.pack_prims_shaded(scene), torch.tensor((0.2, 0.1, 0.05), device=device),
            scene.textures.perlin_seed, state, keys, depth)
    kw = dict(with_roulette=True, rr_start=REGEN_RR_START, kinds=scene.kinds_static,
              mat_types=scene.mat_types, tex_types=scene.tex_types, t_min=T_MIN)
    runs = _keyed_runs(torch, args, kw)
    _sync(torch, device)
    bad = _keyed_mismatches(runs)
    k_out, k_win, _ = runs["kernel"]
    err = float(np.abs(k_out.view(np.float32).astype(np.float64)
                       - runs["plain"][0].view(np.float32)).max())
    alive_in = cols_np[12] > 0.5
    rr_lanes = alive_in & (k_win >= 0) & (depth.cpu().numpy() >= REGEN_RR_START)
    log(f"lanes differing from the plain version {int(bad.sum())} (13 columns and "
        f"winners); hits {int((k_win >= 0).sum())}, alive out "
        f"{int((k_out[12].view(np.float32) > 0.5).sum())}, hit lanes at depth >= "
        f"{REGEN_RR_START} {int(rr_lanes.sum())}")
    for i in np.nonzero(bad)[0][:5]:
        log(f"  lane {i}: kernel {runs['kernel'][0][:, i].view(np.float32).tolist()}; "
            f"plain {runs['plain'][0][:, i].view(np.float32).tolist()}")
    check(not bad.any(), "K1 at per-lane depth differs from its plain version")

    def k1():
        return fb.fused_bounce_keyed(*args, **kw)

    def plain():
        return fb.fused_bounce_keyed_plain(*args, **kw)

    def k1_scalar():  # the same lanes at one bounce, roulette on all of them
        return fb.fused_bounce_keyed(*args[:5], 7, **kw)

    res = time_pair(torch, device, k1, plain, reps, PLAIN_REPS)
    k_ms, p_ms = statistics.mean(res["kernel"]), statistics.mean(res["plain"])
    dev_ms, held = _device_ms(torch, k1, reps, ("fused_bounce_kernel",))
    scalar = time_pair(torch, device, k1_scalar, k1, reps)
    s_dev, s_held = _device_ms(torch, k1_scalar, reps, ("fused_bounce_kernel",))
    host = []  # the wrapper's host time a call: the launch returns at once
    for _ in range(7):
        _sync(torch, device)
        t0 = time.perf_counter()
        k1()
        host.append((time.perf_counter() - t0) * 1e3)
    _sync(torch, device)
    b_ms, b_by = k1_bound(torch, args, kw, residual_planes=0)
    log(f"K1 at per-lane depth, {n_lanes} lanes on {card}: {k_ms:.4f} ms per launch "
        f"(blocks {[round(x, 4) for x in res['kernel']]}; events around the wrapper), "
        f"{dev_ms:.4f} ms device time (profiler, {held} of {reps} launches); plain "
        f"version on the same CUDA tensors {p_ms:.4f} ms "
        f"({[round(x, 4) for x in res['plain']]}); bound {b_ms:.4f} ms ({b_by}); the "
        f"same lanes at bounce 7 (scalar, per-lane, per-lane, scalar): "
        f"{[round(x, 4) for x in scalar['kernel']]} / "
        f"{[round(x, 4) for x in scalar['plain']]} ms, {s_dev:.4f} ms device time "
        f"({s_held} of {reps}); the wrapper's host time {statistics.median(host):.4f} ms "
        f"a call (median of 7)")
    return dict(max_abs_err=err, ms=k_ms, device_ms=(dev_ms, held, reps), plain_ms=p_ms,
                bound_ms=b_ms, bound_by=b_by)


def draws_bound(torch, keys, bounce, rows, packed=False):
    """The draw kernel's bound: bytes, the two key words and a per-lane
    depth read once and ``rows`` f32 planes written once; operations,
    threefry's int32 ones: under the legacy scheme a purpose key and a
    block a uniform for 2 sphere, 3 ball, 1 coin and, in a seventh row, 1
    roulette uniform; under the packed scheme a block a word pair, 3
    blocks for the six rows and a fourth for roulette's."""
    from rust_pathtracer_tpu_torch.ops import draws

    R = keys.shape[1]
    rr = rows > draws.N_ROWS
    n_bytes = (nbytes(keys) + (nbytes(bounce) if isinstance(bounce, torch.Tensor) else 0)
               + rows * 4 * R)
    if packed:
        n_int = R * packed_ops(3 + rr, rows)
    else:
        n_int = R * (draw_ops(2) + draw_ops(3) + draw_ops(1) + (draw_ops(1) if rr else 0))
    return bound(n_bytes, 0, n_int)


def _draws_mismatches(torch, device, got, want):
    """(lanes where any plane of the draw kernel's ``got`` differs in a
    bit from the plain version's ``want``, the largest absolute
    difference); a plane that is None in both (no roulette) is skipped."""
    _sync(torch, device)
    n = want[0].shape[0]
    bad, err = np.zeros(n, dtype=bool), 0.0
    for g, w in zip(got, want):
        check((g is None) == (w is None), "the draw kernel and its plain version "
              "disagree on the roulette plane")
        if w is None:
            continue
        g = g.contiguous().cpu().numpy().reshape(n, -1)
        w = w.contiguous().cpu().numpy().reshape(n, -1)
        bad |= (g.view(np.int32) != w.view(np.int32)).any(axis=1)
        err = max(err, float(np.abs(g.astype(np.float64) - w).max()))
    return bad, err


def phase_draws_vs_plain(torch, device, card, n_lanes, reps):
    log(f"== phase 20: the draw kernel vs sampling.bounce_draws on {n_lanes} random "
        f"keys, bit for bit")
    from rust_pathtracer_tpu_torch.ops import draws
    from rust_pathtracer_tpu_torch.ops.fused_bounce import key_words

    rng = np.random.default_rng(20)
    keys = key_words(torch.as_tensor(rng.integers(0, 2**32, (n_lanes, 2), dtype=np.int64),
                                     device=device))
    depth = torch.as_tensor(rng.integers(0, REGEN_DEPTHS, n_lanes).astype(np.int32),
                            device=device)
    out = {}
    for label, bounce in ((DRAWS_SCALAR, 7), (DRAWS_PER_LANE, depth)):
        def kernel(b=bounce):
            return draws.bounce_draws(keys, b, True)

        def plain(b=bounce):
            return draws.bounce_draws_plain(keys, b, True)

        bad, err = _draws_mismatches(torch, device, kernel(), plain())
        log(f"{label}: lanes differing from the plain version {int(bad.sum())} "
            f"(sphere_u, ball_u, coin, roulette), max abs difference {err:.3e}")
        check(not bad.any(), f"the draw kernel differs from its plain version ({label})")
        res = time_pair(torch, device, kernel, plain, reps, PLAIN_REPS)
        k_ms, p_ms = statistics.mean(res["kernel"]), statistics.mean(res["plain"])
        dev_ms, held = _device_ms(torch, kernel, reps, ("bounce_draws_kernel",))
        b_ms, b_by = draws_bound(torch, keys, bounce, draws.N_ROWS + 1)
        log(f"draw kernel, {label}, {n_lanes} lanes on {card}: {k_ms:.4f} ms per launch "
            f"(blocks {[round(x, 4) for x in res['kernel']]}; events), {dev_ms:.4f} ms "
            f"device time ({held} of {reps} launches); plain version on the same CUDA "
            f"tensors {p_ms:.4f} ms ({[round(x, 4) for x in res['plain']]}); bound "
            f"{b_ms:.4f} ms ({b_by})")
        out[label] = dict(max_abs_err=err, ms=k_ms, device_ms=(dev_ms, held, reps),
                          plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
    return out


@contextlib.contextmanager
def capture_calls(torch, name, at):
    """Wraps ``wavefront.<name>`` (the regen bounce's K1 or draw kernel)
    so that its calls numbered ``at`` (from 0) keep clones of their
    tensor arguments: yields {call: (args, kwargs)}, filled as the render
    runs.  The pool's rows are updated in place later, hence the clones."""
    from rust_pathtracer_tpu_torch import wavefront

    fn, calls, seen = getattr(wavefront, name), {}, [0]

    def wrapped(*a, **k):
        if seen[0] in at:
            calls[seen[0]] = (tuple(x.clone() if isinstance(x, torch.Tensor) else x
                                    for x in a), dict(k))
        seen[0] += 1
        return fn(*a, **k)

    setattr(wavefront, name, wrapped)
    try:
        yield calls
    finally:
        setattr(wavefront, name, fn)


def _pool_depths(depth, alive):
    """A log line on a captured pool's live lanes and their depths."""
    d = depth.cpu().numpy()[alive.cpu().numpy()]
    if d.size == 0:
        return "no live lane"
    return (f"{d.size} live lanes at depths {int(d.min())}-{int(d.max())} "
            f"({np.unique(d).size} distinct, mean {d.mean():.3f})")


def check_regen_vs_chunked(torch, name, img, stats, cimg, cstats):
    """The regen and chunked renderers trace the same paths with the same
    draws: JAX's regen-vs-chunked bounds on the image (mean abs < 1e-5,
    max abs < 5e-3), the same segments and the same occupancy."""
    diff = np.abs(img.cpu().numpy().astype(np.float64) - cimg.cpu().numpy())
    seg, cseg = float(stats.segments), float(cstats.segments)
    occ, cocc = stats.occupancy.cpu(), cstats.occupancy.cpu()
    log(f"regen vs chunked: mean abs {diff.mean():.3e}, max abs {diff.max():.3e}, "
        f"segments {seg:.0f} vs {cseg:.0f}, occupancy differs at "
        f"{int((occ != cocc).sum())} bounces")
    check(diff.mean() < 1e-5 and diff.max() < 5e-3,
          f"the {name} regen image is further from chunked than JAX's bounds")
    check(seg == cseg, f"the {name} regen traced {seg:.0f} segments, chunked {cseg:.0f}")
    check(torch.equal(occ, cocc), f"the {name} regen occupancy differs from chunked")
    return float(diff.max())


@contextlib.contextmanager
def regen_events(torch):
    """CUDA events around the regen renderer's bounce, camera-lane spawn
    and window end (``wavefront._bounce``, ``_spawn``, and
    ``_window_end_device`` on the card in queue mode, ``_flush_refill``
    elsewhere): yields {part: [(start, end), ...]}."""
    from rust_pathtracer_tpu_torch import wavefront

    names = {"bounce": "_bounce", "spawn": "_spawn", "flush": "_flush_refill",
             "flush_device": "_window_end_device"}
    saved = {k: getattr(wavefront, v) for k, v in names.items()}
    spans = {k: [] for k in names}

    def timed(part, fn):
        def run(*a, **k):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = fn(*a, **k)
            e.record()
            spans[part].append((s, e))
            return out
        return run

    for k, v in names.items():
        setattr(wavefront, v, timed(k, saved[k]))
    try:
        yield spans
    finally:
        for k, v in names.items():
            setattr(wavefront, v, saved[k])


def regen_split(torch, spans):
    """ms by part: the bounces, the spawns (the first fill and, where the
    tensor ops end a window, the refills), and the window ends less the
    refills' spawns (on the card in queue mode the kernels, which
    respawn in place, and the read of the window before)."""
    torch.cuda.synchronize()
    ms = {k: [s.elapsed_time(e) for s, e in v] for k, v in spans.items()}
    flush = ms["flush"] + ms["flush_device"]
    return {"bounce": sum(ms["bounce"]), "spawn": sum(ms["spawn"]),
            "flush": sum(flush) - sum(ms["spawn"][1:]), "windows": len(flush)}


def idle_share(torch, fn, cuda_only=False):
    """One profiled call of ``fn``: (profiled wall ms, device busy ms, idle
    share 1 - busy / wall; an upper bound, the profiler slows the host).
    ``cuda_only`` traces the device alone, which slows the host less and
    reads back in a fraction of the time."""
    from torch.profiler import ProfilerActivity, profile

    from profile_port import busy_ms

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([] if cuda_only else [ProfilerActivity.CPU])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    busy = busy_ms(prof.events())
    return wall, busy, 1 - busy / wall


def _timed_render(torch, device, fn):
    """(wall s, result, launches) of one render, counts reset before."""
    _sync(torch, device)
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    _sync(torch, device)
    return time.perf_counter() - t0, out, read_counts()


def phase_regen_light(torch, device, card):
    cfg = REGEN
    W, H, spp, nb = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"]
    paths = W * H * spp
    log(f"== phase 21 (main path): LightTest regen {W}x{H}, {spp} spp, {nb} bounces "
        f"({paths} paths through a pool of {min(paths, 1 << 20)} lanes), K1 at per-lane "
        f"depth; against the chunked render of the same key")
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.image import image_agreement, to_rgb8, write_png
    from rust_pathtracer_tpu_torch import wavefront
    from rust_pathtracer_tpu_torch.wavefront import render_radiance_regen

    check(wavefront.FLUSH_EVERY == FLUSH_EVERY,
          f"wavefront.FLUSH_EVERY is {wavefront.FLUSH_EVERY}, the smoke's {FLUSH_EVERY}")
    sd = get_scene("LightTest")
    scene = sd.build(device=device)
    cam = sd.camera_at(0.0, device=device)
    key = prng_key(cfg["seed"], device=device)
    bg = sd.output.image.background
    settings = RenderSettings(W, H, spp, nb, bg)
    render_radiance_regen(scene, cam, RenderSettings(64, 36, 2, 4, bg), key, device=device)

    def regen():
        return render_radiance_regen(scene, cam, settings, key, device=device)

    wall, (img, stats), counts = _timed_render(torch, device, regen)
    img_np = img.cpu().numpy()
    seg = float(stats.segments)
    windows = stats.bounces // 2
    log(f"regen on {card}: wall {wall:.3f} s, segments {seg:.0f}, segments/s "
        f"{seg / wall:.4e}, bounce iterations {stats.bounces} ({windows} windows of 2), "
        f"launches {counts}, image mean {img_np.mean():.6f}")
    check(np.isfinite(img_np).all() and (img_np >= 0).all(),
          "the LightTest regen image has non-finite or negative pixels")
    check(counts["K1"] == stats.bounces + FLUSH_EVERY and stats.bounces > 0,
          f"K1 launched {counts['K1']} times in {stats.bounces} bounce iterations and "
          f"the window after")
    check(counts["window_end"] == regen_window_end_launches(stats),
          f"the window-end kernels launched {counts['window_end']} times in "
          f"{stats.bounces // FLUSH_EVERY} windows and the one after")
    check(counts["lanes"] > 0, "the LightTest regen spawned without the lanes kernel")
    check(all(counts[k] == 0 for k in ("K1-res", "K2", "K3", "K4", "K5", "K6", "K7",
                                       "draws")),
          "the LightTest regen left the fused route")
    check(float(stats.occupancy[0]) == paths and float(stats.occupancy.sum()) == seg,
          "the regen occupancy is not every path at bounce 0, or does not sum to the "
          "segments")
    at = sorted({5, stats.bounces // 2, stats.bounces - 1})  # a full pool, the tail
    with capture_calls(torch, "fused_bounce_keyed", at) as calls:
        img2, _ = regen()
    check(torch.equal(img, img2), "the LightTest regen image twice differs")
    log("regen rendered twice: bitwise equal")
    err = 0.0
    for i in at:  # K1 against its plain version on the pool the render gave it
        check(i in calls, f"bounce iteration {i} of the second render was not captured")
        args, kw = calls[i]
        runs = _keyed_runs(torch, args, kw)
        _sync(torch, device)
        bad = _keyed_mismatches(runs)
        err = max(err, float(np.abs(runs["kernel"][0].view(np.float32).astype(np.float64)
                                    - runs["plain"][0].view(np.float32)).max()))
        log(f"bounce iteration {i}: pool of {args[3].shape[1]} lanes, "
            f"{_pool_depths(args[5], args[3][12] > 0.5)}; lanes where K1 differs from "
            f"its plain version {int(bad.sum())} (13 columns and winners)")
        check(not bad.any(), f"K1 at per-lane depth differs from its plain version on "
                             f"the pool of bounce iteration {i}")
    with regen_events(torch) as spans:
        regen()
    split = regen_split(torch, spans)
    log(f"regen split by CUDA events: bounces {split['bounce']:.2f} ms, spawns "
        f"{split['spawn']:.2f} ms, window ends less their spawns {split['flush']:.2f} ms "
        f"({split['windows']} windows)")
    pwall, busy, idle = idle_share(torch, regen)
    log(f"regen profiled: wall {pwall:.2f} ms, device busy {busy:.2f} ms, idle share "
        f"{idle:.4f}")

    cwall, (cimg, cstats), ccounts = _timed_render(
        torch, device, lambda: render_radiance(scene, cam, settings, key, device=device))
    cimg_np = cimg.cpu().numpy()
    cseg = float(cstats.segments)
    chunk = settings.resolve_chunk()
    log(f"chunked on {card}: wall {cwall:.3f} s, segments {cseg:.0f}, segments/s "
        f"{cseg / cwall:.4e}, {-(-spp // chunk)} chunks of {W * H * chunk} lanes, "
        f"bounces {cstats.bounces}, launches {ccounts}, image mean {cimg_np.mean():.6f}")
    cpwall, cbusy, cidle = idle_share(
        torch, lambda: render_radiance(scene, cam, settings, key, device=device))
    log(f"chunked profiled: wall {cpwall:.2f} ms, device busy {cbusy:.2f} ms, idle "
        f"share {cidle:.4f}")
    a = image_agreement(img_np, cimg_np)
    log(f"regen vs chunked: mean rel {a['mean_rel']:.2e}, pixels close "
        f"{a['frac_close']:.4f}")
    check(a["ok"], "the LightTest regen breaks the image contract against chunked")
    max_diff = check_regen_vs_chunked(torch, "LightTest", img, stats, cimg, cstats)
    os.makedirs(OUT_DIR, exist_ok=True)
    png = os.path.join(OUT_DIR, f"LightTest_regen_{W}x{H}_{spp}spp.png")
    write_png(png, to_rgb8(img_np))
    log(f"wrote {png}")
    return dict(k1_launches=counts["K1"], max_abs_err=err, vs_chunked=max_diff,
                lanes_launches=counts["lanes"], split=split, wall=wall,
                window_end_launches=counts["window_end"])


def phase_regen_spherefield(torch, device, card, scenes):
    cfg = SF_REGEN
    W, H, spp, nb = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"]
    paths = W * H * spp
    log(f"== phase 22: SphereField regen {W}x{H}, {spp} spp, {nb} bounces ({paths} "
        f"paths through a pool of {min(paths, 1 << 20)} lanes): K6 and the draw kernel "
        f"at per-lane depth; against the chunked render of the same key")
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.image import image_agreement
    from rust_pathtracer_tpu_torch.wavefront import render_radiance_regen

    sd, scene = scenes["SphereField"]
    cam = sd.camera_at(0.0, device=device)
    key = prng_key(cfg["seed"], device=device)
    settings = RenderSettings(W, H, spp, nb, SF_BG)
    render_radiance_regen(scene, cam, RenderSettings(64, 36, 2, 4, SF_BG), key,
                          device=device)

    def regen():
        return render_radiance_regen(scene, cam, settings, key, device=device)

    wall, (img, stats), counts = _timed_render(torch, device, regen)
    img_np = img.cpu().numpy()
    seg = float(stats.segments)
    log(f"regen on {card}: wall {wall:.3f} s, segments {seg:.0f}, segments/s "
        f"{seg / wall:.4e}, bounce iterations {stats.bounces}, launches {counts}, "
        f"image mean {img_np.mean():.6f}")
    check(np.isfinite(img_np).all() and (img_np >= 0).all(),
          "the SphereField regen image has non-finite or negative pixels")
    check(counts["K6"] == counts["draws"] == counts["shade"] == stats.bounces + FLUSH_EVERY
          and stats.bounces > 0,
          f"K6 {counts['K6']}, draw kernel {counts['draws']} and shade kernel "
          f"{counts['shade']} launches in {stats.bounces} bounce iterations and the window "
          f"after")
    check(counts["window_end"] == regen_window_end_launches(stats),
          f"the window-end kernels launched {counts['window_end']} times in "
          f"{stats.bounces // FLUSH_EVERY} windows and the one after")
    check(counts["lanes"] > 0, "the SphereField regen spawned without the lanes kernel")
    check(all(counts[k] == 0 for k in ("K1", "K1-res", "K2", "K3", "K4", "K5", "K7")),
          "the SphereField regen left the resident route")
    from rust_pathtracer_tpu_torch.ops import draws

    at = sorted({5, stats.bounces // 2, stats.bounces - 1})  # a full pool, the tail
    with capture_calls(torch, "bounce_draws", at) as calls:
        img2, _ = regen()
    check(torch.equal(img, img2), "the SphereField regen image twice differs")
    log("regen rendered twice: bitwise equal")
    err = 0.0
    for i in at:  # the draw kernel against its plain version on the render's pool
        check(i in calls, f"bounce iteration {i} of the second render was not captured")
        (keys, depth, with_roulette, *scheme), _ = calls[i]
        bad, e = _draws_mismatches(
            torch, device, draws.bounce_draws(keys, depth, with_roulette, *scheme),
            draws.bounce_draws_plain(keys, depth, with_roulette, *scheme))
        err = max(err, e)
        log(f"bounce iteration {i}: pool of {keys.shape[1]} lanes at depths "
            f"{int(depth.min())}-{int(depth.max())}; lanes where the draw kernel differs "
            f"from its plain version {int(bad.sum())}, max abs difference {e:.3e}")
        check(not bad.any(), f"the draw kernel differs from its plain version on the "
                             f"pool of bounce iteration {i}")
    with regen_events(torch) as spans:
        regen()
    split = regen_split(torch, spans)
    log(f"regen split by CUDA events: bounces {split['bounce']:.2f} ms, spawns "
        f"{split['spawn']:.2f} ms, window ends less their spawns {split['flush']:.2f} ms "
        f"({split['windows']} windows)")
    pwall, busy, idle = idle_share(torch, regen)
    log(f"regen profiled: wall {pwall:.2f} ms, device busy {busy:.2f} ms, idle share "
        f"{idle:.4f}")
    cwall, (cimg, cstats), ccounts = _timed_render(
        torch, device, lambda: render_radiance(scene, cam, settings, key, device=device))
    cimg_np = cimg.cpu().numpy()
    cseg = float(cstats.segments)
    log(f"chunked on {card}: wall {cwall:.3f} s, segments {cseg:.0f}, segments/s "
        f"{cseg / cwall:.4e}, bounces {cstats.bounces}, launches {ccounts}, image mean "
        f"{cimg_np.mean():.6f}")
    a = image_agreement(img_np, cimg_np)
    log(f"regen vs chunked: mean rel {a['mean_rel']:.2e}, pixels close "
        f"{a['frac_close']:.4f}")
    check(a["ok"], "the SphereField regen breaks the image contract against chunked")
    check_regen_vs_chunked(torch, "SphereField", img, stats, cimg, cstats)
    return dict(draws_launches=counts["draws"], max_abs_err=err,
                lanes_launches=counts["lanes"], split=split, wall=wall)


def phase_regen_card_vs_cpu(torch, device):
    log("== phase 23: 64x36 regen of LightTest (fused) and the image-textured scene "
        "(generic, K3) on the card against the CPU")
    from rust_pathtracer_tpu_torch.camera import make_camera
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import RenderSettings
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.image import image_agreement
    from rust_pathtracer_tpu_torch.wavefront import render_radiance_regen

    sd = get_scene("LightTest")
    cases = (("LightTest", sd.build, sd.camera_at(0.0), (0.0, 0.0, 0.0), 16),
             ("image scene", simple_scene,
              make_camera(*SIMPLE_CAM[:4], 64.0 / 36.0, *SIMPLE_CAM[5:]), SIMPLE_BG, 8))
    for name, build, cam, bg, nb in cases:
        s = RenderSettings(64, 36, 16, nb, bg, russian_roulette_start=3)
        imgs = {}
        for dev in (device, "cpu"):
            reset_counts()
            img, st = render_radiance_regen(build(device=dev), cam, s,
                                            prng_key(GOLDEN_SEED), lanes=4096, device=dev)
            imgs[dev] = img.cpu().numpy()
            if dev == device:
                counts = read_counts()
        a = image_agreement(imgs[device], imgs["cpu"])
        log(f"{name} 64x36 spp=16 bounces={nb}, roulette from 3, 4096 lanes: card vs "
            f"CPU mean rel {a['mean_rel']:.2e}, pixels close {a['frac_close']:.4f}, nan "
            f"{a['has_nan']}; launches on the card {counts}")
        check(a["ok"], f"the card's {name} regen breaks the image contract against the CPU")
        check(counts["K1"] > 0 if name == "LightTest" else counts["K3"] == counts["draws"] > 0,
              f"the {name} regen on the card left its route: {counts}")


def phase_sf_frame_hoisted(torch, device, card, scenes):
    cfg = SF
    W, H, spp, nb = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"]
    log(f"== phase 24: the chunked SphereField frame {W}x{H}, {spp} spp, {nb} bounces "
        f"with the draw kernel (and the reorder) against the same frame with the draws "
        f"hoisted in tensor ops (integrator._precompute_draws, the parent's route; no "
        f"reorder), bit for bit")
    from rust_pathtracer_tpu_torch import integrator
    from rust_pathtracer_tpu_torch.ops.fused_bounce import _lane_keys
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key

    sd, scene = scenes["SphereField"]
    cam = sd.camera_at(0.0, device=device)
    key = prng_key(cfg["seed"], device=device)
    settings = RenderSettings(W, H, spp, nb, SF_BG)
    table = {}

    def hoisted(keys, bounce, with_roulette, rng_scheme="legacy"):
        if bounce == 0:
            table.update(integrator._precompute_draws(_lane_keys(keys), nb, nb + 1))
        return table["sphere_u"][bounce], table["ball_u"][bounce], table["coin"][bounce], None

    walls = {"kernel": [], "hoisted": []}
    imgs = {}
    kernel_draws = integrator.bounce_draws
    # the hoisted draws are in the lanes' first order: that render runs
    # without the between-bounce reorder (the JAX package hoists only
    # without it); the draw kernel's takes the default routing, which
    # reorders SphereField
    unordered = dataclasses.replace(settings, reorder=False)
    for route in ("hoisted", "kernel", "kernel", "hoisted"):
        integrator.bounce_draws = hoisted if route == "hoisted" else kernel_draws
        try:
            wall, (img, stats), counts = _timed_render(
                torch, device, lambda: render_radiance(
                    scene, cam, unordered if route == "hoisted" else settings, key,
                    device=device))
        finally:
            integrator.bounce_draws = kernel_draws
        table.clear()
        walls[route].append(wall)
        imgs[route] = img
        check(counts["draws"] == (stats.bounces if route == "kernel" else 0),
              f"{route}: the draw kernel launched {counts['draws']} times")
    check(torch.equal(imgs["kernel"], imgs["hoisted"]),
          "the SphereField frame with the draw kernel differs from the hoisted draws")
    log(f"on {card}: with the draw kernel {[round(x, 4) for x in walls['kernel']]} s, "
        f"hoisted {[round(x, 4) for x in walls['hoisted']]} s (hoisted, kernel, kernel, "
        f"hoisted); images bitwise equal")


# ---------------------------------------------------------------------------
# the cascade renderer and checkpoints (phases 25-30)
# ---------------------------------------------------------------------------

CASCADE_SF = dict(width=854, height=480, spp=8, bounces=20, seed=0)
# explicit schedules with room: SphereField keeps 29% of its lanes alive
# at bounce 3, 10% at 5, 4% at 7; ModelTest 9% at 2, 4% at 3, 1% at 5
# (214x120 and 200x200 at 1 spp on the CPU)
CASCADE_SF_SCHEDULE = "3:2,5:4,7:16"
CASCADE_MT_SCHEDULE = "1:1,2:4,3:8,5:32"
CASCADE_TIGHT = "1:16"
CASCADE_KERNEL_FNS = ("fused_bounce_keyed", "bounce_draws", "closest_hit_record",
                      "closest_hit_routed", "shade_bounce")


def held_bounces(schedule):
    """The bounces right after a schedule's middle and last boundary (the
    dynamic cascade's one boundary where ``schedule`` is None)."""
    from rust_pathtracer_tpu_torch.render import CASCADE_B1, parse_cascade_schedule

    bs = [CASCADE_B1] if schedule is None else [b for b, _ in
                                                parse_cascade_schedule(schedule)]
    return sorted({bs[len(bs) // 2], bs[-1]})


def _clones(torch, x):
    """``x`` with every tensor in it (in tuples, lists and dicts) cloned."""
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, (tuple, list)):
        return type(x)(_clones(torch, v) for v in x)
    if isinstance(x, dict):
        return {k: _clones(torch, v) for k, v in x.items()}
    return x


@contextlib.contextmanager
def capture_bounces(torch, at):
    """Wraps the integrator's kernel entry points (K1's wrapper, the draw
    kernel's, K3's, the projected search's and the shade kernel's) so
    that the first call at each bounce in ``at`` keeps clones of its
    tensor arguments: yields {(name, bounce): (args, kwargs)}, filled as a
    render runs.  The generic loop draws before it searches and shades,
    so those take the bounce of the draw before them."""
    from rust_pathtracer_tpu_torch import integrator

    saved = {n: getattr(integrator, n) for n in CASCADE_KERNEL_FNS}
    calls, bounce = {}, [None]

    def wrap(name):
        def run(*a, **k):
            if name == "fused_bounce_keyed":
                bounce[0] = a[5]
            elif name == "bounce_draws":
                bounce[0] = a[1]
            if bounce[0] in at and (name, bounce[0]) not in calls:
                calls[(name, bounce[0])] = (_clones(torch, a), dict(k))
            return saved[name](*a, **k)
        return run

    for n in CASCADE_KERNEL_FNS:
        setattr(integrator, n, wrap(n))
    try:
        yield calls
    finally:
        for n, fn in saved.items():
            setattr(integrator, n, fn)


def hold_pools(torch, device, label, calls, want):
    """Each kernel the cascade launched at the captured bounces against its
    plain version on the same compacted pool, bit for bit (K3's sphere
    u, v: ``compare_hits``' tolerance): K1, the draw kernel, K3, the
    projected route's sweep (K6; K7 and K5, its fallback, on the pair
    route) and the shade kernel.  ``want``: the kernels that must have
    been held.  Returns (max abs error, {kernel: pools held})."""
    from rust_pathtracer_tpu_torch.integrator import shade_bounce_plain
    from rust_pathtracer_tpu_torch.ops import closest_hit as ch
    from rust_pathtracer_tpu_torch.ops import draws, shade
    from rust_pathtracer_tpu_torch.ops.projected import default_route

    err, held = 0.0, {}
    for (name, b), (args, kw) in sorted(calls.items(), key=lambda x: (x[0][1], x[0][0])):
        if name == "fused_bounce_keyed":
            runs = _keyed_runs(torch, args, kw)
            bad = _keyed_mismatches(runs)
            err = max(err, float(np.abs(runs["kernel"][0].view(np.float32).astype(np.float64)
                                        - runs["plain"][0].view(np.float32)).max()))
            kernels, lanes = ["K1"], args[3].shape[1]
        elif name == "bounce_draws":
            bad, e = _draws_mismatches(torch, device, draws.bounce_draws(*args),
                                       draws.bounce_draws_plain(*args))
            err, kernels, lanes = max(err, e), ["draws"], args[0].shape[1]
        elif name == "closest_hit_record":
            err = max(err, compare_hits(f"K3 {label} bounce {b}",
                                        ch.closest_hit_record(*args, **kw),
                                        ch.closest_hit_record_plain(*args, **kw),
                                        np.array([k for k, _ in kw["kinds"]])))
            bad, kernels, lanes = np.zeros(1, bool), ["K3"], args[1].shape[0]
        elif name == "shade_bounce":
            bad, e = _shade_mismatches(torch, device, shade.shade_bounce(*args, **kw),
                                       shade_bounce_plain(*args, **kw))
            err, kernels, lanes = max(err, e), ["shade"], args[2][0].shape[0]
        else:  # the projected search, on (scene, o, d) or (tables, o, d)
            tables, o, d = getattr(args[0], "proj", args[0]), args[1], args[2]
            kernels = {"resident": ["K6"], "pairs": ["K7", "K5"],
                       "dense": ["K5"]}[default_route(tables)]
            fns = _sweep_fns(torch, tables, o, d)
            bad, lanes = np.zeros(o.shape[0], bool), o.shape[0]
            for k in kernels:
                got, ref = fns[k][0](), fns[k][1]()
                _sync(torch, device)
                for x, y in zip(got, ref):
                    bad |= (x != y).reshape(x.shape[0], -1).any(dim=1).cpu().numpy()
                    err = max(err, float(torch.where(x == y, 0.0,
                                                     (x.double() - y.double()).abs()).max()))
        log(f"{label} bounce {b}: {'/'.join(kernels)} on the pool of {lanes} "
            f"lanes; lanes differing from the plain version {int(bad.sum())}")
        check(not bad.any(), f"{label}: {'/'.join(kernels)} differ from the plain version "
                             f"on the pool of bounce {b}")
        for k in kernels:
            held[k] = held.get(k, 0) + 1
    check(all(held.get(k, 0) >= 1 for k in want),
          f"{label}: pools held {held}, want every one of {want}")
    return err, held


def check_cascade_vs_chunked(torch, name, img, stats, cimg, cstats):
    """Every lane traces its chunked path, so the image, the segments, the
    bounces and the occupancy are the chunked render's bit for bit, and
    no live lane was dropped (occupancy[-1] == 0)."""
    check(torch.equal(img, cimg), f"{name}: the cascade image differs from chunked")
    check(torch.equal(stats.segments, cstats.segments) and stats.bounces == cstats.bounces,
          f"{name}: cascade segments {float(stats.segments):.0f} in {stats.bounces} "
          f"bounces, chunked {float(cstats.segments):.0f} in {cstats.bounces}")
    check(torch.equal(stats.occupancy, cstats.occupancy),
          f"{name}: the cascade occupancy differs from chunked")
    check(float(stats.occupancy[-1]) == 0.0, f"{name}: the cascade dropped live lanes")


def cascade_runs(torch, device, card, name, scene, cam, settings, key, modes, kernel,
                 regen=True, idle=True):
    """The chunked render, each cascade mode of ``modes`` ({label:
    settings overrides}) and, with ``regen``, the regen render of one key:
    wall, segments/s and, with ``idle``, the idle share of each (a trace
    of the device alone); each cascade
    held bit for bit to chunked, its route's ``kernel`` launched once a
    bounce with the draw kernel beside it on the generic routes (the
    "auto" probe's bounces added).  Returns {label: (wall, img, stats)}."""
    from rust_pathtracer_tpu_torch.render import derive_cascade_schedule, render_radiance
    from rust_pathtracer_tpu_torch.wavefront import render_radiance_regen

    def chunked():
        return render_radiance(scene, cam, settings, key, device=device)

    renders = {"chunked": chunked}
    for label, kw in modes.items():
        s = dataclasses.replace(settings, **kw)
        renders[label] = lambda s=s: render_radiance(scene, cam, s, key, device=device)
    if regen:
        renders["regen"] = lambda: render_radiance_regen(scene, cam, settings, key,
                                                         device=device)
    out = {}
    for label, fn in renders.items():
        _, (img, stats), counts = _timed_render(torch, device, fn)
        wall, walls = median_wall(torch, device, fn)
        seg = float(stats.segments)
        log(f"{name} {label} on {card}: wall {wall:.4f} s (median of "
            f"{[round(w, 4) for w in walls]}), segments {seg:.0f}, segments/s "
            f"{seg / wall:.4e}, bounces {stats.bounces}, launches {counts}"
            + (_idle_note(torch, fn) if idle else ""))
        check(np.isfinite(img.cpu().numpy()).all(), f"{name} {label}: non-finite pixels")
        if label not in ("chunked", "regen"):
            check_cascade_vs_chunked(torch, f"{name} {label}", img, stats, *out["chunked"][1:])
            probe = 0
            if modes[label].get("cascade_schedule") == "auto":  # the probe's launches
                _sync(torch, device)
                reset_counts()
                sched = derive_cascade_schedule(scene, cam, settings, key, device=device)
                probe = read_counts()[kernel]
                log(f"{name}: the auto schedule {sched!r}, its probe {probe} {kernel} "
                    f"launches")
                check(sched is not None, f"{name}: auto derived no schedule")
            check(counts[kernel] == stats.bounces + probe,
                  f"{name} {label}: {kernel} launched {counts[kernel]} times in "
                  f"{stats.bounces} bounces (and {probe} of the probe)")
            if kernel != "K1":
                check(counts["draws"] == counts[kernel],
                      f"{name} {label}: the draw kernel launched {counts['draws']} times")
            if kernel in ("K6", "K7"):  # the big scenes shade in the shade kernel
                check(counts["shade"] == counts["draws"],
                      f"{name} {label}: the shade kernel launched {counts['shade']} "
                      f"times, the draw kernel {counts['draws']}")
        out[label] = (wall, img, stats)
    return out


def _idle_note(torch, fn):
    pwall, busy, idle = idle_share(torch, fn, cuda_only=True)
    return (f"; profiled (the device's trace) wall {pwall:.2f} ms, device busy "
            f"{busy:.2f} ms, idle share {idle:.4f}")


def median_wall(torch, device, fn, runs=3):
    """(median, all) wall seconds of ``runs`` more calls of ``fn``, each
    closed by a device sync: the host's clock varies by tens of percent
    between calls of one render on this machine."""
    walls = []
    for _ in range(runs):
        _sync(torch, device)
        t0 = time.perf_counter()
        fn()
        _sync(torch, device)
        walls.append(time.perf_counter() - t0)
    return statistics.median(walls), walls


def phase_cascade_spherefield(torch, device, card, scenes):
    cfg = CASCADE_SF
    W, H, spp, nb = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"]
    log(f"== phase 25 (cascade): SphereField {W}x{H}, {spp} spp, {nb} bounces: the "
        f"cascade (auto, dynamic, {CASCADE_SF_SCHEDULE!r}) against the chunked and the "
        f"regen render of one key; K6 and the draw kernel on the cascade's pools")
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key

    sd, scene = scenes["SphereField"]
    cam = sd.camera_at(0.0, device=device)
    key = prng_key(cfg["seed"], device=device)
    settings = RenderSettings(W, H, spp, nb, SF_BG)
    render_radiance(scene, cam, RenderSettings(64, 36, 2, 6, SF_BG, cascade=True), key,
                    device=device)
    modes = {"auto": dict(cascade_schedule="auto"), "dynamic": dict(cascade=True),
             "explicit": dict(cascade_schedule=CASCADE_SF_SCHEDULE)}
    out = cascade_runs(torch, device, card, "SphereField", scene, cam, settings, key,
                       modes, "K6")
    err = 0.0
    for label, sched in (("explicit", CASCADE_SF_SCHEDULE), ("dynamic", None)):
        at = held_bounces(sched)
        with capture_bounces(torch, at) as calls:
            img2, _ = render_radiance(scene, cam, dataclasses.replace(settings,
                                                                      **modes[label]),
                                      key, device=device)
        check(torch.equal(img2, out[label][1]), f"SphereField {label} twice differs")
        err = max(err, hold_pools(torch, device, f"SphereField {label}", calls,
                                  ("K6", "draws", "shade"))[0])
    c = out["chunked"][0]
    log("SphereField walls (s): " + ", ".join(f"{k} {v[0]:.4f} ({c / v[0]:.3f}x chunked)"
                                               for k, v in out.items()))
    return dict(max_abs_err=err, chunked=out["chunked"])


def phase_cascade_modeltest(torch, device, card, scenes):
    cfg = MT
    W, H, spp, nb = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"]
    log(f"== phase 26 (cascade): ModelTest {W}x{H}, {spp} spp, {nb} bounces on the 10k "
        f"(K6) and 20k (K7, K5) meshes through {CASCADE_MT_SCHEDULE!r}, against chunked "
        f"and regen; the sweeps and the draw kernel on the cascade's pools")
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key

    settings = RenderSettings(W, H, spp, nb, (1.0, 1.0, 1.0))
    modes = {"explicit": dict(cascade_schedule=CASCADE_MT_SCHEDULE)}
    err = 0.0
    for name, kernel, want in (("ModelTest", "K6", ("K6", "draws", "shade")),
                               ("ModelTest 20k", "K7", ("K7", "K5", "draws", "shade"))):
        sd, scene = scenes[name]
        cam = sd.camera_at(0.0, device=device)
        key = prng_key(cfg["seed"], device=device)
        if kernel == "K7":  # K7 and its K5 fallbacks share the bounces
            out = cascade_runs(torch, device, card, name, scene, cam, settings, key, {},
                               kernel)
            def explicit():
                return render_radiance(scene, cam, dataclasses.replace(
                    settings, **modes["explicit"]), key, device=device)

            _, (img, stats), counts = _timed_render(torch, device, explicit)
            check_cascade_vs_chunked(torch, f"{name} explicit", img, stats,
                                     *out["chunked"][1:])
            check(counts["K7"] >= 1 and counts["K7"] + counts["K5"] == stats.bounces
                  == counts["draws"] == counts["shade"],
                  f"{name} explicit: K7 {counts['K7']} + K5 {counts['K5']}, shade "
                  f"{counts['shade']} in {stats.bounces} bounces")
            wall, walls = median_wall(torch, device, explicit)
            seg = float(stats.segments)
            log(f"{name} explicit on {card}: wall {wall:.4f} s (median of "
                f"{[round(w, 4) for w in walls]}), segments {seg:.0f}, segments/s "
                f"{seg / wall:.4e}, bounces {stats.bounces}, launches {counts}"
                + _idle_note(torch, explicit))
            out["explicit"] = (wall, img, stats)
        else:
            out = cascade_runs(torch, device, card, name, scene, cam, settings, key, modes,
                               kernel)
        with capture_bounces(torch, held_bounces(CASCADE_MT_SCHEDULE)) as calls:
            render_radiance(scene, cam, dataclasses.replace(settings, **modes["explicit"]),
                            key, device=device)
        err = max(err, hold_pools(torch, device, f"{name} explicit", calls, want)[0])
        c = out["chunked"][0]
        log(f"{name} walls (s): " + ", ".join(f"{k} {v[0]:.4f} ({c / v[0]:.3f}x chunked)"
                                               for k, v in out.items()))
    return dict(max_abs_err=err)


def phase_cascade_serving(torch, device, card):
    cfg = SERVE
    W, H, spp, nb = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"]
    log(f"== phase 27 (cascade): serving CornellBox {W}x{H}, {spp} spp, {nb} bounces, "
        f"{W * H * cfg['spp_chunk']} lanes a chunk, the fused route, "
        f"cascade_schedule='auto'; K1 on the cascade's pools")
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import (
        RenderSettings,
        derive_cascade_schedule,
        render_radiance,
    )
    from rust_pathtracer_tpu_torch.sampling import prng_key

    sd = get_scene("CornellBox")
    scene = sd.build(device=device)
    cam = sd.camera_at(0.0, device=device)
    key = prng_key(cfg["seed"], device=device)
    settings = RenderSettings(W, H, spp, nb, (0.0, 0.0, 0.0), spp_chunk=cfg["spp_chunk"])
    auto = dict(cascade_schedule="auto")
    out = cascade_runs(torch, device, card, "CornellBox", scene, cam, settings, key,
                       {"auto": auto}, "K1", regen=False, idle=False)
    sched = derive_cascade_schedule(scene, cam, settings, key, device=device)
    with capture_bounces(torch, held_bounces(sched)) as calls:
        render_radiance(scene, cam, dataclasses.replace(settings, **auto), key,
                        device=device)
    err, _ = hold_pools(torch, device, "CornellBox auto", calls, ("K1",))
    return dict(max_abs_err=err, walls={k: v[0] for k, v in out.items()})


def phase_cascade_generic(torch, device, card):
    cfg = GENERIC
    W, H, spp, nb = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"]
    log(f"== phase 28 (cascade): the image-textured scene {W}x{H}, {spp} spp, {nb} "
        f"bounces through the dynamic cascade; K3 and the draw kernel on its pool")
    from rust_pathtracer_tpu_torch.camera import make_camera
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key

    scene = simple_scene(device)
    cam = make_camera(*SIMPLE_CAM, device=device)
    key = prng_key(cfg["seed"], device=device)
    settings = RenderSettings(W, H, spp, nb, SIMPLE_BG)
    dyn = dict(cascade=True)
    cascade_runs(torch, device, card, "image scene", scene, cam, settings, key,
                 {"dynamic": dyn}, "K3", regen=False, idle=False)
    with capture_bounces(torch, held_bounces(None)) as calls:
        render_radiance(scene, cam, dataclasses.replace(settings, **dyn), key,
                        device=device)
    return dict(max_abs_err=hold_pools(torch, device, "image scene dynamic", calls,
                                       ("K3", "draws"))[0])


def phase_cascade_overflow(torch, device, scenes):
    log(f"== phase 29 (cascade): an explicit too-tight schedule {CASCADE_TIGHT!r} on "
        f"SphereField {CASCADE_SF['width']}x{CASCADE_SF['height']} raises "
        f"CascadeOverflowError")
    from rust_pathtracer_tpu_torch.render import (
        CascadeOverflowError,
        RenderSettings,
        _cascade_static_schedule,
        render_radiance,
    )
    from rust_pathtracer_tpu_torch.sampling import prng_key

    sd, scene = scenes["SphereField"]
    cfg = CASCADE_SF
    settings = RenderSettings(cfg["width"], cfg["height"], 2, cfg["bounces"], SF_BG,
                              cascade_schedule=CASCADE_TIGHT)
    lanes = cfg["width"] * cfg["height"] * settings.resolve_chunk()
    check(bool(_cascade_static_schedule(cfg["bounces"], lanes, CASCADE_TIGHT)),
          f"{CASCADE_TIGHT!r} is no static schedule for {lanes} lanes")
    try:
        render_radiance(scene, sd.camera_at(0.0, device=device), settings,
                        prng_key(cfg["seed"], device=device), device=device)
    except CascadeOverflowError as e:
        log(f"raised: {e}")
        return
    fail(f"the schedule {CASCADE_TIGHT!r} returned an image instead of raising")


class _Stop(Exception):
    pass


def phase_checkpoint_resume(torch, device, card, scenes, chunked):
    cfg = CASCADE_SF
    W, H, spp, nb = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"]
    log(f"== phase 30: checkpointed SphereField {W}x{H}, {spp} spp, {nb} bounces, "
        f"stopped after 2 of its chunks and resumed, plain and through "
        f"{CASCADE_SF_SCHEDULE!r}: bit for bit the uninterrupted render")
    from rust_pathtracer_tpu_torch import render
    from rust_pathtracer_tpu_torch.render import RenderSettings
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        render_radiance_checkpointed,
    )

    sd, scene = scenes["SphereField"]
    cam = sd.camera_at(0.0, device=device)
    key = prng_key(cfg["seed"], device=device)
    os.makedirs(OUT_DIR, exist_ok=True)
    for label, sched, fn in (("plain", None, "_render_chunk"),
                             ("cascade", CASCADE_SF_SCHEDULE, "_render_chunk_cascaded")):
        settings = RenderSettings(W, H, spp, nb, SF_BG, cascade_schedule=sched)
        n_chunks = -(-spp // settings.resolve_chunk())
        check(n_chunks >= 3, f"the frame has {n_chunks} chunks")
        paths = {k: os.path.join(OUT_DIR, f"ckpt_{label}_{k}.npz") for k in ("full", "part")}
        for p in paths.values():
            if os.path.exists(p):
                os.unlink(p)
        full, fst = render_radiance_checkpointed(scene, cam, settings, key, paths["full"],
                                                 device=device)
        real, done = getattr(render, fn), []

        def stopping(*a, **k):
            if len(done) == 2:
                raise _Stop()
            done.append(a[3])
            return real(*a, **k)

        setattr(render, fn, stopping)
        try:
            render_radiance_checkpointed(scene, cam, settings, key, paths["part"],
                                         device=device)
            fail(f"{label}: the checkpointed render was not stopped")
        except _Stop:
            pass
        finally:
            setattr(render, fn, real)
        saved = load_checkpoint(paths["part"])
        t0 = time.perf_counter()
        img, st = render_radiance_checkpointed(scene, cam, settings, key, paths["part"],
                                               device=device)
        _sync(torch, device)
        wall = time.perf_counter() - t0
        log(f"{label}: stopped after chunks at samples {done} ({saved.samples_done} of "
            f"{spp} samples saved), resumed the other {n_chunks - 2} chunks in {wall:.3f} s "
            f"on {card}; segments {float(st.segments):.0f} vs {float(fst.segments):.0f}")
        check(torch.equal(img, full), f"{label}: the resumed image differs")
        check(float(st.segments) == float(fst.segments), f"{label}: the resumed segments "
                                                         "differ")
        check(torch.equal(full, chunked[1]), f"{label}: the checkpointed image differs "
                                             "from render_radiance's")


# ---------------------------------------------------------------------------
# phases 31-34: sharded rendering over a (tiles, samples) grid of ranks
# ---------------------------------------------------------------------------

# The ranks share the one card, so they run over gloo (NCCL refuses two
# ranks on one device): a 2x2 grid, and a 1x1 and a 1x2 grid over the first
# ranks of the same group.  Only all_reduce and barrier run; gloo takes CUDA
# tensors for both (and for broadcast, all_gather and reduce_scatter, as a
# probe on the H100 machine found), so nothing is staged through the host
# here.
SHARD_WORLD = 4
SHARD_TIMEOUT_S = 300
SHARD_HOLD_BOUNCE = 10   # K1 and K6 held to plain on rank 0's pool at it
SHARD_ATOL = 2e-6        # tests/test_sharding.py's, where samples > 1


def shard_bound(spp):
    """The image tolerance where the samples axis is 2: JAX's atol, plus
    the re-association bound of a mean of ``spp`` non-negative f32 terms
    summed in another grouping (spp ulps of the pixel)."""
    return SHARD_ATOL, spp * 2.0 ** -24


def _shard_timed(torch, mesh, fn):
    """(rank 0's wall s, result, this rank's launches) of ``fn``, opened
    and closed by a device sync and a barrier of the grid."""
    torch.cuda.synchronize()
    mesh.barrier()
    reset_counts()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    mesh.barrier()
    return time.perf_counter() - t0, out, read_counts()


def shard_rank(rank, world, init, out):
    """One rank of phases 31-34, started by torch.multiprocessing (spawn).
    Phase 2 built every kernel in the parent; each rank's
    ``ops._build.load_library`` finds the library under ops/build/ by its
    source hash and only loads it (checked first: no rank runs nvcc, where
    four ranks building at once could deadlock on one file).  Writes its
    results to ``out/rank{rank}.pt``; any failed check exits non-zero."""
    sys.path.insert(0, REPO)
    import torch

    from rust_pathtracer_tpu_torch.grad import DiffParams, apply_params
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops import _build
    from rust_pathtracer_tpu_torch.parallel import (
        distributed_init,
        make_mesh,
        reduce_replicated_grads,
        render_radiance_sharded,
    )
    from rust_pathtracer_tpu_torch.parallel.shard import ShardedChunkPlan
    from rust_pathtracer_tpu_torch.render import RenderSettings
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.checkpoint import (
        load_checkpoint,
        render_radiance_sharded_checkpointed,
    )

    for name in KERNELS:
        check(_build._library_path(name).exists(), f"rank {rank}: {name} is not built")
    dev = distributed_init("gloo", init, world, rank, device="cuda")
    grids = {"2x2": make_mesh(2, 2, device=dev),
             "1x1": make_mesh(1, 1, device=dev, ranks=[0]),
             "1x2": make_mesh(1, 2, device=dev, ranks=[0, 1])}
    res = {}

    def run(label, grid, fn, hold=None):
        """``fn`` on ``grid`` (ranks outside it skip): a warm-up run (on
        rank 0 capturing the pools of SHARD_HOLD_BOUNCE, where ``hold``
        names the kernels to hold), then the timed run."""
        mesh = grids[grid]
        if mesh is None:
            return
        if hold and mesh.rank == 0:
            with capture_bounces(torch, {SHARD_HOLD_BOUNCE}) as calls:
                fn(mesh)
            err, held = hold_pools(torch, dev, f"{label} {grid} rank 0", calls, hold)
            res[f"{label} {grid} hold"] = (err, held)
        else:
            fn(mesh)
        wall, out_, counts = _shard_timed(torch, mesh, lambda: fn(mesh))
        res[f"{label} {grid}"] = dict(wall=wall, counts=counts, **out_)

    # phase 31: serving CornellBox (K1)
    sd = get_scene("CornellBox")
    cb, cb_cam = sd.build(device=dev), sd.camera_at(0.0, device=dev)
    sv = SERVE
    serve = RenderSettings(sv["width"], sv["height"], sv["spp"], sv["bounces"],
                           (0.0, 0.0, 0.0), spp_chunk=sv["spp_chunk"])

    def serving(mesh):
        img, st = render_radiance_sharded(cb, cb_cam, serve, prng_key(sv["seed"], device=dev),
                                          mesh)
        return dict(img=img.cpu(), segments=float(st.segments), bounces=st.bounces)

    run("serving", "2x2", serving, hold=("K1",))
    run("serving", "1x1", serving)

    # phase 32: the bench-shaped differentiable step (K1-res, K2)
    step_s = RenderSettings(BENCH["width"], BENCH["height"], BENCH["spp"], BENCH["bounces"],
                            (0.0, 0.0, 0.0), spp_chunk=BENCH["spp"], differentiable=True)

    def step(mesh):
        leaves = _diff_leaves(torch, cb, CORNELL_CAM, (0.0, 0.0, 0.0), dev)
        p = DiffParams.from_leaves(leaves)
        img, st = render_radiance_sharded(apply_params(cb, p), p.camera.build(), step_s,
                                          prng_key(0, device=dev), mesh,
                                          background=p.background)
        loss = img.mean()
        loss.backward()
        grads = reduce_replicated_grads(leaves, mesh)
        return dict(loss=float(loss.detach()), grads=[g.cpu() for g in grads],
                    segments=float(st.segments))

    run("step", "2x2", step)
    run("step", "1x1", step)

    # phase 33: the SphereField frame through the explicit cascade (K6, draws)
    sfd = get_scene("SphereField")
    sf, sf_cam = sfd.build(device=dev), sfd.camera_at(0.0, device=dev)
    c = CASCADE_SF
    sf_s = RenderSettings(c["width"], c["height"], c["spp"], c["bounces"], SF_BG,
                          cascade_schedule=CASCADE_SF_SCHEDULE)

    def frame(mesh):
        img, st = render_radiance_sharded(sf, sf_cam, sf_s, prng_key(c["seed"], device=dev),
                                          mesh)
        return dict(img=img.cpu(), segments=float(st.segments),
                    dropped=float(st.occupancy[-1]))

    run("frame", "2x2", frame, hold=("K6", "draws"))
    run("frame", "1x1", frame)

    # phase 34: the frame checkpointed on 2x2, stopped as every rank starts
    # its group's second half of chunks, resumed on 1x2
    path = os.path.join(out, "sf_sharded.npz")
    key = prng_key(c["seed"], device=dev)
    plan_chunks = ShardedChunkPlan(sf, sf_cam, sf_s, key, grids["2x2"]).n_chunks
    real, done = ShardedChunkPlan.run_chunk, []

    def stopping(plan, ci):
        if ci == plan_chunks // 2:
            raise _Stop()
        done.append(ci)
        return real(plan, ci)

    ShardedChunkPlan.run_chunk = stopping
    try:
        render_radiance_sharded_checkpointed(sf, sf_cam, sf_s, key, grids["2x2"], path)
        fail(f"rank {rank}: the sharded checkpointed render was not stopped")
    except _Stop:
        pass
    finally:
        ShardedChunkPlan.run_chunk = real
    grids["2x2"].barrier()
    if grids["1x2"] is not None:
        saved = load_checkpoint(path)
        wall, (img, st), _ = _shard_timed(torch, grids["1x2"], lambda: (
            render_radiance_sharded_checkpointed(sf, sf_cam, sf_s, key, grids["1x2"], path)))
        res["resume 1x2"] = dict(img=img.cpu(), segments=float(st.segments), wall=wall,
                                 stopped_after=list(done), n_chunks=plan_chunks,
                                 samples_done=saved.samples_done,
                                 samples_axis=saved.samples_axis)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))
    torch.distributed.destroy_process_group()


def phase_sharded(torch, device, card):
    log(f"== phases 31-34: sharded rendering, {SHARD_WORLD} ranks (a 2x2 grid, and 1x1 "
        f"and 1x2 over its first ranks) on the one card over gloo, against the "
        f"single-process runs of the same keys")
    import tempfile

    import torch.multiprocessing as mp

    from rust_pathtracer_tpu_torch.grad import DiffParams, apply_params
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key

    # the single-process references, timed as the ranks time theirs
    sd = get_scene("CornellBox")
    cb, cb_cam = sd.build(device=device), sd.camera_at(0.0, device=device)
    sv = SERVE
    serve = RenderSettings(sv["width"], sv["height"], sv["spp"], sv["bounces"],
                           (0.0, 0.0, 0.0), spp_chunk=sv["spp_chunk"])
    single = {}

    def timed(label, fn):
        fn()
        _sync(torch, device)
        reset_counts()
        t0 = time.perf_counter()
        out = fn()
        _sync(torch, device)
        single[label] = (time.perf_counter() - t0, out, read_counts())

    timed("serving", lambda: render_radiance(cb, cb_cam, serve,
                                             prng_key(sv["seed"], device=device),
                                             device=device))
    step_s = RenderSettings(BENCH["width"], BENCH["height"], BENCH["spp"], BENCH["bounces"],
                            (0.0, 0.0, 0.0), spp_chunk=BENCH["spp"], differentiable=True)

    def step():
        leaves = _diff_leaves(torch, cb, CORNELL_CAM, (0.0, 0.0, 0.0), device)
        p = DiffParams.from_leaves(leaves)
        img, st = render_radiance(apply_params(cb, p), p.camera.build(), step_s,
                                  prng_key(0, device=device), background=p.background,
                                  device=device)
        loss = img.mean()
        loss.backward()
        return float(loss.detach()), [torch.as_tensor(g) for g in _leaf_grads(leaves)]

    timed("step", step)
    sfd = get_scene("SphereField")
    sf, sf_cam = sfd.build(device=device), sfd.camera_at(0.0, device=device)
    c = CASCADE_SF
    sf_s = RenderSettings(c["width"], c["height"], c["spp"], c["bounces"], SF_BG,
                          cascade_schedule=CASCADE_SF_SCHEDULE)
    timed("frame", lambda: render_radiance(sf, sf_cam, sf_s, prng_key(c["seed"], device=device),
                                           device=device))
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=OUT_DIR) as out:
        init = "file://" + os.path.join(out, "store")
        ctx = mp.start_processes(shard_rank, args=(SHARD_WORLD, init, out),
                                 nprocs=SHARD_WORLD, join=False, start_method="spawn")
        deadline = time.monotonic() + SHARD_TIMEOUT_S
        while not ctx.join(timeout=5):  # raises where a rank failed
            if time.monotonic() > deadline:
                for p in ctx.processes:
                    p.kill()
                fail(f"the {SHARD_WORLD} ranks were not done within {SHARD_TIMEOUT_S} s")
        ranks = [torch.load(os.path.join(out, f"rank{r}.pt"), weights_only=False)
                 for r in range(SHARD_WORLD)]
    log(f"the ranks took {time.perf_counter() - t0:.1f} s (start-up included)")
    r0 = ranks[0]

    # phase 31
    wall1, (img, st), counts1 = single["serving"]
    atol, rtol = shard_bound(sv["spp"])
    for r, rec in enumerate(ranks):
        got = rec["serving 2x2"]
        check(torch.equal(got["img"], ranks[0]["serving 2x2"]["img"]),
              f"serving 2x2: rank {r}'s image differs from rank 0's")
        check(got["counts"]["K1"] > 0, f"serving 2x2: rank {r} launched K1 no time")
    g22, g11 = r0["serving 2x2"], r0["serving 1x1"]
    err22 = float((g22["img"] - img.cpu()).abs().max())
    check(torch.allclose(g22["img"], img.cpu(), rtol=rtol, atol=atol),
          f"serving 2x2 differs from the single-process image by {err22:.3e}")
    check(abs(g22["segments"] - float(st.segments)) <= 1e-6 * float(st.segments),
          f"serving 2x2 segments {g22['segments']:.0f} vs {float(st.segments):.0f}")
    check(torch.equal(g11["img"], img.cpu()) and g11["segments"] == float(st.segments),
          "serving 1x1 is not the single-process render bit for bit")
    err, held = r0["serving 2x2 hold"]
    log(f"phase 31: serving CornellBox {sv['width']}x{sv['height']}, {sv['spp']} spp, "
        f"{sv['bounces']} bounces on {card}: 2x2 wall {g22['wall']:.4f} s (rank 0, barrier "
        f"and sync), 1x1 {g11['wall']:.4f} s, single process {wall1:.4f} s; max abs err "
        f"2x2 {err22:.3e} (bound {atol:g} + {rtol:.3g} rel), 1x1 0 (bit for bit); "
        f"segments {g22['segments']:.0f} vs {float(st.segments):.0f}; K1 launches a rank "
        f"{[rec['serving 2x2']['counts']['K1'] for rec in ranks]}, single process "
        f"{counts1['K1']}; K1 held to plain on rank 0's pool at bounce "
        f"{SHARD_HOLD_BOUNCE}: {held}, max abs err {err:.3e}")

    # phase 32
    wall2, (loss, grads), counts2 = single["step"]
    s22, s11 = r0["step 2x2"], r0["step 1x1"]
    for r, rec in enumerate(ranks):
        got = rec["step 2x2"]
        check(got["loss"] == s22["loss"] and all(torch.equal(a, b) for a, b in
                                                 zip(got["grads"], s22["grads"])),
              f"step 2x2: rank {r}'s loss or gradients differ from rank 0's")
        check(got["counts"]["K1-res"] == BENCH["bounces"] and
              got["counts"]["K2"] == BENCH["bounces"],
              f"step 2x2: rank {r} launched {got['counts']}")
    check(abs(s22["loss"] - loss) <= 1e-6 * abs(loss),
          f"step 2x2 loss {s22['loss']:.9f} vs single process {loss:.9f}")
    floor = 1e-6 * max(float(g.abs().max()) for g in grads)
    worst = 0.0
    for name, got, want in zip(LEAF_NAMES, s22["grads"], grads):
        want = want.cpu().to(torch.float32)
        tol = 1e-4 * float(want.abs().max()) + floor
        d = float((got - want).abs().max())
        worst = max(worst, d / max(tol, 1e-30))
        check(d <= tol, f"step 2x2 gradient {name}: max abs difference {d:.3e} > {tol:.3e}")
    check(s11["loss"] == loss and all(torch.equal(a, b.cpu().to(torch.float32)) for a, b in
                                      zip(s11["grads"], grads)),
          "step 1x1 is not the single-process step bit for bit")
    log(f"phase 32: the bench-shaped step {BENCH['width']}x{BENCH['height']}, "
        f"{BENCH['spp']} spp, {BENCH['bounces']} bounces, loss = mean(img) on {card}: 2x2 "
        f"wall {s22['wall']:.4f} s, 1x1 {s11['wall']:.4f} s, single process "
        f"{wall2:.4f} s; loss {s22['loss']:.9f} vs {loss:.9f}; the largest gradient "
        f"difference {worst:.3f} of its tolerance (1e-4 of the leaf's largest + 1e-6 of "
        f"the largest); 1x1 bit for bit; launches a rank "
        f"{[(rec['step 2x2']['counts']['K1-res'], rec['step 2x2']['counts']['K2']) for rec in ranks]} "
        f"(K1-res, K2), single process ({counts2['K1-res']}, {counts2['K2']})")

    # phase 33
    wall3, (img3, st3), counts3 = single["frame"]
    atol, rtol = shard_bound(c["spp"])
    f22, f11 = r0["frame 2x2"], r0["frame 1x1"]
    for r, rec in enumerate(ranks):
        got = rec["frame 2x2"]
        check(torch.equal(got["img"], f22["img"]), f"frame 2x2: rank {r}'s image differs")
        check(got["counts"]["K6"] > 0 and got["counts"]["draws"] > 0,
              f"frame 2x2: rank {r} launched {got['counts']}")
        check(got["dropped"] == 0.0, "frame 2x2: the cascade dropped live lanes")
    err33 = float((f22["img"] - img3.cpu()).abs().max())
    check(torch.allclose(f22["img"], img3.cpu(), rtol=rtol, atol=atol),
          f"frame 2x2 differs from the single-process image by {err33:.3e}")
    check(torch.equal(f11["img"], img3.cpu()) and f11["segments"] == float(st3.segments),
          "frame 1x1 is not the single-process render bit for bit")
    err, held = r0["frame 2x2 hold"]
    log(f"phase 33: SphereField {c['width']}x{c['height']}, {c['spp']} spp, {c['bounces']} "
        f"bounces, {CASCADE_SF_SCHEDULE!r} on {card}: 2x2 wall {f22['wall']:.4f} s, 1x1 "
        f"{f11['wall']:.4f} s, single process {wall3:.4f} s; max abs err 2x2 {err33:.3e} "
        f"(bound {atol:g} + {rtol:.3g} rel); segments {f22['segments']:.0f} vs "
        f"{float(st3.segments):.0f}; K6 / draws launches a rank "
        f"{[(rec['frame 2x2']['counts']['K6'], rec['frame 2x2']['counts']['draws']) for rec in ranks]}, "
        f"single process ({counts3['K6']}, {counts3['draws']}); K6 and the draw kernel held "
        f"to plain on rank 0's pool at bounce {SHARD_HOLD_BOUNCE}: {held}, max abs err "
        f"{err:.3e}")

    # phase 34
    rs = r0["resume 1x2"]
    check(rs["stopped_after"] == list(range(rs["n_chunks"] // 2)),
          f"the stopped run traced chunks {rs['stopped_after']}")
    check(rs["samples_axis"] == 2 and rs["samples_done"] > 0, "the saved file is wrong")
    check(torch.equal(rs["img"], f22["img"]) and rs["segments"] == f22["segments"],
          "the resumed 1x2 render is not the uninterrupted 2x2 render bit for bit")
    check(torch.equal(ranks[1]["resume 1x2"]["img"], rs["img"]),
          "rank 1's resumed image differs from rank 0's")
    log(f"phase 34: the frame checkpointed on 2x2, stopped after chunks "
        f"{rs['stopped_after']} of {rs['n_chunks']} a sample group ({rs['samples_done']} "
        f"samples a group saved), resumed on 1x2 in {rs['wall']:.4f} s on {card}: bit for "
        f"bit the uninterrupted 2x2 render, segments {rs['segments']:.0f}")
    return dict(k1_launches=[rec["serving 2x2"]["counts"]["K1"] for rec in ranks],
                k6_launches=[rec["frame 2x2"]["counts"]["K6"] for rec in ranks])


# ---------------------------------------------------------------------------
# phases 35-37: the command-line surface (the CLI's animation loop, scene JSON)
# and the inverse-rendering example
# ---------------------------------------------------------------------------

# phase 35: SphereField's own 300-frame orbit at its own width, the last
# three frames, spp cut from 250 to 2
ANIM = dict(width=854, height=480, frames=300, start=297, spp=2)
ANIM_HOLD_FRAME = 298
ANIM_HOLD_BOUNCES = (2, 10)
# phase 36: tests/test_json_cli.py's CORNELL_DOC (the built-in CornellBox
# spelled out), copied: this script imports no JAX test
CORNELL_DOC = {
    "perlin_seed": 0,
    "textures": [
        {"type": "solid", "color": [0.65, 0.05, 0.05]},
        {"type": "solid", "color": [0.73, 0.73, 0.73]},
        {"type": "solid", "color": [0.12, 0.45, 0.15]},
        {"type": "solid", "color": [15.0, 15.0, 15.0]},
    ],
    "materials": [
        {"type": "lambertian", "texture": 0},
        {"type": "lambertian", "texture": 1},
        {"type": "lambertian", "texture": 2},
        {"type": "light", "texture": 3},
        {"type": "dielectric", "ir": 1.5},
    ],
    "primitives": [
        {"type": "rect", "plane": "yz", "start": [555, 0, 0], "end": [555, 555, 555],
         "direction": -1, "material": 2},
        {"type": "rect", "plane": "yz", "start": [0, 0, 0], "end": [0, 555, 555],
         "direction": 1, "material": 0},
        {"type": "rect", "plane": "xz", "start": [0, 555, 0], "end": [555, 555, 555],
         "direction": -1, "material": 1},
        {"type": "rect", "plane": "xz", "start": [0, 0, 0], "end": [555, 0, 555],
         "direction": 1, "material": 1},
        {"type": "rect", "plane": "xz", "start": [213, 554, 227], "end": [343, 554, 332],
         "direction": -1, "material": 3},
        {"type": "rect", "plane": "xy", "start": [0, 0, 555], "end": [555, 555, 555],
         "direction": -1, "material": 1},
        {"type": "box", "start": [130, 0, 65], "end": [295, 165, 230], "material": 1},
        {"type": "box", "start": [265, 0, 295], "end": [430, 330, 460], "material": 1},
        {"type": "sphere", "center": [212.5, 255.0, 147.5], "radius": 90.0, "material": 4},
        {"type": "sphere", "center": [347.5, 420.0, 377.5], "radius": 90.0, "material": 4},
    ],
    "camera": {
        "type": "static", "lookfrom": [278, 278, -800], "lookat": [278, 278, 0],
        "up": [0, 1, 0], "vfov": 40.0, "aperture": 0.0, "focus_dist": 10.0,
    },
    "image": {
        "width": 400, "height": 400, "samples_per_pixel": 1000,
        "max_bounces": 20, "background": [0.0, 0.0, 0.0],
    },
}
JSON_FRAME = dict(width=854, height=480, spp=2, bounces=20, seed=0)
JSON_HOLD_BOUNCES = (2,)
# phase 37: the example's own 64x64, 16 spp, 5 bounces, 150 steps
INVERSE_STEPS = 150
INVERSE_LOSS_RTOL = 1e-5
INVERSE_HOLD_BOUNCE = 2


def gif_blocks(path):
    """Walk a GIF's blocks (there is no Pillow on the card's machine):
    (version, width, height, image descriptors, NETSCAPE2.0 loop count or
    None)."""
    import struct

    data = open(path, "rb").read()
    w, h, packed = struct.unpack("<HHB", data[6:11])
    pos = 13 + (3 * (2 << (packed & 7)) if packed & 0x80 else 0)
    images, loop = 0, None

    def skip_sub_blocks(pos):
        blocks = []
        while data[pos]:
            blocks.append(data[pos + 1:pos + 1 + data[pos]])
            pos += 1 + data[pos]
        return pos + 1, blocks

    while pos < len(data) and data[pos] != 0x3B:
        if data[pos] == 0x21:  # an extension: label, then sub-blocks
            label = data[pos + 1]
            pos, blocks = skip_sub_blocks(pos + 2)
            if label == 0xFF and blocks and blocks[0] == b"NETSCAPE2.0":
                loop = struct.unpack("<H", blocks[1][1:3])[0]
        elif data[pos] == 0x2C:  # an image: descriptor, table, code size, data
            pk = data[pos + 9]
            pos += 10 + (3 * (2 << (pk & 7)) if pk & 0x80 else 0) + 1
            pos, _ = skip_sub_blocks(pos)
            images += 1
        else:
            fail(f"{path}: unknown GIF block 0x{data[pos]:02x} at byte {pos}")
    check(pos < len(data), f"{path}: no GIF trailer")
    return data[:6].decode(), w, h, images, loop


def _run_cli(torch, device, argv):
    """``cli.main(argv + ["--device", device])`` in this process: (exit
    code, stdout, stderr, wall seconds closed by a device sync)."""
    import io

    from rust_pathtracer_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    _sync(torch, device)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv + ["--device", str(torch.device(device).type)])
    _sync(torch, device)
    return rc, out.getvalue(), err.getvalue(), time.perf_counter() - t0


def _frames_bytes(folder, frames):
    return {f: open(os.path.join(folder, f"image_{f:04d}.png"), "rb").read()
            for f in frames}


def _png_of(torch, img, path):
    from rust_pathtracer_tpu_torch.utils.image import to_rgb8, write_png

    write_png(path, to_rgb8(img.cpu().numpy()))
    return open(path, "rb").read()


def phase_animation(torch, device, card):
    import shutil

    frames = range(ANIM["start"], ANIM["frames"])
    log(f"== phase 35 (main path, the command line): the CLI's SphereField animation at "
        f"{ANIM['width']}x{ANIM['height']}, frames {frames[0]}-{frames[-1]} of {ANIM['frames']}, "
        f"{ANIM['spp']} spp, with the GIF and the timing log; again under --cascade "
        f"auto, and per-frame checkpoints stopped and resumed")
    from rust_pathtracer_tpu_torch import render
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.image import read_png, write_gif
    from rust_pathtracer_tpu_torch.utils.metrics import StageTimer

    out = os.path.join(OUT_DIR, "anim")
    shutil.rmtree(out, ignore_errors=True)
    dirs = {k: os.path.join(out, k) for k in ("chunked", "auto", "ckpt", "want")}
    tlog = os.path.join(out, "timing.jsonl")
    base = ["--scene", "SphereField", "--width", str(ANIM["width"]), "--height",
            str(ANIM["height"]), "--frames", str(ANIM["frames"]), "--frame-start",
            str(ANIM["start"]), "--spp", str(ANIM["spp"])]
    reset_counts()
    rc, text, err, wall = _run_cli(torch, device, base + [
        "--gif", "--timing-log", tlog, "--output-dir", dirs["chunked"]])
    counts = read_counts()
    check(rc == 0, f"the CLI exited {rc}: {err[-2000:]}")
    log(text.strip().splitlines()[-1])
    for line in err.splitlines():
        if line.startswith(("[metrics]", "[timing]")):
            log(line)
    log(f"the CLI call took {wall:.3f} s; launches {counts}")
    check(counts["K6"] > 0 and counts["draws"] == counts["K6"],
          f"the animation launched K6 {counts['K6']} and draws {counts['draws']} times")
    got = _frames_bytes(dirs["chunked"], frames)

    sd = get_scene("SphereField")
    scene = sd.build(device=device)
    settings = dataclasses.replace(sd.output.image, width=ANIM["width"],
                                   height=ANIM["height"], samples_per_pixel=ANIM["spp"])
    key = prng_key(0, device=device)
    segs, err_max = {}, 0.0
    for f in frames:
        cam = sd.camera_at(f / ANIM["frames"], device=device)
        if f == ANIM_HOLD_FRAME:
            with capture_bounces(torch, ANIM_HOLD_BOUNCES) as calls:
                img, st = render_radiance(scene, cam, settings, key, device=device)
            err_max, held = hold_pools(torch, device, f"SphereField frame {f}", calls,
                                       ("K6", "draws"))
        else:
            img, st = render_radiance(scene, cam, settings, key, device=device)
        segs[f] = float(st.segments)
        want = _png_of(torch, img, os.path.join(dirs["want"], f"{f}.png"))
        check(got[f] == want, f"frame {f}: the CLI's PNG differs from render_radiance's "
                              f"at camera_at({f}/{ANIM['frames']})")
        check(read_png(os.path.join(dirs["chunked"], f"image_{f:04d}.png")).shape
              == (settings.height, settings.width, 3), f"frame {f}: PNG shape")
    lines = [json.loads(x) for x in open(tlog)]
    check([x["frame"] for x in lines] == list(frames)
          and [x["segments"] for x in lines] == [segs[f] for f in frames],
          f"the timing log {lines} against the renders' segments {segs}")
    log(f"frames {list(frames)}: each PNG byte for byte render_radiance's; timing log "
        f"{lines}")
    gif = os.path.join(dirs["chunked"], "animation.gif")
    blocks = gif_blocks(gif)
    check(blocks == ("GIF89a", settings.width, settings.height, len(frames), 0),
          f"the GIF's blocks {blocks}")
    rgbs = [read_png(os.path.join(dirs["chunked"], f"image_{f:04d}.png")) for f in frames]
    gif_timer = StageTimer()
    t0 = time.perf_counter()
    write_gif(os.path.join(out, "again.gif"), rgbs, fps=sd.output.fps, timer=gif_timer)
    gif_s = time.perf_counter() - t0
    check(open(os.path.join(out, "again.gif"), "rb").read() == open(gif, "rb").read(),
          "write_gif of the same frames wrote other bytes")
    split = {k.split()[1]: v for k, v in gif_timer.stages.items()}  # "gif lzw" -> "lzw"
    log(f"GIF: {blocks}, {os.path.getsize(gif)} bytes; write_gif of the {len(frames)} "
        f"frames {gif_s:.3f} s on the host, by write_gif's own stages: the palette "
        f"{split['palette']:.3f} s, dithering {split['dither']:.3f} s, "
        f"LZW {split['lzw']:.3f} s")

    reset_counts()
    rc, text, err, wall_auto = _run_cli(torch, device, base + [
        "--cascade", "auto", "--output-dir", dirs["auto"]])
    counts = read_counts()
    check(rc == 0, f"the CLI under --cascade auto exited {rc}: {err[-2000:]}")
    sched = [x for x in err.splitlines() if x.startswith("auto cascade schedule:")]
    check(len(sched) == 1 and "None" not in sched[0], f"the schedule lines {sched}")
    check(_frames_bytes(dirs["auto"], frames) == got,
          "a frame under the sticky auto schedule differs from the chunked frame")
    log(f"--cascade auto: {sched[0]} (printed once); every frame the chunked frame's "
        f"bytes; the CLI call {wall_auto:.3f} s; launches {counts}; "
        f"{text.strip().splitlines()[-1]}")

    ckpt = os.path.join(out, "ckpt_files", "anim.npz")
    real, ran = render._render_chunk, []

    def stopping(*a, **k):
        if len(ran) == 3:  # frame 297's two chunks, then one of frame 298's
            raise _Stop()
        ran.append(a[3])
        return real(*a, **k)

    argv = base + ["--spp-chunk", "1", "--checkpoint", ckpt, "--output-dir", dirs["ckpt"]]
    render._render_chunk = stopping
    try:
        _run_cli(torch, device, argv)
        fail("the checkpointed animation was not stopped")
    except _Stop:
        pass
    finally:
        render._render_chunk = real
    names = sorted(os.listdir(os.path.dirname(ckpt)))
    check(names == ["anim.npz.frame0297", "anim.npz.frame0298"], f"checkpoint files {names}")
    # the resumed run's chunks by frame (the camera names it): none of
    # frame 297's, frame 298's second alone, both of frame 299's; a run
    # that ignored the files would render their chunks again
    frame_of = {tuple(sd.camera_at(f / ANIM["frames"], device=device).origin.tolist()): f
                for f in frames}
    resumed = []

    def counting(*a, **k):
        resumed.append((frame_of.get(tuple(a[1].origin.tolist())), a[3]))
        return real(*a, **k)

    render._render_chunk = counting
    try:
        rc, _, err, wall_resume = _run_cli(torch, device, argv)
    finally:
        render._render_chunk = real
    check(rc == 0, f"the resumed animation exited {rc}: {err[-2000:]}")
    want_chunks = [(frames[1], 1), (frames[2], 0), (frames[2], 1)]
    check(resumed == want_chunks,
          f"the resumed run rendered the chunks (frame, sample) {resumed}, not {want_chunks}")
    names = sorted(os.listdir(os.path.dirname(ckpt)))
    check(names == [f"anim.npz.frame{f:04d}" for f in frames], f"checkpoint files {names}")
    check(_frames_bytes(dirs["ckpt"], frames) == got,
          "the resumed checkpointed frames differ from the chunked frames")
    log(f"--checkpoint: stopped in frame {ANIM_HOLD_FRAME} after chunks at samples {ran} "
        f"(files {names[:2]} then), resumed in {wall_resume:.3f} s rendering only the "
        f"chunks (frame, sample) {resumed}: {names}, every PNG the chunked frame's bytes")
    return dict(max_abs_err=err_max, render_s=[x["seconds"] for x in lines], gif_s=gif_s,
                **{f"gif_{k}_s": v for k, v in split.items()})


def _textured_doc(tex_png, obj):
    """A scene of checker, perlin and image textures (``tex_png``), a
    metal and a glass sphere and a light, with ``obj`` (an OBJ path, or
    None) as ModelTest places it, seen by ModelTest's camera."""
    doc = {
        "perlin_seed": 0,
        "textures": [
            {"type": "solid", "color": [0.2, 0.3, 0.1]},
            {"type": "solid", "color": [0.9, 0.9, 0.9]},
            {"type": "checker", "odd": 0, "even": 1},
            {"type": "perlin", "scale": 4.0},
            {"type": "image", "path": tex_png},
            {"type": "solid", "color": [4.0, 4.0, 4.0]},
            {"type": "solid", "color": [0.7, 0.6, 0.5]},
        ],
        "materials": [
            {"type": "lambertian", "texture": 2},
            {"type": "lambertian", "texture": 3},
            {"type": "lambertian", "texture": 4},
            {"type": "light", "texture": 5},
            {"type": "metal", "texture": 6, "fuzz": 0.1},
            {"type": "dielectric", "ir": 1.5},
        ],
        "primitives": [
            {"type": "sphere", "center": [0, -1000, 0], "radius": 1000, "material": 0},
            {"type": "sphere", "center": [-2.6, 1.0, 0.5], "radius": 1.0, "material": 1},
            {"type": "sphere", "center": [2.6, 1.0, 0.5], "radius": 1.0, "material": 2},
            {"type": "sphere", "center": [1.2, 0.4, -2.0], "radius": 0.4, "material": 4},
            {"type": "sphere", "center": [-1.2, 0.4, -2.0], "radius": 0.4, "material": 5},
            {"type": "rect", "plane": "xz", "start": [-2, 5, -2], "end": [2, 5, 2],
             "direction": -1, "material": 3},
        ],
        "camera": {"type": "static", "lookfrom": [0.0, 2.5, -7.0], "lookat": [0.0, 1.5, 0.0],
                   "up": [0, 1, 0], "vfov": 60.0},
        "image": {"width": JSON_FRAME["width"], "height": JSON_FRAME["height"],
                  "samples_per_pixel": JSON_FRAME["spp"],
                  "max_bounces": JSON_FRAME["bounces"], "background": [0.5, 0.6, 0.8]},
    }
    if obj is not None:
        doc["primitives"].append({"type": "obj", "path": obj})
    return doc


def phase_scene_json(torch, device, card):
    log(f"== phase 36: scene JSON: CornellBox spelled out at the serving shape against "
        f"the built-in scene (K1), and a textured scene at {JSON_FRAME['width']}x"
        f"{JSON_FRAME['height']}, {JSON_FRAME['spp']} spp, {JSON_FRAME['bounces']} "
        f"bounces without an OBJ (K3, draws) and with one (the projected route)")
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops.projected import default_route
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.scene.json_io import load_scene_json, save_scene_json
    from rust_pathtracer_tpu_torch.scene.obj_loader import write_benchmark_obj
    from rust_pathtracer_tpu_torch.utils.image import read_png, write_png

    folder = os.path.join(OUT_DIR, "json")
    os.makedirs(folder, exist_ok=True)
    sv = SERVE
    settings = RenderSettings(sv["width"], sv["height"], sv["spp"], sv["bounces"],
                              (0.0, 0.0, 0.0), spp_chunk=sv["spp_chunk"])
    key = prng_key(sv["seed"], device=device)
    save_scene_json(os.path.join(folder, "cornell.json"), CORNELL_DOC)
    sdj = load_scene_json(os.path.join(folder, "cornell.json"))
    sdb = get_scene("CornellBox")
    check(sdj.output.image == sdb.output.image, "CORNELL_DOC's image settings")
    _sync(torch, device)
    reset_counts()
    t0 = time.perf_counter()
    with capture_bounces(torch, JSON_HOLD_BOUNCES) as calls:
        img, st = render_radiance(sdj.build(device=device), sdj.camera_at(0.0, device=device),
                                  settings, key, device=device)
    _sync(torch, device)
    wall = time.perf_counter() - t0
    counts = read_counts()
    ref, rst = render_radiance(sdb.build(device=device), sdb.camera_at(0.0, device=device),
                               settings, key, device=device)
    check(torch.equal(img, ref) and float(st.segments) == float(rst.segments),
          "the JSON CornellBox differs from the built-in one")
    check(counts["K1"] == st.bounces, f"K1 launched {counts['K1']} times in {st.bounces} "
                                      "bounces")
    err, _ = hold_pools(torch, device, "JSON CornellBox", calls, ("K1",))
    log(f"JSON CornellBox {sv['width']}x{sv['height']}, {sv['spp']} spp: bit for bit the "
        f"built-in render (segments {float(st.segments):.0f}), {wall:.3f} s on {card} "
        f"(first render), launches {counts}")

    rng = np.random.default_rng(36)
    tex = np.clip(np.add.outer(np.arange(48) * 4, np.arange(64) * 3)[..., None]
                  + rng.integers(0, 40, (48, 64, 3)), 0, 255).astype(np.uint8)
    write_png(os.path.join(folder, "tex.png"), tex)
    check(np.array_equal(read_png(os.path.join(folder, "tex.png")), tex),
          "read_png does not give back write_png's texels")
    tris = write_benchmark_obj(os.path.join(folder, "model.obj"))
    key = prng_key(JSON_FRAME["seed"], device=device)
    for label, obj in (("textured", None), ("textured + OBJ", "model.obj")):
        path = os.path.join(folder, f"{label.replace(' + ', '_')}.json")
        save_scene_json(path, _textured_doc("tex.png", obj))
        sd = load_scene_json(path)
        t0 = time.perf_counter()
        scene = sd.build(device=device)
        build_s = time.perf_counter() - t0
        texels = scene.textures.images[0, :48, :64].cpu().numpy()
        check(np.array_equal(texels, (tex.astype(np.float32) / 255.0) ** 2.0),
              f"{label}: the image texture's texels")
        if scene.kinds_static is not None:
            kernels = ("K3", "draws")
        else:
            kernels = {"resident": ("K6",), "pairs": ("K7",),
                       "dense": ("K5",)}[default_route(scene.proj)] + ("draws",)
        cam = sd.camera_at(0.0, device=device)
        _sync(torch, device)
        reset_counts()
        t0 = time.perf_counter()
        with capture_bounces(torch, JSON_HOLD_BOUNCES) as calls:
            img, st = render_radiance(scene, cam, sd.output.image, key, device=device)
        _sync(torch, device)
        wall = time.perf_counter() - t0
        counts = read_counts()
        a = img.cpu().numpy()
        check(np.isfinite(a).all() and (a >= 0).all(), f"{label}: non-finite or negative")
        check(counts[kernels[0]] > 0 and counts["draws"] == st.bounces,
              f"{label}: launches {counts} in {st.bounces} bounces")
        e, _ = hold_pools(torch, device, f"JSON {label}", calls, kernels)
        err = max(err, e)
        log(f"JSON {label}: {scene.num_prims} primitives"
            + ("" if obj is None else f" ({tris} triangles)")
            + f", built in {build_s:.2f} s; {a.shape[1]}x{a.shape[0]} in {wall:.3f} s "
              f"(first render), mean {a.mean():.5f}, segments {float(st.segments):.0f}, "
              f"launches {counts}")
    return dict(max_abs_err=err)


@contextlib.contextmanager
def capture_fused_step(torch, bounce):
    """Wraps K1's wrapper (``fused_bounce.fused_bounce_keyed``) and K2's
    (``fused_bounce_bwd.fused_bounce_bwd``) as the differentiable fused
    trace calls them: the first K1-res call at ``bounce`` and the first K2
    call (the backward's last bounce) keep clones of their tensor
    arguments.  Yields {"K1-res" | "K2": (args, kwargs)}."""
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
    from rust_pathtracer_tpu_torch.ops import fused_bounce_bwd as fbb

    def clone(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, dict):
            return {k: clone(v) for k, v in x.items()}
        if isinstance(x, (tuple, list)):
            return type(x)(clone(v) for v in x)
        return x

    real_fwd, real_bwd, calls = fb.fused_bounce_keyed, fbb.fused_bounce_bwd, {}

    def fwd(*a, **k):
        if k.get("want_residuals") and a[5] == bounce and "K1-res" not in calls:
            calls["K1-res"] = (clone(a), dict(k))
        return real_fwd(*a, **k)

    def bwd(*a, **k):
        if "K2" not in calls:
            calls["K2"] = (clone(a), dict(k))
        return real_bwd(*a, **k)

    fb.fused_bounce_keyed, fbb.fused_bounce_bwd = fwd, bwd
    try:
        yield calls
    finally:
        fb.fused_bounce_keyed, fbb.fused_bounce_bwd = real_fwd, real_bwd


def phase_inverse(torch, device, card):
    from rust_pathtracer_tpu_torch.examples import inverse_rendering as inv
    from rust_pathtracer_tpu_torch.grad import render_loss_and_grad
    from rust_pathtracer_tpu_torch.ops import fused_bounce_bwd as fbb
    from rust_pathtracer_tpu_torch.sampling import prng_key

    s = inv.SETTINGS
    log(f"== phase 37: the inverse-rendering example, {s.width}x{s.height}, "
        f"{s.samples_per_pixel} spp, {s.max_bounces} bounces, {INVERSE_STEPS} Adam steps "
        f"on the card (K1-res, K2); its first loss against the CPU's")
    scene_c, _, target_c, params_c = inv.setup(s, device="cpu")
    loss_cpu, _ = render_loss_and_grad(params_c, scene_c, s, prng_key(inv.SEED), target_c,
                                       device="cpu")
    scene, truth, target, params = inv.setup(s, device=device)
    _sync(torch, device)
    reset_counts()
    t0 = time.perf_counter()
    ends = []  # each step ends in a device -> host fetch of its loss
    with capture_fused_step(torch, INVERSE_HOLD_BOUNCE) as calls:
        final, losses = inv.recover(scene, params, target, INVERSE_STEPS, s, device=device,
                                    on_step=lambda *_: ends.append(time.perf_counter()))
    _sync(torch, device)
    wall = time.perf_counter() - t0
    steps_ms = np.diff([t0] + ends) * 1e3
    counts = read_counts()
    row = final.tex_color[0].cpu().numpy()
    rel = abs(losses[0] - float(loss_cpu)) / abs(float(loss_cpu))
    log(f"{INVERSE_STEPS} steps in {wall:.3f} s on {card}: the first {steps_ms[0]:.2f} ms, "
        f"the median of the others {np.median(steps_ms[1:]):.2f} ms (min "
        f"{steps_ms[1:].min():.2f}, max {steps_ms[1:].max():.2f}); loss {losses[0]:.6e} -> {losses[-1]:.3e} "
        f"(CPU's first {float(loss_cpu):.6e}, rel {rel:.2e}); recovered {row.tolist()} "
        f"(true {list(inv.TRUE_ALBEDO)}); launches {counts}")
    check(rel <= INVERSE_LOSS_RTOL, f"the first loss {losses[0]} against the CPU's "
                                    f"{float(loss_cpu)}: rel {rel:.2e}")
    check(np.round(row.astype(np.float64), 3).tolist() == list(inv.TRUE_ALBEDO),
          f"recovered {row.tolist()}, want {inv.TRUE_ALBEDO} at 3 decimals")
    check(counts["K1-res"] > 0 and counts["K2"] > 0, f"launches {counts}")
    check(torch.equal(final.tex_color[1:], truth.tex_color[1:]),
          "a texture row other than the unknown one moved")

    args, kw = calls["K1-res"]
    runs = _keyed_runs(torch, args, kw)
    bad = _keyed_mismatches(runs)
    err = float(np.abs(runs["kernel"][0].view(np.float32).astype(np.float64)
                       - runs["plain"][0].view(np.float32)).max())
    check(not bad.any(), f"K1-res differs from its plain version on {int(bad.sum())} lanes "
                         f"of the example's bounce {INVERSE_HOLD_BOUNCE}")
    args, kw = calls["K2"]
    k_g, k_tex, k_bg = fbb.fused_bounce_bwd(*args, **kw)
    p_g, p_tex, p_bg = fbb.fused_bounce_bwd_plain(*args, **kw)
    got = torch.stack([k_g[k] for k in fbb._GRAD_KEYS]).double()
    want = torch.stack([p_g[k] for k in fbb._GRAD_KEYS]).double()
    red = torch.cat([k_tex.ravel(), k_bg]).double()
    red_want = torch.cat([p_tex.ravel(), p_bg]).double()
    for name, x, y in (("cotangent columns", got, want), ("reductions", red, red_want)):
        e = (x - y).abs()
        tol = K2_RTOL * y.abs() + K2_ATOL_REL * y.abs().max()
        check(bool((e <= tol).all()), f"K2's {name} differ from the plain version on the "
                                      "example's last bounce")
        err = max(err, float(e.max()))
    log(f"K1-res bit for bit its plain version on the pool of {runs['kernel'][0].shape[1]} "
        f"lanes at bounce {INVERSE_HOLD_BOUNCE}; K2 within phase 7's tolerance of its plain version on the "
        f"backward's last bounce (max abs err {err:.3e})")
    return dict(max_abs_err=err, step_ms=float(np.median(steps_ms[1:])))


# ---------------------------------------------------------------------------
# phases 38-41: the packed RNG scheme (K1 and the draw kernel) and the
# geometry gradient (diff_t="rederive": K4 and K5, then autograd)
# ---------------------------------------------------------------------------

PACKED = "packed"
# phase 40: the bench step's shape; phase 41: SphereField's own width
GEOM = dict(BENCH, seed=0)
GEOM_HOLD_BOUNCES = (0, 10, 19)  # K4 held to its plain version on these pools
# phase 40's step against the analytic (fused) step: the port's JAX
# tolerances (tests/test_torch_generic_grad.py)
GEOM_LOSS_RTOL, GEOM_LEAF_RTOL, GEOM_LEAF_ATOL = 2e-3, 0.05, 2e-3
PACKED_MEAN_RTOL = 0.01  # phase 39: packed against legacy, channel means and loss


def _packed_time(torch, device, card, label, legacy, packed, plain, reps, kernels,
                 bound_):
    """One packed kernel against its legacy self (A B B A, blocks of
    ``reps`` launches, CUDA events) and its packed plain twin; the packed
    kernel's device time (profiler).  Returns the kernels-line numbers."""
    ab = time_pair(torch, device, packed, legacy, reps)
    pp = time_pair(torch, device, packed, plain, reps, PLAIN_REPS)
    ms, leg = statistics.mean(ab["kernel"]), statistics.mean(ab["plain"])
    dev_ms, held = _device_ms(torch, packed, reps, kernels)
    leg_dev, leg_held = _device_ms(torch, legacy, reps, kernels)
    p_ms = statistics.mean(pp["plain"])
    log(f"{label} on {card}: packed {ms:.4f} ms per launch (legacy, packed, packed, "
        f"legacy: {[round(x, 4) for x in ab['plain'][:1] + ab['kernel'] + ab['plain'][1:]]}"
        f" ms; events), legacy {leg:.4f} ms ({leg / ms:.3f}x packed); device time packed "
        f"{dev_ms:.4f} ms ({held} of {reps} launches), legacy {leg_dev:.4f} ms "
        f"({leg_held} of {reps}; {leg_dev / dev_ms:.3f}x packed); packed plain version on "
        f"the same CUDA tensors {p_ms:.4f} ms; bound {bound_[0]:.4f} ms ({bound_[1]})")
    return dict(ms=ms, legacy_ms=leg, device_ms=(dev_ms, held, reps),
                legacy_device_ms=leg_dev, plain_ms=p_ms, bound_ms=bound_[0],
                bound_by=bound_[1])


def phase_packed_kernels(torch, device, card, n_lanes, reps):
    log(f"== phase 38: the packed scheme's K1, K1-res, K1 at per-lane depth and draw "
        f"kernel vs their packed plain versions on {n_lanes} random lanes, bit for bit")
    from rust_pathtracer_tpu_torch.integrator import T_MIN
    from rust_pathtracer_tpu_torch.ops import draws
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb

    cols_np, keys_np = random_lanes(n_lanes, seed=38)
    scene = full_scene(device)
    state, keys = _keyed_on(torch, cols_np, keys_np, device)
    depth = torch.as_tensor(np.random.default_rng(38).integers(
        0, REGEN_DEPTHS, n_lanes).astype(np.int32), device=device)
    base = (fb.pack_prims_shaded(scene), torch.tensor((0.2, 0.1, 0.05), device=device),
            scene.textures.perlin_seed, state, keys)
    kw0 = dict(kinds=scene.kinds_static, mat_types=scene.mat_types,
               tex_types=scene.tex_types, t_min=T_MIN, rng_scheme=PACKED)
    cases = [(f"K1 packed, bounce {b}, roulette {rr}, residuals {res}", base + (b,),
              dict(kw0, with_roulette=rr, want_residuals=res))
             for b in (0, 7) for rr in (False, True) for res in (False, True)]
    cases.append((f"K1 packed at per-lane depths 0-{REGEN_DEPTHS - 1}, roulette from "
                  f"{REGEN_RR_START}", base + (depth,),
                  dict(kw0, with_roulette=True, rr_start=REGEN_RR_START)))
    err = {"K1": 0.0, "K1-res": 0.0}
    for label, args, kw in cases:
        runs = _keyed_runs(torch, args, kw)
        _sync(torch, device)
        bad = _keyed_mismatches(runs)
        k_out, k_win, _ = runs["kernel"]
        which = "K1-res" if kw.get("want_residuals") else "K1"
        err[which] = max(err[which], float(np.abs(
            k_out.view(np.float32).astype(np.float64)
            - runs["plain"][0].view(np.float32)).max()))
        log(f"{label}: lanes differing from the plain version {int(bad.sum())}; hits "
            f"{int((k_win >= 0).sum())}, alive out "
            f"{int((k_out[12].view(np.float32) > 0.5).sum())}")
        check(not bad.any(), f"{label}: the kernel differs from its packed plain version")
        legacy = fb.fused_bounce_keyed(*args, **dict(kw, rng_scheme="legacy"))
        legacy = legacy[0] if isinstance(legacy, tuple) else legacy
        check(not np.array_equal(legacy.cpu().numpy().view(np.int32), k_out),
              f"{label}: the packed scheme drew the legacy stream")
    d_err = 0.0
    for label, bounce in ((DRAWS_SCALAR, 7), (DRAWS_PER_LANE, depth)):
        bad, e = _draws_mismatches(torch, device,
                                   draws.bounce_draws(keys, bounce, True, PACKED),
                                   draws.bounce_draws_plain(keys, bounce, True, PACKED))
        d_err = max(d_err, e)
        log(f"draw kernel packed, {label}: lanes differing from the plain version "
            f"{int(bad.sum())}")
        check(not bad.any(), f"the packed draw kernel differs from its plain version "
                             f"({label})")

    out = {}
    for name, b, res, kernels in (("K1", 7, False, ("fused_bounce_kernel",)),
                                  ("K1-res", 7, True, ("fused_bounce_kernel",)),
                                  ("K1 per-lane", depth, False, ("fused_bounce_kernel",))):
        kw = dict(kw0, with_roulette=True, want_residuals=res,
                  **({"rr_start": REGEN_RR_START} if name == "K1 per-lane" else {}))
        args = base + (b,)
        out[name] = _packed_time(
            torch, device, card, f"{name} ({n_lanes} lanes, roulette)",
            lambda a=args, k=kw: fb.fused_bounce_keyed(*a, **dict(k, rng_scheme="legacy")),
            lambda a=args, k=kw: fb.fused_bounce_keyed(*a, **k),
            lambda a=args, k=kw: fb.fused_bounce_keyed_plain(*a, **k), reps, kernels,
            k1_bound(torch, args, kw, residual_planes=10 if res else 0))
        out[name]["max_abs_err"] = err["K1-res" if res else "K1"]
    for name, bounce in (("draws " + DRAWS_SCALAR, 7), ("draws " + DRAWS_PER_LANE, depth)):
        out[name] = _packed_time(
            torch, device, card, f"{name} ({n_lanes} lanes, roulette)",
            lambda b=bounce: draws.bounce_draws(keys, b, True),
            lambda b=bounce: draws.bounce_draws(keys, b, True, PACKED),
            lambda b=bounce: draws.bounce_draws_plain(keys, b, True, PACKED), reps,
            ("bounce_draws_kernel",),
            draws_bound(torch, keys, bounce, draws.N_ROWS + 1, packed=True))
        out[name]["max_abs_err"] = d_err
    return out


def phase_packed_paths(torch, device, card, scenes, legacy_regen_diff):
    log("== phase 39: the packed paths at full size: serving CornellBox, the bench "
        "step, LightTest regen against chunked, the SphereField cascade")
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.wavefront import render_radiance_regen

    out = {}
    # serving CornellBox (phase 5's shape), packed against legacy
    cfg = SERVE
    sd = get_scene("CornellBox")
    cb = sd.build(device=device)
    cam = sd.camera_at(0.0, device=device)
    key = prng_key(cfg["seed"], device=device)
    serve = RenderSettings(cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"],
                           sd.output.image.background, spp_chunk=cfg["spp_chunk"])
    packed = dataclasses.replace(serve, rng_scheme=PACKED)
    render_radiance(cb, cam, packed, key, device=device)  # warm-up
    walls = {}
    for label, s in (("legacy", serve), ("packed", packed), ("packed", packed),
                     ("legacy", serve)):
        with count_threefry() as tf:
            wall, (img, stats), counts = _timed_render(
                torch, device, lambda s=s: render_radiance(cb, cam, s, key, device=device))
        walls.setdefault(label, []).append(wall)
        check(tf["loop"] == 0, f"the {label} serving loops called threefry in tensor ops")
        check(counts["K1"] == stats.bounces > 0 and counts["K1-res"] == 0,
              f"serving {label}: K1 launched {counts['K1']} times in {stats.bounces} "
              "bounces")
        if label == "packed":
            out["serving_k1"], p_img = counts["K1"], img
        else:
            l_img = img
    pm = p_img.double().mean(dim=(0, 1)).cpu().numpy()
    lm = l_img.double().mean(dim=(0, 1)).cpu().numpy()
    rel = np.abs(pm - lm) / lm
    log(f"serving CornellBox on {card}: walls (legacy, packed, packed, legacy) "
        f"{[round(w, 4) for w in walls['legacy'][:1] + walls['packed'] + walls['legacy'][1:]]}"
        f" s; channel means packed {pm.tolist()} legacy {lm.tolist()}, relative gaps "
        f"{rel.tolist()}; K1 launches {out['serving_k1']}")
    check(np.isfinite(p_img.cpu().numpy()).all(), "the packed serving image is not finite")
    check((rel <= PACKED_MEAN_RTOL).all(), "the packed serving image's channel means are "
                                           "more than 1% from legacy's")
    with capture_bounces(torch, (0, 10)) as calls:
        render_radiance(cb, cam, packed, key, device=device)
    check(calls and all(kw.get("rng_scheme") == PACKED for _, kw in calls.values()),
          "a serving pool was not drawn packed")
    out["k1_err"], _ = hold_pools(torch, device, "serving CornellBox packed", calls,
                                  ("K1",))

    # the bench-shaped step (phase 9's shape) under both schemes
    W, H, spp, nb = BENCH["width"], BENCH["height"], BENCH["spp"], BENCH["bounces"]
    steps = {}
    for scheme in ("legacy", PACKED):
        s = RenderSettings(W, H, spp, nb, (0.0, 0.0, 0.0), spp_chunk=spp,
                           differentiable=True, rng_scheme=scheme)
        leaves = _diff_leaves(torch, cb, CORNELL_CAM, s.background, device)
        k0 = prng_key(0, device=device)

        def step(s=s, leaves=leaves, k0=k0):
            _zero_grads(leaves)
            loss, stats = _diff_forward(cb, leaves, s, k0, device)
            loss.backward()
            return loss, stats

        step()
        _sync(torch, device)
        reset_counts()
        loss, _ = step()
        _sync(torch, device)
        counts = read_counts()
        steps[scheme] = (float(loss.detach()), _leaf_grads(leaves), counts, step, leaves)
        log(f"bench step {scheme}: loss {float(loss.detach()):.7f}, launches {counts}")
        check(counts["K1-res"] == counts["K2"] == nb and counts["K1"] == 0,
              f"the {scheme} bench step launched {counts}")
    (l_loss, l_g, *_), (p_loss, p_g, p_counts, *_) = steps["legacy"], steps[PACKED]
    check(all(np.isfinite(g).all() for g in p_g), "the packed step's gradients are not "
                                                  "all finite")
    check(abs(p_loss - l_loss) <= PACKED_MEAN_RTOL * abs(l_loss),
          f"the packed step's loss {p_loss} is more than 1% from legacy's {l_loss}")
    out["k1res_launches"] = p_counts["K1-res"]
    meds = {}
    for scheme in ("legacy", PACKED, PACKED, "legacy"):
        med, spread, times = _batch_median(steps[scheme][3], steps[scheme][4], MAIN_STEP)
        meds.setdefault(scheme, []).append((med, spread))
    log(f"bench step on {card} (legacy, packed, packed, legacy; median s over batches of "
        f"{MAIN_STEP['reps']}, spread): {meds['legacy'][0]}, {meds[PACKED]}, "
        f"{meds['legacy'][1]}; loss gap {abs(p_loss - l_loss) / abs(l_loss):.3e}")

    # LightTest regen against chunked, both packed (phase 21's shape)
    cfg = REGEN
    sd = get_scene("LightTest")
    lt = sd.build(device=device)
    cam = sd.camera_at(0.0, device=device)
    key = prng_key(cfg["seed"], device=device)
    s = RenderSettings(cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"],
                       sd.output.image.background, rng_scheme=PACKED)
    wall, (img, stats), counts = _timed_render(
        torch, device, lambda: render_radiance_regen(lt, cam, s, key, device=device))
    out["regen_k1"] = counts["K1"]
    check(counts["K1"] == stats.bounces + FLUSH_EVERY and stats.bounces > 0
          and counts["window_end"] == regen_window_end_launches(stats),
          f"the packed regen launched {counts} in {stats.bounces} bounce iterations")
    cwall, (cimg, cstats), _ = _timed_render(
        torch, device, lambda: render_radiance(lt, cam, s, key, device=device))
    diff = check_regen_vs_chunked(torch, "LightTest packed", img, stats, cimg, cstats)
    log(f"LightTest packed on {card}: regen {wall:.3f} s, chunked {cwall:.3f} s; regen "
        f"vs chunked max abs {diff:.3e} (legacy, phase 21: {legacy_regen_diff:.3e})")
    check(diff <= max(legacy_regen_diff, 1.2e-7),
          "the packed regen is further from chunked than the legacy one")

    # the SphereField cascade (phase 25's shape and explicit schedule), packed
    cfg = CASCADE_SF
    sd, sf = scenes["SphereField"]
    cam = sd.camera_at(0.0, device=device)
    key = prng_key(cfg["seed"], device=device)
    s = RenderSettings(cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"], SF_BG,
                       rng_scheme=PACKED)
    casc = dataclasses.replace(s, cascade_schedule=CASCADE_SF_SCHEDULE)
    _, (cimg, cstats), ccounts = _timed_render(
        torch, device, lambda: render_radiance(sf, cam, s, key, device=device))
    wall, (img, stats), counts = _timed_render(
        torch, device, lambda: render_radiance(sf, cam, casc, key, device=device))
    check_cascade_vs_chunked(torch, "SphereField packed", img, stats, cimg, cstats)
    check(counts["draws"] == counts["K6"] == stats.bounces,
          f"the packed cascade launched {counts}")
    out["cascade_draws"] = counts["draws"]
    with capture_bounces(torch, held_bounces(CASCADE_SF_SCHEDULE)) as calls:
        render_radiance(sf, cam, casc, key, device=device)
    out["cascade_err"], _ = hold_pools(torch, device, "SphereField cascade packed", calls,
                                       ("K6", "draws"))
    log(f"SphereField packed cascade {CASCADE_SF_SCHEDULE!r} on {card}: {wall:.4f} s, "
        f"bit for bit chunked; launches {counts} (chunked {ccounts})")
    return out


def _geometry_step(torch, scene, leaves, data, settings, key, device):
    """One step of loss = mean(img) with the DiffParams ``leaves`` and the
    geometry leaf ``data`` (``scene.prims.data``): each leaf's ``.grad``
    the step's gradient, zeros where the image does not depend on it."""
    _zero_grads(leaves + [data])
    loss, stats = _diff_forward(scene, leaves, settings, key, device)
    grads = torch.autograd.grad(loss, leaves + [data], allow_unused=True)
    for x, g in zip(leaves + [data], grads):
        x.grad = torch.zeros_like(x) if g is None else g
    return loss, stats


def _geometry_leaves(torch, scene):
    """``scene`` with ``prims.data`` a leaf, and the leaf."""
    data = scene.prims.data.detach().clone().requires_grad_(True)
    return dataclasses.replace(scene, prims=dataclasses.replace(scene.prims,
                                                                data=data)), data


@contextlib.contextmanager
def capture_searches(torch):
    """Wraps ``integrator.detached_search`` (K4, or K5 beyond 128
    primitives): yields a list that gets one (o, d, hit, t, idx) a call,
    clones, as a render runs."""
    from rust_pathtracer_tpu_torch import integrator

    fn, calls = integrator.detached_search, []

    def run(scene, table, o, d):
        hit, t, idx = fn(scene, table, o, d)
        calls.append((o.clone(), d.clone(), hit.clone(), t.clone(), idx.clone()))
        return hit, t, idx

    integrator.detached_search = run
    try:
        yield calls
    finally:
        integrator.detached_search = fn


def rederive_mismatches(torch, scene, calls):
    """Over the captured searches, the re-derived t (``prim_intersect_t``
    on the winner's row) against the search's t on the hit lanes: {hits,
    differ: lanes where a bit differs, invalid: lanes the re-derivation
    calls a miss, max_rel: the largest relative gap}."""
    from rust_pathtracer_tpu_torch.integrator import T_MAX, T_MIN
    from rust_pathtracer_tpu_torch.ops.intersect import gather_prim_rows, prim_intersect_t

    out = dict(hits=0, differ=0, invalid=0, max_rel=0.0)
    with torch.no_grad():
        for o, d, hit, t, idx in calls:
            kind, aux, data, _ = gather_prim_rows(scene.prims, idx)
            t_re, valid = prim_intersect_t(kind, aux, data.detach(), o, d, T_MIN, T_MAX,
                                           scene.prim_types)
            out["hits"] += int(hit.sum())
            out["differ"] += int((hit & (t_re.view(torch.int32) != t.view(torch.int32))).sum())
            out["invalid"] += int((hit & ~valid).sum())
            ok = hit & valid
            if bool(ok.any()):
                rel = ((t_re.double() - t.double()).abs() / t.double().abs())[ok]
                out["max_rel"] = max(out["max_rel"], float(rel.max()))
    return out


def gather_backward_ms(torch, device, idx, reps):
    """The geometry step's row-gather backward, as autograd runs it for
    ``prims.data[idx]``: an ``index_put_(accumulate=True)`` of (R, 12)
    cotangents into the (P, 12) rows, timed alone (CUDA events, mean of
    ``reps``) and run twice on one input: (ms, bitwise repeatable)."""
    P = int(idx.max()) + 1
    g = torch.as_tensor(np.random.default_rng(40).normal(size=(idx.shape[0], 12))
                        .astype(np.float32), device=device)
    idx = idx.long()

    def run():
        return torch.zeros((P, 12), device=device).index_put_((idx,), g, accumulate=True)

    same = torch.equal(run(), run())
    return _time_ms(torch, device, run, reps), same


def _index_backward_ms(torch, step):
    """One profiled ``step``: the device time of the CUDA kernels whose
    name holds "index" (the row gathers' backward, ``index_put_`` with
    accumulate, and the forward gathers), by kernel name, as a string."""
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    rows = [a for a in prof.key_averages()
            if a.device_type.name == "CUDA" and "index" in a.key.lower()]
    if not rows:
        return "no kernel whose name holds 'index' in the trace"
    return "; ".join(
        f"{a.key[:60]}: {a.count} launches, "
        f"{getattr(a, 'device_time_total', getattr(a, 'cuda_time_total', 0.0)) / 1e3:.3f} ms"
        for a in sorted(rows, key=lambda a: -getattr(a, "device_time_total",
                                                     getattr(a, "cuda_time_total", 0.0))))


def phase_geometry_step(torch, device, card):
    cfg = GEOM
    W, H, spp, nb = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"]
    lanes = W * H * spp
    log(f"== phase 40 (main path of the slice): the geometry-gradient step, CornellBox "
        f"{W}x{H}, {spp} spp, {nb} bounces, loss = mean(img), diff_t='rederive', "
        f"scene.prims.data a leaf beside the DiffParams leaves; K4 and the draw kernel")
    from rust_pathtracer_tpu_torch.integrator import T_MIN, resolve_remat_mode
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops import closest_hit as ch
    from rust_pathtracer_tpu_torch.ops.closest_hit import closest_hit_plain, pack_prims
    from rust_pathtracer_tpu_torch.render import RenderSettings
    from rust_pathtracer_tpu_torch.sampling import prng_key

    base = get_scene("CornellBox").build(device=device)
    scene, data = _geometry_leaves(torch, base)
    analytic = RenderSettings(W, H, spp, nb, (0.0, 0.0, 0.0), spp_chunk=spp,
                              differentiable=True)
    rederive = dataclasses.replace(analytic, diff_t="rederive")
    key = prng_key(cfg["seed"], device=device)
    leaves = _diff_leaves(torch, base, CORNELL_CAM, analytic.background, device)

    def step():
        return _geometry_step(torch, scene, leaves, data, rederive, key, device)

    t0 = time.perf_counter()
    loss0, _ = step()
    _sync(torch, device)
    log(f"first step {time.perf_counter() - t0:.3f} s (remat "
        f"{resolve_remat_mode(None, lanes, nb)!r})")
    g0 = _leaf_grads(leaves + [data])
    torch.cuda.reset_peak_memory_stats()
    mem0 = torch.cuda.memory_allocated()
    reset_counts()
    with capture_searches(torch) as calls:
        loss, stats = step()
        _sync(torch, device)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    grads = _leaf_grads(leaves + [data])
    gd = grads[-1]
    log(f"one step: loss {float(loss.detach()):.7f}, segments {float(stats.segments):.0f}, "
        f"launches {counts}, peak memory {peak / 1e9:.3f} GB ({(peak - mem0) / 1e9:.3f} "
        f"GB above the {mem0 / 1e9:.3f} GB before it)")
    check(counts["K4"] == counts["draws"] == nb, f"K4 and the draw kernel launched "
          f"{counts['K4']} and {counts['draws']} times, want {nb}")
    check(all(counts[k] == 0 for k in ("K1", "K1-res", "K2", "K3", "K5", "K6", "K7")),
          "the geometry step left the generic route (K1 or another search launched)")
    same = (float(loss0.detach()) == float(loss.detach()) and all(np.array_equal(a, b)
                                                for a, b in zip(g0, grads)))
    log(f"two steps on one key: loss, DiffParams and prims.data gradients bitwise "
        f"equal: {same}")
    check(same, "two geometry steps on one key differ")
    check(all(np.isfinite(g).all() for g in grads), "non-finite gradients")
    log(f"prims.data gradient: |g| max {np.abs(gd).max():.3e}, nonzero entries "
        f"{int(np.count_nonzero(gd))} of {gd.size}; spheres (rows 18, 19) "
        f"{gd[18:20, 0:4].tolist()}, the light rect's k {gd[4, 0]:.3e}")
    # every texture of CornellBox is a solid colour: under the
    # detached-sampling estimator the image is piecewise constant in the
    # geometry, and the gradient is zero, as JAX's is
    # (tests/test_torch_geometry_grad.py)
    check(not gd.any(), "CornellBox's prims.data gradient is not zero")

    rd = rederive_mismatches(torch, scene, calls)
    log(f"re-derived t against K4's t over the step's {len(calls)} searches: "
        f"{rd['differ']} of {rd['hits']} hit lanes differ, {rd['invalid']} called a miss")
    check(len(calls) == nb and rd["differ"] == rd["invalid"] == 0,
          "the re-derived t differs from K4's")
    table = pack_prims(scene.prims)
    err = 0.0
    for b in GEOM_HOLD_BOUNCES:
        o, d, hit, t, idx = calls[b]
        kw = dict(kinds=scene.kinds_static, t_min=T_MIN)
        got, want = ch.closest_hit(table, o, d, **kw), closest_hit_plain(table, o, d, **kw)
        _sync(torch, device)
        diff = sum(int((x.view(torch.int32) != y.view(torch.int32)).sum())
                   if x.dtype == torch.float32 else int((x != y).sum())
                   for x, y in zip(got, want))
        same_as_step = all(torch.equal(x, y) for x, y in zip(got, (hit, t, idx)))
        err = max(err, float((got[1] - want[1]).abs().max()))
        log(f"K4 on the step's pool of bounce {b} ({o.shape[0]} lanes, {int(hit.sum())} "
            f"hits): elements differing from the plain version {diff}; the step's "
            f"result again {same_as_step}")
        check(diff == 0 and same_as_step, f"K4 differs from its plain version on the "
                                          f"pool of bounce {b}")

    # against the analytic (fused) step of the same leaves
    def analytic_step():
        _zero_grads(leaves)
        loss, _ = _diff_forward(base, leaves, analytic, key, device)
        loss.backward()
        return loss

    reset_counts()
    a_loss = float(analytic_step().detach())
    a_g = _leaf_grads(leaves)
    a_counts = read_counts()
    check(a_counts["K1-res"] == nb and a_counts["K4"] == 0,
          f"the analytic step left the fused route: {a_counts}")
    gap = abs(float(loss) - a_loss) / abs(a_loss)
    log(f"analytic (fused) step: loss {a_loss:.7f}, the rederive loss's gap {gap:.3e}")
    check(gap <= GEOM_LOSS_RTOL, "the rederive loss is more than 2e-3 from the analytic")
    for name, g, ga in zip(LEAF_NAMES, grads[:-1], a_g):
        scale = np.abs(ga).max()
        worst = float(np.max(np.abs(g - ga) - GEOM_LEAF_RTOL * np.abs(ga))) / max(scale,
                                                                                 1e-30)
        log(f"  {name}: |g| max {scale:.3e}, the rederive step's worst excess over rtol "
            f"{GEOM_LEAF_RTOL} of {worst:.3e} x |g| max (bound {GEOM_LEAF_ATOL})")
        check(np.allclose(g, ga, rtol=GEOM_LEAF_RTOL, atol=GEOM_LEAF_ATOL * scale),
              f"the rederive step's {name} gradient is far from the analytic one")

    med, spread, times = _batch_median(step, leaves, MAIN_STEP)
    a_med, a_spread, _ = _batch_median(lambda: (analytic_step(), None), leaves,
                                             MAIN_STEP)
    g_ms, g_same = gather_backward_ms(torch, device, calls[0][4], 20)
    log(f"geometry step on {card}: median {med * 1e3:.2f} ms over {len(times)} batches of "
        f"{MAIN_STEP['reps']} (spread {spread:.3f}; batches "
        f"{[round(t * 1e3, 2) for t in times]} ms); the analytic (fused) step "
        f"{a_med * 1e3:.2f} ms (spread {a_spread:.3f}); peak memory {peak / 1e9:.3f} GB; "
        f"the row-gather backward (index_put_ accumulate, {lanes} lanes into "
        f"{scene.num_prims} rows) {g_ms:.4f} ms a bounce, {g_ms * nb:.3f} ms a step, "
        f"bitwise repeatable {g_same}")
    check(g_same, "the row-gather backward is not repeatable")
    in_step = _index_backward_ms(torch, step)
    log(f"in the step's backward (profiler): {in_step}")
    out = dict(ms=med * 1e3, analytic_ms=a_med * 1e3, peak_gb=peak / 1e9,
               gather_ms=g_ms, k4_launches=counts["K4"], max_abs_err=err)

    # where the image does change with the geometry: TwoSphereCheckers'
    # perlin sphere, at phase 12's shape
    cfg = MAIN
    tsc, tdata = _geometry_leaves(torch, get_scene("TwoSphereCheckers").build(device=device))
    s = RenderSettings(cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"], TSC_BG,
                       differentiable=True, diff_t="rederive")
    tleaves = _diff_leaves(torch, tsc, TSC_CAM, TSC_BG, device)
    tkey = prng_key(cfg["seed"], device=device)
    tg = []
    for _ in range(2):
        _zero_grads(tleaves + [tdata])
        reset_counts()
        t0 = time.perf_counter()
        tloss, _ = _diff_forward(tsc, tleaves, s, tkey, device)
        tloss.backward()
        _sync(torch, device)
        tg.append(tdata.grad.cpu().numpy())
        log(f"TwoSphereCheckers geometry step {cfg['width']}x{cfg['height']}: "
            f"{time.perf_counter() - t0:.3f} s, launches {read_counts()}")
    log(f"TwoSphereCheckers prims.data gradient (centre, radius): {tg[0][:, 0:4].tolist()}")
    check(np.array_equal(tg[0], tg[1]), "two TwoSphereCheckers geometry steps differ")
    check(np.isfinite(tg[0]).all() and (np.abs(tg[0][:, 0:3]).max(axis=1) > 0).all()
          and (tg[0][:, 3] != 0).all(),
          "a TwoSphereCheckers sphere's centre or radius has no gradient")
    return out


def phase_geometry_spherefield(torch, device, card, scenes):
    cfg = SF
    W, H, spp, nb = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"]
    log(f"== phase 41: the geometry gradient on a big scene, SphereField {W}x{H}, "
        f"{spp} spp, {nb} bounces, diff_t='rederive', K5 the search")
    from rust_pathtracer_tpu_torch.render import RenderSettings
    from rust_pathtracer_tpu_torch.sampling import prng_key

    sd, sf = scenes["SphereField"]
    scene, data = _geometry_leaves(torch, sf)
    s = RenderSettings(W, H, spp, nb, SF_BG, differentiable=True, diff_t="rederive")
    key = prng_key(cfg["seed"], device=device)
    leaves = _diff_leaves(torch, sf, SF_CAM, SF_BG, device)

    def step():
        return _geometry_step(torch, scene, leaves, data, s, key, device)

    t0 = time.perf_counter()
    step()
    _sync(torch, device)
    first = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    with capture_searches(torch) as calls:
        loss, stats = step()
        _sync(torch, device)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    g = data.grad
    spheres = scene.prims.kind == 0
    gc = g[spheres, 0:3]
    log(f"one step: loss {float(loss.detach()):.7f}, launches {counts}, peak memory "
        f"{peak / 1e9:.3f} GB; the spheres' centres' gradient: finite "
        f"{bool(torch.isfinite(gc).all())}, |g| max {float(gc.abs().max()):.3e}")
    check(counts["K5"] == counts["draws"] == nb, f"K5 launched {counts['K5']} times")
    check(all(counts[k] == 0 for k in ("K1", "K1-res", "K2", "K3", "K4", "K6", "K7")),
          "the SphereField geometry step left its route")
    check(bool(torch.isfinite(g).all()), "non-finite prims.data gradient")
    # K5 compares spheres in the q domain (t |d|^2, projected.py), so its t
    # and the re-derived one part by an ulp or two; none may turn a miss
    rd = rederive_mismatches(torch, scene, calls)
    log(f"re-derived t against K5's t: {rd['differ']} of {rd['hits']} hit lanes differ "
        f"in a bit (largest relative gap {rd['max_rel']:.3e}), {rd['invalid']} called a "
        "miss")
    check(rd["invalid"] == 0 and rd["max_rel"] <= 1e-6,
          "the re-derived t is far from K5's, or calls a hit a miss")
    med, spread, times = _batch_median(step, leaves, MAIN_STEP)
    log(f"SphereField geometry step on {card}: first {first:.3f} s, median "
        f"{med * 1e3:.2f} ms over {len(times)} batches of {MAIN_STEP['reps']} (spread "
        f"{spread:.3f}), peak memory {peak / 1e9:.3f} GB")
    return dict(ms=med * 1e3, peak_gb=peak / 1e9, k5_launches=counts["K5"], **rd)


# ---------------------------------------------------------------------------
# the pass-set reorder, remat "bf16" and the differentiable cascade
# (phases 42-45)
# ---------------------------------------------------------------------------

REORDER_TABLES = ("SphereField", "ModelTest", "ModelTest 20k")
# phase 43's frames: (label, scene, shape, background); the last is the
# cascade phases' SphereField frame, four chunks
REORDER_FRAMES = (("SphereField", "SphereField", "SF", (1.0, 1.0, 1.0)),
                  ("ModelTest", "ModelTest", "MT", (1.0, 1.0, 1.0)),
                  ("ModelTest 20k", "ModelTest 20k", "MT", (1.0, 1.0, 1.0)),
                  ("SphereField 8 spp", "SphereField", "CASCADE_SF", (1.0, 1.0, 1.0)))
PASSSET_DEAD_EVERY = 5         # phase 42: every fifth lane dead
REGEN_REORDER_ATOL = 2e-7      # phase 44: regen with the reorder against without
DIFF_CASCADE_LOSS_RTOL = 1e-6  # phase 45 (tests/test_grad.py's)
DIFF_CASCADE_RTOL, DIFF_CASCADE_ATOL = 1e-3, 1e-7
BF16_ERR = (1e-7, 1e-2)        # the gradient's normalised error under "bf16"
SEARCH_KERNEL = "sweep_kernel"  # K5, K6 and K7: one kernel of csrc/projected.cu


def passset_bound(tables, alive):
    """The least time for the keys of these lanes: the rays, alive flags
    and words written over the memory rate, against SLAB_OPS f32
    operations for each live lane and real cluster (the reciprocals
    three a live lane), over the f32 peak."""
    from rust_pathtracer_tpu_torch.ops.projected import passset_words

    n, live = alive.numel(), int(alive.sum())
    real = sum(k != -1 for k in tables.group_kinds)
    words = 1 + passset_words(tables.num_groups)
    return bound(n * (24 + 1 + 4 * words) + nbytes(tables.bounds8),
                 live * (real * SLAB_OPS + 3))


def kernel_device_ms(torch, fn, names):
    """One call of ``fn`` under the profiler (the device's trace):
    {name: [device ms, launches]} summed over the CUDA kernels whose name
    holds ``name``, and "busy": the device's busy ms."""
    from torch.profiler import ProfilerActivity, profile

    from profile_port import busy_ms

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for n in names:
        rows = [a for a in prof.key_averages()
                if a.device_type.name == "CUDA" and n in a.key]
        total = sum(getattr(a, "device_time_total", getattr(a, "cuda_time_total", 0.0))
                    for a in rows)
        out[n] = [total / 1e3, sum(a.count for a in rows)]
    out["busy"] = busy_ms(prof.events())
    return out


def phase_passset_kernel(torch, device, card, scenes, reps):
    log(f"== phase 42: the pass-set key kernel vs its plain version on {BIG_LANES} "
        f"lanes (every {PASSSET_DEAD_EVERY}th dead) of three tables, bit for bit")
    from rust_pathtracer_tpu_torch.integrator import T_MIN
    from rust_pathtracer_tpu_torch.ops import passset
    from rust_pathtracer_tpu_torch.ops.projected import (
        passset_perm, passset_sort_keys_plain, passset_words, sort_by_words,
    )

    out = {}
    for name, cfg in zip(REORDER_TABLES, (SF, MT, MT)):
        sd, scene = scenes[name]
        tables = scene.proj
        o, d = big_lanes(torch, device, name, sd, cfg, BIG_LANES)
        alive = torch.ones(o.shape[0], dtype=torch.bool, device=device)
        alive[::PASSSET_DEAD_EVERY] = False
        reset_counts()
        got = passset.passset_keys(tables, o, d, alive, T_MIN)
        launches = read_counts()["keys"]
        want = passset_sort_keys_plain(tables, o, d, alive, T_MIN)
        _sync(torch, device)
        W = passset_words(tables.num_groups)
        check(launches == 1, f"{name}: the key kernel launched {launches} times")
        check(got.shape == want.shape == (1 + W, o.shape[0]),
              f"{name}: keys of shape {tuple(got.shape)}, want {(1 + W, o.shape[0])}")
        bad = int((got != want).any(dim=0).sum())
        err = float((got.long() - want.long()).abs().max())
        perm_k = passset_perm(tables, o, d, alive, T_MIN)
        perm_p = sort_by_words(want)
        same_perm = torch.equal(perm_k, perm_p)
        live_first = bool(alive[perm_k][:int(alive.sum())].all())
        check(bad == 0, f"{name}: the keys differ from the plain version on {bad} lanes")
        check(same_perm and live_first, f"{name}: passset_perm of the kernel's keys and "
                                        "of the plain ones differ, or a dead lane "
                                        "sorts before a live one")
        ms = time_pair(torch, device, lambda: passset.passset_keys(tables, o, d, alive,
                                                                   T_MIN),
                       lambda: passset_sort_keys_plain(tables, o, d, alive, T_MIN), reps,
                       PLAIN_REPS)
        dev_ms = _device_ms(torch, lambda: passset.passset_keys(tables, o, d, alive, T_MIN),
                            reps, ("passset_keys_kernel",))
        perm_ms = statistics.mean(_time_ms(torch, device, lambda: passset_perm(
            tables, o, d, alive, T_MIN), reps) for _ in range(2))
        b_ms, b_by = passset_bound(tables, alive)
        groups = sum(k != -1 for k in tables.group_kinds)
        sets = int(torch.unique(want[:, alive], dim=1).shape[1])
        k_ms, p_ms = statistics.mean(ms["kernel"]), statistics.mean(ms["plain"])
        log(f"{name} ({groups} real clusters, {W} words) on {card}: 0 of {o.shape[0]} "
            f"lanes differ, permutations equal; {sets} distinct pass-sets among the live "
            f"lanes; kernel {k_ms:.4f} ms a launch ({[round(x, 4) for x in ms['kernel']]}),"
            f" device {dev_ms[0]:.4f} ms ({dev_ms[1]} of {reps} launches in the trace); "
            f"plain {p_ms:.2f} ms ({[round(x, 2) for x in ms['plain']]}); bound "
            f"{b_ms:.4f} ms ({b_by}); passset_perm (keys and {1 + W} stable sorts) "
            f"{perm_ms:.4f} ms")
        out[name] = dict(ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                         device_ms=dev_ms, max_abs_err=err, perm_ms=perm_ms)
    # the kernel's exact path at full size: the 20k table (the last above)
    # with an inverted box, +inf and NaN bounds, and lanes with an infinite
    # or NaN o or d among the finite ones
    cb = tables.cluster_bounds.clone()
    cb[[0, 3], 3] = cb[[3, 0], 3]
    cb[4, 5], cb[2, 7] = float("inf"), float("nan")
    flawed = dataclasses.replace(tables, cluster_bounds=cb)
    o, d = o.clone(), d.clone()
    d[9::97, 2], o[4::101, 1], o[6::103, 0] = float("inf"), float("-inf"), float("nan")
    for label, tab in (("the 20k table", tables), ("its flawed copy", flawed)):
        reset_counts()
        got = passset.passset_keys(tab, o, d, alive, T_MIN)
        launches = read_counts()["keys"]
        want = passset_sort_keys_plain(tab, o, d, alive, T_MIN)
        _sync(torch, device)
        bad = int((got != want).any(dim=0).sum())
        check(launches == 1 and bad == 0, f"{label} with non-finite lanes: "
                                          f"{launches} launches, {bad} lanes differ")
        ms = statistics.mean(_time_ms(torch, device, lambda: passset.passset_keys(
            tab, o, d, alive, T_MIN), reps) for _ in range(2))
        log(f"{label}, a lane in ~100 with an infinite or NaN o or d, on {card}: 0 of "
            f"{o.shape[0]} lanes differ; kernel {ms:.4f} ms a launch")
    return out


def passset_sizes(torch, keys):
    """Per lane, the clusters its pass-set holds: the popcount of its key
    words ((1 + W, R) int32; row 0 the dead flag, skipped)."""
    w = keys[1:].to(torch.int64) & 0xFFFFFFFF
    n = torch.zeros(keys.shape[1], dtype=torch.int64, device=keys.device)
    for bit in range(32):
        n += ((w >> bit) & 1).sum(dim=0)
    return n


def _reorder_cost(torch, device, tables, o, d, alive, reps):
    """The reorder's own work on one bounce's lanes: passset_perm and the
    gathers of the (R, 3) state planes, the alive row and the (2, R) key
    words; (events ms, device busy ms) a call."""
    from rust_pathtracer_tpu_torch.integrator import T_MIN
    from rust_pathtracer_tpu_torch.ops.projected import passset_perm

    thr, rad = o.clone(), d.clone()
    keys = torch.zeros((2, o.shape[0]), dtype=torch.int32, device=device)

    def reorder():
        perm = passset_perm(tables, o, d, alive, T_MIN)
        return [x[perm] for x in (o, d, thr, rad, alive)] + [keys[:, perm]]

    ms = statistics.mean(_time_ms(torch, device, reorder, reps) for _ in range(2))
    busy = kernel_device_ms(torch, reorder, ())["busy"]
    return ms, busy


def phase_reorder_frames(torch, device, card, scenes):
    log("== phase 43: the between-bounce reorder A/B (off, on, on, off), one call: the "
        "SphereField frame 854x480/2 spp (K6), ModelTest 800x800/1 spp on the 10k (K6) "
        "and 20k (K7, K5) meshes, and the SphereField frame at 8 spp (four chunks), 20 "
        "bounces; bit for bit with and without")
    from rust_pathtracer_tpu_torch import integrator
    from rust_pathtracer_tpu_torch.integrator import T_MIN
    from rust_pathtracer_tpu_torch.ops import worklist as WL
    from rust_pathtracer_tpu_torch.ops.passset import passset_keys
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key

    out = {}
    for name, table, shape, bg in REORDER_FRAMES:
        cfg = globals()[shape]
        sd, scene = scenes[table]
        W, H, spp, nb = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"]
        cam = sd.camera_at(0.0, device=device)
        key = prng_key(cfg["seed"], device=device)
        check(integrator.use_wavefront_reorder(scene), f"{name}: the default routing "
                                                       "does not reorder")

        def render(reorder, settings=RenderSettings(W, H, spp, nb, bg)):
            return render_radiance(scene, cam, dataclasses.replace(settings,
                                                                   reorder=reorder),
                                   key, device=device)

        runs = {}
        for reorder in (False, True):
            render(reorder)  # warm
            captured = []
            perm_fn = integrator.passset_perm

            def capture(tables, o, d, alive, t_min, _f=perm_fn):
                if not captured:
                    captured.append((o.clone(), d.clone(), alive.clone()))
                return _f(tables, o, d, alive, t_min)

            integrator.passset_perm = capture
            try:
                wall, (img, stats), counts = _timed_render(torch, device,
                                                           lambda: render(reorder))
            finally:
                integrator.passset_perm = perm_fn
            runs[reorder] = dict(img=img, stats=stats, counts=counts, lanes=captured)
        a, b = runs[False], runs[True]
        same = (torch.equal(a["img"], b["img"])
                and torch.equal(a["stats"].segments, b["stats"].segments)
                and torch.equal(a["stats"].occupancy, b["stats"].occupancy))
        check(same, f"{name}: the frame with the reorder differs from the one without "
                    "(image, segments or occupancy)")
        check(a["counts"]["keys"] == 0 < b["counts"]["keys"],
              f"{name}: the key kernel launched {a['counts']['keys']} / "
              f"{b['counts']['keys']} times without / with the reorder")
        walls = {False: [], True: []}
        for reorder in (False, True, True, False):
            walls[reorder].append(median_wall(torch, device, lambda: render(reorder))[0])
        dev = {r: kernel_device_ms(torch, lambda: render(r),
                                   (SEARCH_KERNEL, "passset_keys_kernel"))
               for r in (False, True)}
        o, d, alive = b["lanes"][0]
        cost_ms, cost_busy = _reorder_cost(torch, device, scene.proj, o, d, alive, 5)
        sizes = passset_sizes(torch, passset_keys(scene.proj, o, d, alive, T_MIN))[alive]
        over = int((sizes > WL.WL_KCAP).sum())
        n_re = b["counts"]["keys"]
        log(f"{name} on {card}: bit for bit with and without the reorder; walls (median "
            f"of 3 each, off on on off) off {[round(x, 4) for x in walls[False]]} s, on "
            f"{[round(x, 4) for x in walls[True]]} s; reordered bounces {n_re} of "
            f"{b['stats'].bounces}; launches off {a['counts']}, on {b['counts']}")
        for r in (False, True):
            ms, n = dev[r][SEARCH_KERNEL]
            log(f"  {'on ' if r else 'off'}: the search (K5/K6/K7) {ms:.3f} ms of device "
                f"time in {n} launches ({ms / max(n, 1):.4f} ms a bounce), the key kernel "
                f"{dev[r]['passset_keys_kernel'][0]:.3f} ms, device busy "
                f"{dev[r]['busy']:.2f} ms")
        log(f"  the reorder alone on the {int(alive.sum())} live of {alive.shape[0]} lanes "
            f"of its first reordered bounce: {cost_ms:.4f} ms a call by events, device "
            f"busy {cost_busy:.4f} ms (keys, {o.shape[0]}-lane stable sorts, gathers); "
            f"its live lanes' pass-sets: mean {float(sizes.double().mean()):.2f} "
            f"clusters, max {int(sizes.max())}; {over} lanes pass more than K7's "
            f"{WL.WL_KCAP} slots a block alone")
        out[name] = dict(walls={str(k): v for k, v in walls.items()},
                         device={str(k): v for k, v in dev.items()},
                         counts={str(k): runs[k]["counts"] for k in runs},
                         reorder_ms=cost_ms, reorder_busy_ms=cost_busy, img=b["img"],
                         stats=b["stats"])
    return out


def phase_reorder_regen_cascade(torch, device, card, scenes, frames):
    log(f"== phase 44: SphereField regen ({SF_REGEN['width']}x{SF_REGEN['height']}, "
        f"{SF_REGEN['spp']} spp) with the reorder against without; the 20k mesh's "
        "'auto' cascade (its schedule starts '1:1') against its chunked frame")
    from rust_pathtracer_tpu_torch.render import (
        RenderSettings, derive_cascade_schedule, render_radiance,
    )
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.wavefront import render_radiance_regen

    cfg = SF_REGEN
    sd, scene = scenes["SphereField"]
    cam = sd.camera_at(0.0, device=device)
    key = prng_key(cfg["seed"], device=device)
    base = RenderSettings(cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"], SF_BG)
    runs = {}
    for reorder in (False, True):
        wall, (img, st), counts = _timed_render(torch, device, lambda: render_radiance_regen(
            scene, cam, dataclasses.replace(base, reorder=reorder), key, device=device))
        runs[reorder] = (wall, img, st, counts)
    (w0, i0, s0, c0), (w1, i1, s1, c1) = runs[False], runs[True]
    diff = float((i0 - i1).abs().max())
    log(f"SphereField regen on {card}: off {w0:.4f} s, on {w1:.4f} s; max abs image "
        f"difference {diff:.3e} (bit for bit: {torch.equal(i0, i1)}); segments equal "
        f"{torch.equal(s0.segments, s1.segments)}; launches off {c0}, on {c1}")
    check(torch.equal(s0.segments, s1.segments) and torch.equal(s0.occupancy, s1.occupancy),
          "regen with the reorder: segments or occupancy differ")
    check(diff <= REGEN_REORDER_ATOL, f"regen with the reorder: the image moved {diff:.3e}")
    check(c0["keys"] == 0 < c1["keys"], f"regen: key kernel launches {c0['keys']} / "
                                        f"{c1['keys']}")

    cfg = MT
    sd, scene = scenes["ModelTest 20k"]
    cam = sd.camera_at(0.0, device=device)
    key = prng_key(cfg["seed"], device=device)
    chunked = RenderSettings(cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"],
                             (1.0, 1.0, 1.0))
    auto = dataclasses.replace(chunked, cascade_schedule="auto")
    sched = derive_cascade_schedule(scene, cam, chunked, key, device=device)
    check(sched is not None and sched.startswith("1:1,"),
          f"the 20k mesh's auto schedule {sched!r} does not start with '1:1'")
    wall, (img, st), counts = _timed_render(torch, device, lambda: render_radiance(
        scene, cam, auto, key, device=device))
    want, want_st = frames["ModelTest 20k"]["img"], frames["ModelTest 20k"]["stats"]
    check(torch.equal(img, want) and torch.equal(st.segments, want_st.segments)
          and torch.equal(st.occupancy, want_st.occupancy),
          "the 20k mesh's auto cascade differs from its chunked frame")
    med, walls = median_wall(torch, device, lambda: render_radiance(scene, cam, auto, key,
                                                                    device=device))
    cmed, cwalls = median_wall(torch, device, lambda: render_radiance(
        scene, cam, chunked, key, device=device))
    log(f"the 20k mesh through 'auto' ({sched}) on {card}: bit for bit the chunked frame; "
        f"median {med:.4f} s {[round(x, 4) for x in walls]} against chunked {cmed:.4f} s "
        f"{[round(x, 4) for x in cwalls]}; launches {counts}")
    check(counts["keys"] > 0, "the auto cascade launched the key kernel no time")
    return dict(regen_keys=c1["keys"], cascade_keys=counts["keys"])


def _step_once(torch, device, step, leaves):
    """(loss, stats, grads as numpy, peak GB, seconds) of one step after a
    warm-up step, peak memory counted from just before it."""
    step()
    _sync(torch, device)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    loss, stats = step()
    _sync(torch, device)
    secs = time.perf_counter() - t0
    return (float(loss.detach()), stats, _leaf_grads(leaves),
            torch.cuda.max_memory_allocated() / 1e9, secs)


def phase_bf16_diff_cascade(torch, device, card):
    cfg = MAIN
    W, H, spp, nb = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"]
    lanes = W * H * spp
    log(f"== phase 45: the TwoSphereCheckers step {W}x{H}, {spp} spp, {nb} bounces under "
        "remat 'bf16' and through a differentiable cascade, against remat 'none'")
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import RenderSettings, _derive_cascade_schedule
    from rust_pathtracer_tpu_torch.sampling import prng_key

    scene = get_scene("TwoSphereCheckers").build(device=device)
    key = prng_key(cfg["seed"], device=device)
    leaves = _diff_leaves(torch, scene, TSC_CAM, TSC_BG, device)
    none = RenderSettings(W, H, spp, nb, TSC_BG, differentiable=True, remat="none")

    def stepper(settings):
        def step():
            _zero_grads(leaves)
            loss, stats = _diff_forward(scene, leaves, settings, key, device)
            loss.backward()
            return loss, stats
        return step

    l0, st0, g0, peak0, t0 = _step_once(torch, device, stepper(none), leaves)
    occ = st0.occupancy.cpu().numpy()
    sched = _derive_cascade_schedule(occ, lanes, nb)
    check(sched is not None, "no differentiable cascade schedule pays on this step")
    modes = {"bf16": dataclasses.replace(none, remat="bf16"),
             "cascade": dataclasses.replace(none, diff_cascade=sched)}
    out = {"none": dict(loss=l0, peak_gb=peak0, secs=[t0])}
    flat0 = np.concatenate([g.ravel() for g in g0])
    for label, settings in modes.items():
        reset_counts()
        loss, st, g, peak, secs = _step_once(torch, device, stepper(settings), leaves)
        counts = read_counts()
        flat = np.concatenate([x.ravel() for x in g])
        rel = float(np.linalg.norm((flat - flat0).astype(np.float64))
                    / np.linalg.norm(flat0.astype(np.float64)))
        overflow = float(st.occupancy[-1])
        log(f"{label}{' ' + repr(sched) if label == 'cascade' else ''} on {card}: loss "
            f"{loss!r} against 'none' {l0!r}, gradient normalised "
            f"error {rel:.3e}, max abs {np.abs(flat - flat0).max():.3e}; peak memory "
            f"{peak:.3f} GB against {peak0:.3f}; step {secs:.3f} s against {t0:.3f}; "
            f"occupancy[-1] {overflow:.0f}; launches {counts} (two steps)")
        check(all(np.isfinite(x).all() for x in g), f"{label}: non-finite gradients")
        check(counts["K4"] == counts["draws"] == 2 * nb, f"{label}: K4 and the draw "
              f"kernel launched {counts['K4']} and {counts['draws']} times in two steps")
        if label == "bf16":
            check(loss == l0, f"bf16: the loss {loss!r} is not the f32-residual {l0!r}")
            check(BF16_ERR[0] < rel < BF16_ERR[1], f"bf16: the gradient's normalised "
                  f"error {rel:.3e} is outside {BF16_ERR}")
        else:
            check(overflow == 0.0, f"the differentiable cascade {sched!r} dropped "
                                   f"{overflow:.0f} live lanes")
            check(abs(loss - l0) <= DIFF_CASCADE_LOSS_RTOL * abs(l0),
                  f"the differentiable cascade's loss {loss!r} against {l0!r}")
            for n, a, b in zip(LEAF_NAMES, g, g0):
                check(np.allclose(a, b, rtol=DIFF_CASCADE_RTOL, atol=DIFF_CASCADE_ATOL),
                      f"the differentiable cascade's gradient of {n} differs: max abs "
                      f"{np.abs(a - b).max():.3e}")
        out[label] = dict(loss=loss, peak_gb=peak, secs=[secs], rel_err=rel,
                          schedule=sched if label == "cascade" else None)
    # the steps' times in turns: none, bf16, cascade, cascade, bf16, none
    for label in ("none", "bf16", "cascade", "cascade", "bf16", "none"):
        step = stepper(none if label == "none" else modes[label])
        _sync(torch, device)
        t = time.perf_counter()
        step()
        _sync(torch, device)
        out[label]["secs"].append(time.perf_counter() - t)
    log(f"step seconds on {card} (the first after a warm-up, then in turns none, bf16, "
        f"cascade, cascade, bf16, none): "
        + "; ".join(f"{k} {[round(x, 3) for x in v['secs']]}" for k, v in out.items()))
    return out


# ---------------------------------------------------------------------------
# phase 46: the camera lanes' kernel
# ---------------------------------------------------------------------------

LANES_RANDOM = 1_000_000
# the regen spawn held: the first fill (on the card the refills are the window
# end's respawn, ops/window_end.py, on the same per-lane code, csrc/camera_lane.cuh)
LANES_REGEN_AT = (0,)


def lanes_bound(torch, pixel, sample):
    """The lanes kernel's bound at its inputs: bytes, the base key, pixel
    and sample read once and the six 32-bit rows written once; operations,
    LANES_INT32_OPS and LANES_F32_OPS a lane (seven threefry blocks, ops/
    csrc/lanes.cu's header)."""
    R = pixel.shape[0]
    return bound(16 + nbytes(pixel, sample) + 6 * 4 * R, LANES_F32_OPS * R,
                 LANES_INT32_OPS * R)


def _lanes_mismatches(torch, device, got, want):
    """(lanes where any row of the lanes kernel's ``got`` differs in a bit
    from the plain twin's ``want``, the largest absolute difference of the
    f32 rows)."""
    _sync(torch, device)
    n = want[1].shape[0]
    bad, err = np.zeros(n, dtype=bool), 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        g = (g.T if i == 0 else g).contiguous().cpu().numpy().reshape(n, -1)
        w = (w.T if i == 0 else w).contiguous().cpu().numpy().reshape(n, -1)
        bad |= (g.view(np.int32) != w.view(np.int32)).any(axis=1)
        if i:
            err = max(err, float(np.abs(g.astype(np.float64) - w).max(initial=0.0)))
    return bad, err


@contextlib.contextmanager
def capture_lane_draws(torch, at):
    """Wraps ``render.camera_lane_draws`` (the lanes kernel's wrapper as
    every chunk and regen spawn calls it) so that its calls numbered ``at``
    keep clones of their arguments: yields ({call: (args, kwargs)}, [calls
    made])."""
    from rust_pathtracer_tpu_torch import render

    fn, calls, seen = render.camera_lane_draws, {}, [0]

    def wrapped(*a, **k):
        if seen[0] in at:
            calls[seen[0]] = (tuple(x.clone() for x in a), dict(k))
        seen[0] += 1
        return fn(*a, **k)

    render.camera_lane_draws = wrapped
    try:
        yield calls, seen
    finally:
        render.camera_lane_draws = fn


def phase_lanes(torch, device, card, reps, paths):
    log(f"== phase 46: the lanes kernel (ops/lanes.py, ops/csrc/lanes.cu) vs its plain "
        f"twin on {LANES_RANDOM} random lanes and on the bench, serving and regen "
        f"lanes, bit for bit")
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops import lanes
    from rust_pathtracer_tpu_torch.render import RenderSettings
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.wavefront import render_radiance_regen

    def on(x):
        return torch.as_tensor(x, dtype=torch.int64, device=device)

    rng = np.random.default_rng(46)
    key = prng_key(0, device=device)
    bw, bh, bspp = BENCH["width"], BENCH["height"], BENCH["spp"]
    sw, sh, schunk = SERVE["width"], SERVE["height"], SERVE["spp_chunk"]
    bpix, spix = torch.arange(bw * bh, device=device), torch.arange(sw * sh, device=device)
    sets = {
        "random": ((on(rng.integers(0, 854 * 480, LANES_RANDOM)),
                    on(rng.integers(0, 2000, LANES_RANDOM))),
                   dict(width=854, height=480, spp_total=2000)),
        "bench": ((torch.repeat_interleave(bpix, bspp), torch.arange(bspp, device=device)
                   .repeat(bw * bh)), dict(width=bw, height=bh, spp_total=bspp)),
        "serving": ((torch.repeat_interleave(spix, schunk), torch.arange(schunk, device=device)
                     .repeat(sw * sh)), dict(width=sw, height=sh, spp_total=SERVE["spp"])),
    }
    # the regen spawns of phase 21's LightTest render, as the render hands them
    sd = get_scene("LightTest")
    scene, cam = sd.build(device=device), sd.camera_at(0.0, device=device)
    settings = RenderSettings(REGEN["width"], REGEN["height"], REGEN["spp"],
                              REGEN["bounces"], sd.output.image.background)
    _sync(torch, device)
    reset_counts()
    with capture_lane_draws(torch, LANES_REGEN_AT) as (calls, seen):
        render_radiance_regen(scene, cam, settings, prng_key(REGEN["seed"], device=device),
                              device=device)
        _sync(torch, device)
    regen_launches = read_counts()["lanes"]
    log(f"LightTest regen: {seen[0]} spawns, {regen_launches} lanes kernel launches")
    check(0 in calls, f"the regen spawn {LANES_REGEN_AT} was not captured")
    for i, ((base, pixel, sample), kw) in sorted(calls.items()):
        check(torch.equal(base, key), "the regen spawn drew under another key")
        sets[f"regen spawn {i}"] = ((pixel, sample), kw)

    out = {}
    for label, ((pixel, sample), kw) in sets.items():
        def kernel(p=pixel, s=sample, kw=kw):
            return lanes.camera_lane_draws(key, p, s, **kw)

        def plain(p=pixel, s=sample, kw=kw):
            return lanes.camera_lane_draws_plain(key, p, s, **kw)

        bad, err = _lanes_mismatches(torch, device, kernel(), plain())
        R = pixel.shape[0]
        log(f"{label}: {R} lanes; lanes differing from the plain twin {int(bad.sum())} "
            f"(key words, s_vp, t_vp, disk), max abs difference {err:.3e}")
        for i in np.nonzero(bad)[0][:5]:
            def row(t, i=i):  # a lane's key words, s_vp, t_vp, disk
                return [t[0][:, i].tolist()] + [x[i].tolist() for x in t[1:]]

            log(f"  lane {i}: pixel {int(pixel[i])} sample {int(sample[i])}: kernel "
                f"{row(kernel())}; plain {row(plain())}")
        check(not bad.any(), f"the lanes kernel differs from its plain twin ({label})")
        res = time_pair(torch, device, kernel, plain, reps, PLAIN_REPS)
        k_ms, p_ms = statistics.mean(res["kernel"]), statistics.mean(res["plain"])
        dev_ms, held = _device_ms(torch, kernel, reps, ("camera_lanes_kernel",))
        b_ms, b_by = lanes_bound(torch, pixel, sample)
        log(f"lanes kernel, {label}, {R} lanes on {card}: {k_ms:.4f} ms per launch "
            f"(blocks {[round(x, 4) for x in res['kernel']]}; events around the wrapper), "
            f"{dev_ms:.4f} ms device time ({held} of {reps} launches); plain twin on the "
            f"same CUDA tensors {p_ms:.4f} ms ({[round(x, 4) for x in res['plain']]}); "
            f"bound {b_ms:.4f} ms ({b_by})")
        out[label] = dict(lanes=R, max_abs_err=err, ms=k_ms, device_ms=(dev_ms, held, reps),
                          plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
    paths = {**paths, "LightTest regen (phase 46)": regen_launches}
    log(f"lanes kernel launches a path: {paths}")
    check(all(v > 0 for v in paths.values()), f"a path launched the lanes kernel no time: "
          f"{paths}")
    return out, paths


# a chunk of the benchmark's spherefield-render: 854x480 at 16 spp,
# 6,558,720 lanes, 20 bounces, no roulette
SF_SHADE = dict(width=854, height=480, spp=16, bounces=20, seed=0)
SHADE_BOUNCES = (0, 1)  # the frame's first and second bounce
# f32 operations of a lane in the shade kernel: the upper end of
# csrc/shade.cu's count (100-200), under the bytes' time either way
SHADE_LANE_OPS = 200


def shade_args(torch, device, scene, sd, cfg, bg, at):
    """Clones of the arguments that the forward frame of ``cfg`` hands the
    shade kernel at each bounce in ``at`` (one call a bounce, in order):
    {bounce: args}.  The frame stops after the last."""
    from rust_pathtracer_tpu_torch import integrator
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key

    kernel, calls, seen = integrator.shade_bounce, {}, [0]

    def capture(*a):
        b = seen[0]
        seen[0] += 1
        if b in at:
            calls[b] = _clones(torch, a)
        if b >= max(at):
            raise _Captured(b)
        return kernel(*a)

    settings = RenderSettings(cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"], bg,
                              spp_chunk=cfg["spp"])
    integrator.shade_bounce = capture
    try:
        render_radiance(scene, sd.camera_at(0.0, device=device), settings,
                        prng_key(cfg["seed"], device=device), device=device)
    except _Captured:
        pass
    finally:
        integrator.shade_bounce = kernel
    check(sorted(calls) == sorted(at), f"the shade kernel's calls {sorted(calls)} were "
                                       f"captured, want {sorted(at)}")
    return calls


def _shade_mismatches(torch, device, got, want):
    """(bool a lane: an output of (o, d, thr, rad, alive) differs in its
    bits, max abs difference where one does) of the shade kernel against
    its plain twin."""
    _sync(torch, device)
    bad = torch.zeros(got[0].shape[0], dtype=torch.bool, device=got[0].device)
    err = 0.0
    for g, w in zip(got, want):
        if g.is_floating_point():
            diff = (g.view(torch.int32) != w.view(torch.int32)).any(dim=1)
            gap = (g.double() - w.double()).abs()[diff]
            err = max(err, float(gap.max()) if gap.numel() else 0.0)
        else:
            diff = g != w
        bad |= diff
    return bad.cpu().numpy(), err


def shade_bytes(args):
    """The bytes one shade launch moves at least: a lane's t and column,
    state, alive byte and uniforms in (and roulette's uniform and mask
    byte where given), its new state and alive byte out; the tables'
    payload once."""
    scene, search, state, draws_b, background, rr_u, rr_sel = args
    per_lane = (4 + 4 + 4 * 12 + 1 + 4 * 6 + (0 if rr_u is None else 4)
                + (0 if rr_sel is None else 1) + 4 * 12 + 1)
    return state[0].shape[0] * per_lane + 4 * scene.proj.payload.numel()


def phase_shade(torch, device, card, scenes, reps):
    cfg = SF_SHADE
    W, H, spp, nb = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"]
    log(f"== phase 47: the shade kernel (ops/shade.py, ops/csrc/shade.cu) vs its plain "
        f"twin (integrator.shade_bounce_plain) on the {W * H * spp} lanes of a SphereField "
        f"frame's first and second bounce ({W}x{H}, {spp} spp, one chunk, {nb} bounces), "
        f"bit for bit")
    from rust_pathtracer_tpu_torch.integrator import shade_bounce_plain
    from rust_pathtracer_tpu_torch.ops import shade

    sd, scene = scenes["SphereField"]
    calls = shade_args(torch, device, scene, sd, cfg, SF_BG, SHADE_BOUNCES)
    out = {}
    for b, args in sorted(calls.items()):
        def kernel(a=args):
            return shade.shade_bounce(*a)

        def plain(a=args):
            return shade_bounce_plain(*a)

        bad, err = _shade_mismatches(torch, device, kernel(), plain())
        search, state = args[1], args[2]
        R = state[0].shape[0]
        alive = int(state[4].sum())
        hits = int(((search[1] >= 0) & state[4]).sum())
        label = f"bounce {b + 1}"
        log(f"SphereField {label}: {R} lanes, {alive} alive, {hits} hits; lanes differing "
            f"from the plain twin {int(bad.sum())} (o, d, thr, rad, alive), max abs "
            f"difference {err:.3e}")
        check(not bad.any(), f"the shade kernel differs from its plain twin on SphereField "
                             f"{label}")
        res = time_pair(torch, device, kernel, plain, reps, PLAIN_REPS)
        k_ms, p_ms = statistics.mean(res["kernel"]), statistics.mean(res["plain"])
        dev_ms, held = _device_ms(torch, kernel, reps, ("shade_bounce_kernel",))
        n_bytes = shade_bytes(args)
        b_ms, b_by = bound(n_bytes, R * SHADE_LANE_OPS)
        log(f"shade kernel, SphereField {label}, {R} lanes on {card}: {k_ms:.4f} ms per "
            f"launch (blocks {[round(x, 4) for x in res['kernel']]}; events around the "
            f"wrapper), {dev_ms:.4f} ms device time ({held} of {reps} launches); plain "
            f"twin on the same CUDA tensors {p_ms:.4f} ms "
            f"({[round(x, 4) for x in res['plain']]}); bound {b_ms:.4f} ms ({b_by}: "
            f"{n_bytes / R:.1f} B a lane)")
        out[label] = dict(lanes=R, max_abs_err=err, ms=k_ms, device_ms=(dev_ms, held, reps),
                          plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by)
    return out


# ---------------------------------------------------------------------------
# phase 48: the regen window end
# ---------------------------------------------------------------------------

# the benchmark's lighttest-regen frame (benchmark/configs/lighttest.json,
# benchmark/traffic/regen-frames.json): LightTest at its published 854x480,
# 2000 spp and 50 bounces, a pool of 2**23 lanes
WE_FRAME = dict(width=854, height=480, spp=2000, bounces=50, lanes=1 << 23, seed=0)
WE_FULL = 5  # the sixth window end: the queue full, ~3/4 of the pool finished
WE_POOL_ROWS = ("state", "keys", "depth", "work", "pixel")
WE_SORT_KERNELS = ("DeviceRadixSort",)  # CUB's kernels


def capture_window_ends(torch, scene, cam, settings, key, lanes, device):
    """Clones of what the regen frame hands its window end at window
    WE_FULL and at the first window whose finished lanes outnumber the
    work left (the queue runs out inside it), and the frame's
    ``wavefront._Frame``: ({label: (pool rows, acc, hist, issued)}, fr).
    The frame stops there.  Reads the counts a window (a sync each)."""
    from rust_pathtracer_tpu_torch import wavefront
    from rust_pathtracer_tpu_torch.ops import window_end as W

    end, bounce = wavefront._window_end_device, wavefront._bounce
    total = settings.width * settings.height * settings.samples_per_pixel
    calls, frames, seen = {}, [], [0]

    def first_bounce(fr, pool):
        if not frames:
            frames.append(fr)
        return bounce(fr, pool)

    def capture(we, pool, acc, hist):
        k = seen[0]
        seen[0] += 1
        issued = int(we.ctl[W.CTL_HANDED])
        n_fin = int(((pool.state[12] <= 0.5) & (pool.work >= 0)).sum())
        label = ("full queue" if k == WE_FULL else "queue runs out"
                 if "queue runs out" not in calls and 0 < total - issued < n_fin else None)
        if label is not None:
            calls[label] = ({r: getattr(pool, r).clone() for r in WE_POOL_ROWS},
                            acc.clone(), hist.clone(), issued)
            log(f"window end {k} ({label}): {n_fin} of {lanes} lanes finished, "
                f"{total - issued} work items left")
        if len(calls) == 2:
            raise _Captured(k)
        return end(we, pool, acc, hist)

    wavefront._window_end_device, wavefront._bounce = capture, first_bounce
    try:
        wavefront.render_radiance_regen(scene, cam, settings, key, lanes=lanes, device=device)
    except _Captured:
        pass
    finally:
        wavefront._window_end_device, wavefront._bounce = end, bounce
    check(sorted(calls) == ["full queue", "queue runs out"],
          f"the window ends captured: {sorted(calls)}")
    return calls, frames[0]


def twin_window_end(torch, fr, pool, acc, hist, issued, total):
    """``wavefront._flush_refill`` (the tensor ops) with its radiance added
    in lane order, one f32 add at a time, as the window-end kernels add
    (CUDA's ``index_put_`` sums a pixel's values first): the finished
    lanes' pixels and radiance gathered before the twin runs on a scratch
    image, then added on the CPU with one thread.  Returns the twin's
    (hist, issued, lanes that took work, lanes finished)."""
    from rust_pathtracer_tpu_torch import wavefront

    fin = torch.nonzero((pool.state[12] <= 0.5) & (pool.work >= 0)).squeeze(1)
    pixel, rad = pool.pixel[fin].cpu(), pool.state[9:12, fin].T.cpu()
    hist, issued, n_take = wavefront._flush_refill(fr, pool, torch.zeros_like(acc), hist,
                                                   issued, total)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        acc.copy_(acc.cpu().index_put_((pixel,), rad, accumulate=True))
    finally:
        torch.set_num_threads(threads)
    return hist, issued, n_take, fin.shape[0]


def window_end_bytes(torch, rows, n_take, end_bit):
    """The bytes one window end on the pool ``rows`` moves at least, in
    which ``n_take`` lanes take work: the finish reads each lane's alive
    row, work, pixel and depth and writes its sort key and lane (28 B);
    the add reads a finished lane's sorted key, lane and radiance (20 B)
    and reads and writes each pixel it adds to once (24 B); the respawn
    reads each lane's alive row and work (8 B) and writes a taken lane's
    state rows, key words, depth, work and pixel (76 B), an untaken
    finished lane's work (4 B).  The sort apart: one pass that counts
    the digits (4 B a lane), then a pass a byte of the key's ``end_bit``
    bits that reads and writes every key and lane (16 B a lane).
    Returns (finished lanes, pixels added to, bytes, the sort's bytes)."""
    n = rows["work"].shape[0]
    fin = (rows["state"][12] <= 0.5) & (rows["work"] >= 0)
    n_fin = int(fin.sum())
    n_pix = int(torch.unique(rows["pixel"][fin]).numel())
    n_bytes = 36 * n + 20 * n_fin + 24 * n_pix + 76 * n_take + 4 * (n_fin - n_take)
    return n_fin, n_pix, n_bytes, 4 * n + 16 * n * -(-end_bit // 8)


def phase_window_end(torch, device, card, reps):
    cfg = WE_FRAME
    W_, H, spp, nb, n = cfg["width"], cfg["height"], cfg["spp"], cfg["bounces"], cfg["lanes"]
    log(f"== phase 48: the regen window end (ops/window_end.py, ops/csrc/window_end.cu, "
        f"CUB's sort) vs its plain twin (wavefront._flush_refill) on the {n}-lane pools of "
        f"the benchmark's LightTest frame ({W_}x{H}, {spp} spp, {nb} bounces), bit for bit")
    from rust_pathtracer_tpu_torch import wavefront
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops import window_end as W
    from rust_pathtracer_tpu_torch.render import RenderSettings
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from torch.profiler import ProfilerActivity, profile

    sd = get_scene("LightTest")
    scene, cam = sd.build(device=device), sd.camera_at(0.0, device=device)
    settings = RenderSettings(W_, H, spp, nb, sd.output.image.background)
    key = prng_key(cfg["seed"], device=device)
    total, npix = W_ * H * spp, W_ * H
    calls, fr = capture_window_ends(torch, scene, cam, settings, key, n, device)
    we = W.WindowEnd(n, width=W_, height=H, spp=spp, cam=fr.cam, key=fr.key, device=device)
    out = {}
    for label, (rows, acc0, hist0, issued) in calls.items():
        pool = wavefront._Pool(**{r: x.clone() for r, x in rows.items()})
        acc, hist = acc0.clone(), hist0.clone()

        def restore():
            for r, x in rows.items():
                getattr(pool, r).copy_(x)
            acc.copy_(acc0)
            hist.copy_(hist0)
            we.ctl.zero_()
            we.ctl[W.CTL_HANDED] = issued

        def kernel():
            we(pool, acc, hist)

        alive = int((rows["state"][12] > 0.5).sum())
        twin = wavefront._Pool(**{r: x.clone() for r, x in rows.items()})
        acc_t = acc0.clone()
        hist_t, issued_t, take_t, fin_t = twin_window_end(torch, fr, twin, acc_t, hist0.clone(),
                                                          issued, total)
        restore()
        before = W.launches
        kernel()
        _sync(torch, device)
        check(W.launches == before + 3, "a window end launched other than three kernels")
        ctl = we.ctl.tolist()
        bad = {}
        for what, a, b in (("acc", acc, acc_t), ("hist", hist, hist_t),
                           *((r, getattr(pool, r), getattr(twin, r)) for r in WE_POOL_ROWS)):
            a, b = a.cpu(), b.cpu()
            if a.dtype == torch.float32:
                a, b = a.view(torch.int32), b.view(torch.int32)
            bad[what] = int((a != b).sum())
        words = {"n_fin": (ctl[W.CTL_N_FIN], fin_t), "n_take": (ctl[W.CTL_N_TAKE], take_t),
                 "issued": (ctl[W.CTL_HANDED], issued_t),
                 "live": (ctl[W.CTL_LIVE], alive + take_t)}
        log(f"{label}: {fin_t} lanes finished, {take_t} took work, {alive} alive; entries "
            f"differing from the twin {bad}; device block (kernel, twin) {words}")
        check(not any(bad.values()), f"the window end differs from its twin ({label})")
        check(all(a == b for a, b in words.values()),
              f"the window end's device block differs from the twin's ({label})")

        def plain():  # the tensor-op window end as the card runs it
            wavefront._flush_refill(fr, pool, acc, hist, issued, total)

        ev = {"kernel": [], "twin": []}  # events around the call alone, in turns
        for side in ("twin", "kernel", "kernel", "twin"):
            for _ in range(reps if side == "kernel" else PLAIN_REPS):
                restore()
                ev[side].append(_events_ms(torch, kernel if side == "kernel" else plain)[0])
        restore()
        kernel()
        _sync(torch, device)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                restore()
                kernel()
            _sync(torch, device)
        by = {}
        for a in prof.key_averages():
            if a.device_type.name != "CUDA":
                continue
            name = next((k for k in ("window_end_finish", "window_end_add",
                                     "window_end_respawn") + WE_SORT_KERNELS if k in a.key),
                        None)
            if name is not None:
                t = getattr(a, "device_time_total", getattr(a, "cuda_time_total", 0.0))
                by[name] = by.get(name, 0.0) + t / 1e3 / reps
        dev_ms = sum(by.values())
        n_fin, n_pix, n_bytes, sort_bytes = window_end_bytes(torch, rows, take_t, we.end_bit)
        b_ms, b_by = bound(n_bytes, 0)
        sb_ms, _ = bound(sort_bytes, 0)
        k_ms, t_ms = statistics.median(ev["kernel"]), statistics.median(ev["twin"])
        log(f"window end, {label}, {n} lanes on {card}: {k_ms:.4f} ms by events (median of "
            f"{len(ev['kernel'])}; {[round(x, 4) for x in ev['kernel'][:4]]}...), device "
            f"{dev_ms:.4f} ms {({k: round(v, 4) for k, v in by.items()})}; the tensor-op twin "
            f"on the card {t_ms:.4f} ms ({[round(x, 3) for x in ev['twin']]}); bound "
            f"{b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, the sort apart) and the sort's "
            f"{sb_ms:.4f} ms ({sort_bytes / 1e6:.1f} MB, {-(-we.end_bit // 8)} passes)")
        out[label] = dict(lanes=n, finished=n_fin, taken=take_t, pixels=n_pix, ms=k_ms,
                          device_ms=dev_ms, by_kernel=by, plain_ms=t_ms, bound_ms=b_ms,
                          bound_by=b_by, sort_bound_ms=sb_ms)

    # CUB's sort (on the key's low end_bit bits, int32 lanes) against
    # torch.sort(stable=True) (all 32 bits, int64 indices) on the keys of
    # the full queue's window end: the same permutation
    rows = calls["full queue"][0]
    fin = (rows["state"][12] <= 0.5) & (rows["work"] >= 0)
    keys0 = torch.where(fin, rows["pixel"], npix).to(torch.int32)
    lanes0 = torch.arange(n, dtype=torch.int32, device=device)
    keys = torch.empty((2, n), dtype=torch.int32, device=device)
    vals = torch.empty((2, n), dtype=torch.int32, device=device)
    sel = [0]

    def cub():
        keys[0].copy_(keys0)
        vals[0].copy_(lanes0)
        sel[0] = W.sort_pairs(keys, vals, we.end_bit, we.scratch)

    cub()
    got = vals[sel[0]].clone()
    want = torch.sort(keys0, stable=True)
    check(torch.equal(got.long(), want.indices) and torch.equal(keys[sel[0]], want.values),
          "CUB's sort and torch.sort(stable=True) give other permutations")
    t = {"cub": [], "torch": []}  # CUB's with its copies of the keys and lanes in
    for side in ("torch", "cub", "cub", "torch"):
        for _ in range(reps):
            t[side].append(_events_ms(torch, cub if side == "cub" else
                                      (lambda: torch.sort(keys0, stable=True)))[0])
    copy_ms = statistics.median(_events_ms(torch, lambda: (keys[0].copy_(keys0),
                                                           vals[0].copy_(lanes0)))[0]
                                for _ in range(reps))
    sort = {k: statistics.median(v) for k, v in t.items()}
    log(f"sort of the full queue's {n} (pixel, lane) pairs on {card}: CUB on {we.end_bit} "
        f"bits {sort['cub'] - copy_ms:.4f} ms (events {sort['cub']:.4f} less the copies in "
        f"{copy_ms:.4f}); torch.sort(stable=True) {sort['torch']:.4f} ms; the same "
        f"permutation")
    out["sort"] = dict(cub_ms=sort["cub"] - copy_ms, torch_sort_ms=sort["torch"],
                       end_bit=we.end_bit)
    return out


# ---------------------------------------------------------------------------
# shared helpers: launch counts, batches, splits, bounds
# ---------------------------------------------------------------------------


def reset_counts():
    """Every kernel's launch count to 0."""
    from rust_pathtracer_tpu_torch.ops import closest_hit as ch
    from rust_pathtracer_tpu_torch.ops import draws
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
    from rust_pathtracer_tpu_torch.ops import fused_bounce_bwd as fbb
    from rust_pathtracer_tpu_torch.ops import (
        lanes, passset, projected, resident, shade, window_end, worklist,
    )

    fb.launches = fb.residual_launches = fbb.launches = draws.launches = 0
    ch.hit_launches = ch.record_launches = 0
    projected.launches = resident.launches = window_end.launches = 0
    worklist.launches = passset.launches = lanes.launches = shade.launches = 0


def read_counts():
    """Launches by kernel.  On the pair route K5 runs only as K7's
    overflow fallback, so there "K5" counts the fallbacks."""
    from rust_pathtracer_tpu_torch.ops import closest_hit as ch
    from rust_pathtracer_tpu_torch.ops import draws
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
    from rust_pathtracer_tpu_torch.ops import fused_bounce_bwd as fbb
    from rust_pathtracer_tpu_torch.ops import (
        lanes, passset, projected, resident, shade, window_end, worklist,
    )

    return {"K1": fb.launches - fb.residual_launches, "K1-res": fb.residual_launches,
            "K2": fbb.launches, "K3": ch.record_launches, "K4": ch.hit_launches,
            "K5": projected.launches, "K6": resident.launches, "K7": worklist.launches,
            "draws": draws.launches, "keys": passset.launches, "lanes": lanes.launches,
            "shade": shade.launches, "window_end": window_end.launches}


def _grad_sums(grads):
    return ", ".join(f"|{n}| {np.abs(g).sum():.6e}" for n, g in zip(
        ("tex_color", "tex_images", "background", "camera"),
        (*grads[:3], np.concatenate([g.ravel() for g in grads[3:]]))))


def _batch_median(step, leaves, cfg):
    """bench.py's protocol: batches of ``reps`` steps, each closed by a
    device -> host fetch of a gradient checksum and the loss; more
    batches while (max - min) / median > spread_tol.  Returns (median
    seconds a step, spread, sorted batch times)."""
    def batch():
        t0 = time.perf_counter()
        for _ in range(cfg["reps"]):
            loss, _ = step()
        sum(float(x.grad.abs().sum()) for x in leaves if x.grad is not None)
        float(loss.detach())
        return (time.perf_counter() - t0) / cfg["reps"]

    times = sorted(batch() for _ in range(cfg["batches"]))
    while ((times[-1] - times[0]) / times[len(times) // 2] > cfg["spread_tol"]
           and len(times) < cfg["max_batches"]):
        times.append(batch())
        times.sort()
    med = times[len(times) // 2]
    return med, (times[-1] - times[0]) / med, times


def _events_ms(torch, fn):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    out = fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b), out


def _step_split(torch, leaves, forward, lanes_fn):
    """A step's split by CUDA events, median of 3: lanes, the bounce loop
    (the forward less the lanes; every route draws its uniforms inside it,
    K1 in the kernel, the generic route with the draw kernel), the
    backward."""
    split = {"lanes": [], "forward": [], "backward": []}
    for _ in range(3):
        split["lanes"].append(_events_ms(torch, lanes_fn)[0])
        _zero_grads(leaves)
        ms, (loss, _) = _events_ms(torch, forward)
        split["forward"].append(ms)
        split["backward"].append(_events_ms(torch, loss.backward)[0])
    split = {k: statistics.median(v) for k, v in split.items()}
    split["loop"] = split["forward"] - split["lanes"]
    return split


def time_pair(torch, device, kernel, plain, reps, plain_reps=None):
    """A kernel and its plain version on the same inputs, in turns
    (plain, kernel, kernel, plain), blocks of ``reps`` launches each
    (``plain_reps`` calls a block of the plain version where given: the
    plain versions take 1-200 ms a call); CUDA events.  Returns {name:
    [ms a launch of each block]}."""
    ms = {"kernel": [], "plain": []}
    for name in ("plain", "kernel", "kernel", "plain"):
        ms[name].append(_time_ms(torch, device, kernel if name == "kernel" else plain,
                                 reps if name == "kernel" or plain_reps is None
                                 else plain_reps))
    return ms


def _spread(v):
    return (max(v) - min(v)) / statistics.mean(v)


def _device_ms(torch, fn, reps, kernels, attempts=8):
    """Device time of one call of ``fn``, the sum over the CUDA kernels
    it launches once a call, each named by a string its name holds
    (``kernels``), from ``torch.profiler``'s ``key_averages`` over
    ``reps`` calls after a warm-up: the kernels' own time, without the
    wrapper's host work that ``_time_ms``'s events also take in.  The
    trace should hold all ``reps`` launches of each; where it drops some
    (most readings hold 19 of 20; the draw kernel's often 0-9 of 20, up
    to four readings in a row), the reading is taken again, and the
    fullest one is kept once it holds at least half of them, after at
    most ``attempts`` readings: each
    kernel's mean is over the launches it holds.  Returns
    (ms, the fewest launches the trace held of one kernel); the kernels
    line shows both."""
    from torch.profiler import ProfilerActivity, profile

    best = None
    for attempt in range(attempts):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = {k: [a for a in prof.key_averages()
                    if a.device_type.name == "CUDA" and k in a.key] for k in kernels}
        counts = {k: sum(a.count for a in r) for k, r in rows.items()}
        if best is None or min(counts.values()) > min(best[1].values()):
            best = (rows, counts)
        if all(c == reps for c in counts.values()):
            break
        done = attempt + 1 == attempts or (attempt > 0 and
                                           min(best[1].values()) >= reps // 2)
        log(f"the profiler's trace held {counts} launches of {reps}"
            + ("; keeping the fullest" if done else "; reading again"))
        if done:
            break
    rows, counts = best
    check(all(reps // 2 <= c <= reps for c in counts.values()),
          f"the profiler saw {counts} launches, want {reps} of each")
    ms = 0.0
    for k, r in rows.items():
        total = sum(getattr(a, "device_time_total", getattr(a, "cuda_time_total", 0.0))
                    for a in r)
        ms += total / 1e3 / counts[k]
    return ms, min(counts.values())


def first_bounce_state(torch, o, d, lane_keys):
    """The keyed K1's inputs at a path's first bounce: the (13, R) state
    (camera rays, throughput 1, radiance 0, alive) and the lanes' (2, R)
    key words."""
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb

    ones = torch.ones_like(o[:, 0])
    zeros = torch.zeros_like(ones)
    state = torch.stack([o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2], ones,
                         ones, ones, zeros, zeros, zeros, ones])
    return state, fb.key_words(lane_keys)


@contextlib.contextmanager
def count_threefry():
    """Counts the calls of ``sampling.threefry2x32`` (the tensor-op
    threefry): ``all`` of them, and ``loop``, those made inside
    ``integrator._trace_fused`` (the fused route's bounce loops; the
    lanes are made before it)."""
    from rust_pathtracer_tpu_torch import integrator, sampling

    counts = {"all": 0, "loop": 0}
    inside = [False]
    threefry, trace_fused = sampling.threefry2x32, integrator._trace_fused

    def counted(*a):
        counts["all"] += 1
        counts["loop"] += inside[0]
        return threefry(*a)

    def loop(*a, **k):
        inside[0] = True
        try:
            return trace_fused(*a, **k)
        finally:
            inside[0] = False

    sampling.threefry2x32, integrator._trace_fused = counted, loop
    try:
        yield counts
    finally:
        sampling.threefry2x32, integrator._trace_fused = threefry, trace_fused


def k1_sweep_work(torch, args, kw, every):
    """(f32, f64) operations of K1's sweep on these lanes (``every`` lane,
    as with residuals, else the live ones), as these inputs need them: |d|^2 in
    f32 and f64 a lane, a rect's and a triangle's SWEEP_OPS, a sphere's
    K1_SPHERE_F64_OPS, and where its discriminant allows a root
    K1_ROOT1_F64_OPS more, and K1_ROOT2_F64_OPS where the first root fails
    (the plain version's sweep, in order, tells which)."""
    from rust_pathtracer_tpu_torch.ops.closest_hit import prim_candidate, sphere_roots
    from rust_pathtracer_tpu_torch.ops.intersect import T_MISS

    table, state = args[0], args[3]
    swept = torch.ones_like(state[12], dtype=torch.bool) if every else state[12] > 0.5
    o_c = tuple(state[k][swept] for k in range(3))
    d_c = tuple(state[k][swept] for k in range(3, 6))
    n = int(swept.sum())
    a = d_c[0] * d_c[0] + d_c[1] * d_c[1] + d_c[2] * d_c[2]
    best_t = torch.full_like(a, T_MISS)
    f32, f64 = 5 * n, 5 * n
    for p, (kind, aux) in enumerate(kw["kinds"]):
        if kind == 0:
            root1, _, dis = sphere_roots(o_c, d_c, tuple(table[r, p] for r in range(3)),
                                         table[3, p])
            real = dis >= 0.0
            first = real & (root1 >= kw["t_min"]) & (root1 <= best_t)
            f64 += (K1_SPHERE_F64_OPS * n + K1_ROOT1_F64_OPS * int(real.sum())
                    + K1_ROOT2_F64_OPS * int((real & ~first).sum()))
        else:
            f32 += SWEEP_OPS[kind] * n
        c = prim_candidate(table, p, kind, aux, o_c, d_c, a, kw["t_min"], best_t)
        best_t = torch.where(c["valid"] & (c["t"] < best_t), c["t"], best_t)
    return f32, f64


def k1_bound(torch, args, kw, residual_planes):
    """The keyed K1's bound at one launch's inputs: ``bound`` of ``k1_work``."""
    return bound(*k1_work(torch, args, kw, residual_planes))


def k1_work(torch, args, kw, residual_planes):
    """The keyed K1's work at one launch's inputs (``args``, ``kw`` of
    ``fused_bounce_keyed``), as (bytes, f32, int32, f64 operations): bytes, each input read once (table, 13
    columns, 2 key words, a per-lane depth) and each output written once
    (13 columns, ``residual_planes``, roulette's p with residuals); against
    the operations these lanes need, on their pipes: the sweep's
    (``k1_sweep_work``: f32, and a sphere's quadratic in f64), then by the
    winner's material and texture, from one check launch with
    ``winner_out``: the winner's normal, the shading (K1_LANE_OPS, the
    background on a miss, K1_MAT_OPS: the scatter's sine and cosine, the
    dielectric's terms, the metal's cube root as one f64 power;
    K1_TEX_OPS: the checker's three sines, the marble's seven octaves and
    their hashes in int32), with residuals their planes on every lane
    (K1_RES_LANE_OPS, the dielectric terms, the texture of every found
    lane), and the draws in int32: under the legacy scheme a lambertian
    lane 2 uniforms, a metal 3, a dielectric 1 (with residuals every lane
    draws the coin in a scene with a dielectric), a continuing lane 1 more
    under roulette (at a per-lane depth, only from ``rr_start`` on), each
    purpose behind a fold; under the packed scheme only the blocks that
    hold its words: a lambertian 1, a metal 2, a dielectric coin 1,
    roulette 1."""
    from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
    from rust_pathtracer_tpu_torch.scene.types import (
        MAT_DIELECTRIC, MAT_LAMBERTIAN, MAT_METAL, TEX_PERLIN,
    )

    table, bg, _, state, keys, bounce = args
    R = state.shape[1]
    win = torch.empty(R, dtype=torch.int32, device=state.device)
    out = fb.fused_bounce_keyed(*args, **dict(kw, with_roulette=False, want_residuals=False),
                                winner_out=win)
    row = table[:, win.clamp(min=0).long()]
    mk, tk = row[fb.PAY_MKIND], row[fb.PAY_TKIND]
    hit = win >= 0  # -1 on a miss or a dead lane
    alive = state[12] > 0.5

    def lanes_of(m, where=hit):
        return int((where & (mk == float(m))).sum())

    def tex_of(t, where=hit):
        return int((where & (tk == float(t))).sum())

    f32, f64 = k1_sweep_work(torch, args, kw, every=bool(residual_planes))
    f32 += (K1_LANE_OPS * int(alive.sum()) + K1_MISS_OPS * int((alive & ~hit).sum())
            + sum(K1_MAT_OPS[m] * lanes_of(m) for m in K1_MAT_OPS)
            + sum(K1_TEX_OPS[t] * tex_of(t) for t in K1_TEX_OPS)
            + K1_NORMAL_OPS * int((hit & (row[12] == 0.0)).sum()))  # row 12: the kind
    f64 += lanes_of(MAT_METAL)
    int_ops = K1_MARBLE_INT_OPS * tex_of(TEX_PERLIN)
    if residual_planes:  # the planes of every lane (a texture once, on the hits)
        f32 += R * (K1_RES_LANE_OPS + (K1_RES_DIELECTRIC_OPS
                                       if MAT_DIELECTRIC in kw["mat_types"] else 0))
    coins = (R if residual_planes and MAT_DIELECTRIC in kw["mat_types"]
             else lanes_of(MAT_DIELECTRIC))
    rr = kw["with_roulette"]
    per_lane = isinstance(bounce, torch.Tensor)
    rr_lanes = (out[12] > 0.5) & (bounce >= kw.get("rr_start", 0) if per_lane else True)
    singles = coins + (int(rr_lanes.sum()) if rr else 0)
    if kw.get("rng_scheme", "legacy") == "packed":
        int_ops += (lanes_of(MAT_LAMBERTIAN) * packed_ops(1, 2)
                    + lanes_of(MAT_METAL) * packed_ops(2, 3) + singles * packed_ops(1, 1))
    else:
        int_ops += (lanes_of(MAT_LAMBERTIAN) * draw_ops(2)
                    + lanes_of(MAT_METAL) * draw_ops(3) + singles * draw_ops(1))
    planes_out = 13 + residual_planes + (1 if residual_planes and rr else 0)
    in_bytes = nbytes(table, bg, state, keys) + (nbytes(bounce) if per_lane else 0)
    return in_bytes + planes_out * 4 * R, f32, int_ops, f64


# The card's peaks (NVIDIA H100 SXM data sheet; f64 outside the tensor cores)
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12
PEAK_F64_PER_S = 34e12
# int32 operations: the dispatch limit, one warp instruction a clock on each
# of an SM's four schedulers (128 lanes a clock) on each of 132 SMs at the
# 1.98 GHz boost clock (NVIDIA Hopper architecture white paper).  Not the 64
# INT32 units an SM: the compiler runs integer adds as IMAD on the FMA pipe
# too, and the draw kernel (phase 20) runs faster than 64 a clock allows
PEAK_INT32_PER_S = 128 * 132 * 1.98e9
# int32 operations of one threefry-2x32 block (ops/csrc/threefry.cuh: the
# key schedule 2, the key added 2, 20 rounds of add, rotate and xor 60,
# five injections of 3) and of turning its words into a uniform (xor,
# shift, or)
THREEFRY_BLOCK_OPS, THREEFRY_UNIFORM_OPS = 79, 3
PACKED_UNIFORM_OPS = 3
# the lanes kernel a lane (ops/csrc/lanes.cu's header): seven threefry blocks,
# the four uniforms' bits, and the counter, column and row; f32: two
# conversions, two adds, two divisions, four subtractions, a square root, a
# product, a cosine, a sine and two products
LANES_INT32_OPS = 7 * THREEFRY_BLOCK_OPS + 4 * THREEFRY_UNIFORM_OPS + 6
LANES_F32_OPS = 16
# f32 operations a lane spends on one primitive in the sweep of K1, K3
# and K4, counted from the kernel sources (divisions and square roots
# count one; compares and selects none): a lower bound of the work
SWEEP_OPS = {0: 24, 1: 6, 2: 46}
# K1's work a lane past the sweep's rects and triangles (counted from
# ops/csrc/fused_bounce.cu as SWEEP_OPS are; a sine, a cosine, a square root
# or a division counts one, a compare, a select or a conversion none).
# A sphere's quadratic in f64: o - c 3, half_b 5, |o - c|^2 - r^2 7, the
# discriminant 3; where it is >= 0 its square root, the first root's
# subtraction and division; where that root fails the second's add and
# division.  |d|^2 (5) in f32 and in f64 a lane (k1_sweep_work)
K1_SPHERE_F64_OPS, K1_ROOT1_F64_OPS, K1_ROOT2_F64_OPS = 18, 3, 2
# a live lane: the hit point 6, the front test 5 and flip 3, the commit's
# throughput 3, roulette's p 3; a miss: the background 6; a winning
# sphere's normal (o + t d - c) / r 9
K1_LANE_OPS, K1_MISS_OPS, K1_NORMAL_OPS = 20, 6, 9
# the scatter by the winner's material (MAT_*): the lambertian's sphere
# sample (z, the angle, the ring's radius, a cosine and a sine: 9) and
# n + s; the metal's sphere sample, its ball (the cube root, an f64 power,
# counted on the f64 pipe), the unit direction, the reflection, the
# grazing test and the fuzz; the dielectric's terms with the reflected
# direction (the cheaper branch); a light's emission
K1_MAT_OPS = {0: 12, 1: 42, 2: 41, 3: 6}
# the texture by its kind (TEX_*): the checker's three products, three
# sines and two products; the marble's seven octaves (floor, fraction,
# fade, eight gradients and seven lerps, the sum: 65) and its sine and
# five terms, and in int32 each octave's eight corner hashes (14 each),
# gradient picks (3 each) and three corner indices
K1_TEX_OPS = {1: 8, 2: 7 * 65 + 6}
K1_MARBLE_INT_OPS = 7 * (8 * (14 + 3) + 3)
# with residuals, each lane's planes: the point, the flip and normal, the
# flags' tests, flip / r (16); in a scene with a dielectric its terms on
# every lane (35)
K1_RES_LANE_OPS, K1_RES_DIELECTRIC_OPS = 16, 35
# K3's record on top: a sphere's normal, a rect's uv, and per lane the
# front test, the point, the flip and the sphere uv
RECORD_OPS = {0: 12, 1: 6, 2: 0}
RECORD_LANE_OPS = 20
# K2 per lane (the per-lane VJP, fused_bounce_bwd.cu's header)
K2_LANE_OPS = 150
# K2's two CUDA kernels: the VJP with the per-block partial sums, and the
# sum over blocks
K2_KERNELS = ("fused_bounce_bwd_kernel", "reduce_partials_kernel")


def bound(n_bytes, n_ops, n_int_ops=0, n_f64_ops=0):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations' time, the larger of the f32
    operations over the f32 peak plus the int32 operations over the int32
    rate, and the f64 operations over the f64 peak (an SM's FP64 units
    are a pipe of their own, beside the FP32 and INT32 ones)."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(n_ops / PEAK_F32_PER_S + n_int_ops / PEAK_INT32_PER_S,
                n_f64_ops / PEAK_F64_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def draw_ops(n_uniforms):
    """int32 operations of drawing ``n_uniforms`` of one purpose: the
    purpose's key (one block), then one block and its bits a uniform."""
    return THREEFRY_BLOCK_OPS * (1 + n_uniforms) + THREEFRY_UNIFORM_OPS * n_uniforms


def packed_ops(n_blocks, n_words):
    """Operations of the packed scheme's draws: ``n_blocks`` counter-mode
    blocks (no purpose key) and ``n_words`` words made uniforms (a shift,
    a conversion and a product each)."""
    return THREEFRY_BLOCK_OPS * n_blocks + PACKED_UNIFORM_OPS * n_words


def sweep_ops(kinds, lanes, record=False):
    per_lane = 5 + sum(SWEEP_OPS[k] + (RECORD_OPS[k] if record else 0)
                       for k, _ in kinds)
    return lanes * (per_lane + (RECORD_LANE_OPS if record else 0))


def nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def _time_ms(torch, device, fn, reps):
    """Mean ms per call over ``reps`` calls after one warm-up call:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def main() -> int:
    faulthandler.enable()  # a crash in native code prints the Python stack
    if not os.path.isdir(os.path.join(REPO, "rust_pathtracer_tpu_torch")):
        print("FAIL: run chip_smoke.py from a checkout of the repository: "
              "rust_pathtracer_tpu_torch/ is not beside it", flush=True)
        return 2
    sys.path.insert(0, REPO)
    import torch

    device = "cuda"
    clock = [time.perf_counter()]

    def took(n):
        now = time.perf_counter()
        log(f"phase {n} took {now - clock[-1]:.1f} s")
        clock.append(now)

    card = phase_device(torch)
    phase_build()
    took(2)
    max_abs = phase_kernel_vs_plain(torch, device, K1_LANES)
    took(3)
    phase_goldens(torch, device)
    took(4)
    k1 = phase_serve(torch, device, card, SERVE, BENCH, time_reps=20)
    took(5)
    res_err, cols_np, res_np = phase_residuals(torch, device, K1_LANES)
    took(6)
    k2_err = phase_bwd_vs_plain(torch, device, cols_np, res_np)
    took(7)
    keyed_err = phase_keyed_vs_plain(torch, device, K1_LANES)
    took(18)
    phase_small_step(torch, device)
    took(8)
    step = phase_bench_step(torch, device, card, time_reps=20)
    took(9)
    ch10 = phase_closest_hit_vs_plain(torch, device, card, K1_LANES, time_reps=20)
    took(10)
    k3 = phase_generic_forward(torch, device, card, time_reps=20)
    took(11)
    k4 = phase_main_step(torch, device, card, time_reps=20)
    took(12)
    phase_light_step(torch, device, card)
    took(13)
    scenes = big_scenes(device)
    ph14 = phase_projected_vs_plain(torch, device, card, scenes, reps=20)
    took(14)
    k6, k5, shade_launches = phase_spherefield_forward(torch, device, card, scenes, reps=20)
    took(15)
    k7, k5_fallback, k6_later = phase_modeltest_forward(torch, device, card, scenes,
                                                        reps=20)
    took(16)
    k5["later"] += k5_fallback
    k6["later"] += k6_later
    k5["launches"] = phase_spherefield_step(torch, device, card)
    took(17)
    k1_lane = phase_k1_per_lane(torch, device, card, K1_LANES, reps=20)
    took(19)
    dr = phase_draws_vs_plain(torch, device, card, K1_LANES, reps=20)
    took(20)
    regen = phase_regen_light(torch, device, card)
    took(21)
    sf_regen = phase_regen_spherefield(torch, device, card, scenes)
    took(22)
    phase_regen_card_vs_cpu(torch, device)
    took(23)
    phase_sf_frame_hoisted(torch, device, card, scenes)
    took(24)
    casc = phase_cascade_spherefield(torch, device, card, scenes)
    took(25)
    phase_cascade_modeltest(torch, device, card, scenes)
    took(26)
    phase_cascade_serving(torch, device, card)
    took(27)
    phase_cascade_generic(torch, device, card)
    took(28)
    phase_cascade_overflow(torch, device, scenes)
    took(29)
    phase_checkpoint_resume(torch, device, card, scenes, casc["chunked"])
    took(30)
    os.makedirs(OUT_DIR, exist_ok=True)
    phase_sharded(torch, device, card)
    took("31-34")
    for n, phase in ((35, phase_animation), (36, phase_scene_json), (37, phase_inverse)):
        phase(torch, device, card)
        took(n)
    pk = phase_packed_kernels(torch, device, card, K1_LANES, reps=20)
    took(38)
    pp = phase_packed_paths(torch, device, card, scenes, regen["vs_chunked"])
    took(39)
    geo = phase_geometry_step(torch, device, card)
    took(40)
    geo_sf = phase_geometry_spherefield(torch, device, card, scenes)
    took(41)
    keys42 = phase_passset_kernel(torch, device, card, scenes, reps=20)
    took(42)
    frames = phase_reorder_frames(torch, device, card, scenes)
    took(43)
    phase_reorder_regen_cascade(torch, device, card, scenes, frames)
    took(44)
    phase_bf16_diff_cascade(torch, device, card)
    took(45)
    lanes46, lane_paths = phase_lanes(torch, device, card, reps=20, paths={
        "serving (phase 5)": k1["lanes_launches"],
        "bench step (phase 9)": step["lanes_launches"],
        "LightTest regen (phase 21)": regen["lanes_launches"],
        "SphereField regen (phase 22)": sf_regen["lanes_launches"]})
    took(46)
    shade47 = phase_shade(torch, device, card, scenes, reps=20)
    took(47)
    we48 = phase_window_end(torch, device, card, reps=20)
    took(48)
    log(f"phases 2-48 took {clock[-1] - clock[0]:.1f} s")

    def sweep_err(kernel, main):
        errs = [main["max_abs_err"]] + [v["max_abs_err"] for (_, k), v in ph14.items()
                                        if k == kernel]
        errs += [x["max_abs_err"] for x in main.get("later", [])]
        return max(errs)

    def entry(name, source, replaces, launches, err, ms, plain_ms, bound_,
              device_ms=None, later=None, random=None, **extra):
        # ms: CUDA events around the wrapper; device_ms: the kernel's own
        # device time (torch.profiler), where measured, and
        # device_ms_launches: [launches in its trace, launches asked for];
        # later: K5's, K6's and K7's numbers on the lanes of later bounces
        # of the frames that run them; random: K3's and K4's on phase 10's
        # 1,000,000 random lanes of the every-kind scene
        dev = {} if device_ms is None else {"device_ms": device_ms[0],
                                            "device_ms_launches": list(device_ms[1:])}
        b2 = {} if later is None else {"later": [
            {k: x[k] for k in ("lanes", "ms", "plain_ms", "bound_ms", "bound_by",
                               "lanes_per_visit")} for x in later]}
        if random is not None:
            b2["random"] = {"lanes": K1_LANES, "device_ms": random["device_ms"][0],
                            **{k: random[k] for k in ("ms", "plain_ms", "bound_ms",
                                                      "bound_by")}}
        return {"name": name, "route": "cuda",
                "source": f"rust_pathtracer_tpu_torch/ops/csrc/{source}",
                "replaces": f"rust_pathtracer_tpu/ops/{replaces}", "launches": launches,
                "max_abs_err": err, "ms": ms, **dev,
                "plain_ms": plain_ms, "bound_ms": bound_[0], "bound_by": bound_[1],
                "library_ms": None, **b2, **extra}

    def packed_entry(name, replaces, launches, err, t, **extra):
        # phase 38's 1M random lanes, timed beside the legacy kernel in one
        # call (legacy_ms); launches: phase 39's packed paths
        return entry(name, "fused_bounce.cu" if "K1" in name else "draws.cu", replaces,
                     launches, err, t["ms"], t["plain_ms"], (t["bound_ms"], t["bound_by"]),
                     t["device_ms"], legacy_ms=t["legacy_ms"],
                     legacy_device_ms=t["legacy_device_ms"], rng_scheme=PACKED, **extra)

    kernels = {"kernels": [
        entry("fused_bounce (K1)", "fused_bounce.cu", "fused_bounce.py:169",
              k1["launches"], max(max_abs, keyed_err), k1["ms"], k1["plain_ms"],
              (k1["bound_ms"], k1["bound_by"]), k1["device_ms"]),
        entry("fused_bounce with residuals (K1-res)", "fused_bounce.cu",
              "fused_bounce.py:464", step["k1res_launches"], max(res_err, keyed_err),
              step["ms"]["K1-res"], step["ms"]["K1-res plain"], step["bounds"]["K1-res"],
              step["device_ms"]["K1-res"]),
        entry("fused_bounce_bwd (K2)", "fused_bounce_bwd.cu", "fused_bounce.py:618",
              step["k2_launches"], k2_err, step["ms"]["K2"], step["ms"]["K2 plain"],
              step["bounds"]["K2"], step["device_ms"]["K2"]),
        entry("closest_hit_record (K3)", "closest_hit.cu", "pallas_intersect.py:196",
              k3["launches"], max(k3["max_abs_err"], ch10["K3"]["max_abs_err"]),
              k3["ms"], k3["plain_ms"], (k3["bound_ms"], k3["bound_by"]),
              k3["device_ms"], random=ch10["K3"]),
        entry("closest_hit (K4)", "closest_hit.cu", "pallas_intersect.py:64",
              k4["launches"], max(k4["max_abs_err"], ch10["K4"]["max_abs_err"],
                                  geo["max_abs_err"]),
              k4["ms"], k4["plain_ms"], (k4["bound_ms"], k4["bound_by"]),
              k4["device_ms"], random=ch10["K4"],
              # phase 40's geometry step (diff_t="rederive"): K4's launches
              rederive_launches=geo["k4_launches"]),
        entry("projected_sweep (K5)", "projected.cu", "projected.py:455",
              k5["launches"], sweep_err("K5", k5), k5["ms"], k5["plain_ms"],
              (k5["bound_ms"], k5["bound_by"]), later=k5["later"],
              # phase 41's geometry step (diff_t="rederive"): K5's launches
              rederive_launches=geo_sf["k5_launches"]),
        entry("resident_sweep (K6)", "projected.cu", "resident.py:69",
              k6["launches"], sweep_err("K6", k6), k6["ms"], k6["plain_ms"],
              (k6["bound_ms"], k6["bound_by"]), later=k6["later"]),
        entry("pair_sweep (K7)", "projected.cu", "worklist.py:169",
              k7["launches"], sweep_err("K7", k7), k7["ms"], k7["plain_ms"],
              (k7["bound_ms"], k7["bound_by"]), later=k7["later"]),
        # phase 19's 1M lanes (max_abs_err: those and the pools phase 21's
        # render gave it); launches: the LightTest regen's (phase 21)
        entry("fused_bounce at per-lane depth (K1, regen)", "fused_bounce.cu",
              "fused_bounce.py:169", regen["k1_launches"],
              max(k1_lane["max_abs_err"], regen["max_abs_err"]),
              k1_lane["ms"], k1_lane["plain_ms"],
              (k1_lane["bound_ms"], k1_lane["bound_by"]), k1_lane["device_ms"]),
        # no Pallas kernel: it replaces XLA's threefry in the JAX package's
        # sampling.bounce_draws; phase 20's 1M keys at per-lane depths (and,
        # under "scalar", at bounce 7; max_abs_err: those and the pools
        # phase 22's render gave it); launches: the SphereField regen's
        dict(entry("bounce_draws", "draws.cu", "", sf_regen["draws_launches"],
                   max([v["max_abs_err"] for v in dr.values()] + [sf_regen["max_abs_err"]]),
                   dr[DRAWS_PER_LANE]["ms"], dr[DRAWS_PER_LANE]["plain_ms"],
                   (dr[DRAWS_PER_LANE]["bound_ms"], dr[DRAWS_PER_LANE]["bound_by"]),
                   dr[DRAWS_PER_LANE]["device_ms"]),
             replaces="rust_pathtracer_tpu/sampling.py:212 (XLA's threefry; no Pallas "
                      "kernel)",
             scalar={k: dr[DRAWS_SCALAR][k] for k in ("ms", "plain_ms", "bound_ms",
                                                       "bound_by")}),
        packed_entry("fused_bounce packed (K1)", "fused_bounce.py:169", pp["serving_k1"],
                     max(pk["K1"]["max_abs_err"], pp["k1_err"]), pk["K1"],
                     per_lane={k: pk["K1 per-lane"][k]
                               for k in ("ms", "legacy_ms", "plain_ms", "bound_ms",
                                         "bound_by")},
                     per_lane_launches=pp["regen_k1"]),
        packed_entry("fused_bounce with residuals packed (K1-res)", "fused_bounce.py:464",
                     pp["k1res_launches"], pk["K1-res"]["max_abs_err"], pk["K1-res"]),
        dict(packed_entry("bounce_draws packed", "", pp["cascade_draws"],
                          max(pk["draws " + DRAWS_PER_LANE]["max_abs_err"],
                              pp["cascade_err"]), pk["draws " + DRAWS_PER_LANE],
                          scalar={k: pk["draws " + DRAWS_SCALAR][k]
                                  for k in ("ms", "legacy_ms", "plain_ms", "bound_ms",
                                            "bound_by")}),
             replaces="rust_pathtracer_tpu/sampling.py:164 (scatter_uniforms, XLA's "
                      "threefry; no Pallas kernel)"),
        # phase 42's 1M lanes of the 20k mesh's table (its other tables under
        # "tables"); launches: the SphereField frame's with the reorder, phase
        # 43 (the other frames' under "launches_a_frame")
        dict(entry("passset_keys", "passset.cu", "",
                   frames["SphereField"]["counts"]["True"]["keys"],
                   max(v["max_abs_err"] for v in keys42.values()),
                   keys42["ModelTest 20k"]["ms"], keys42["ModelTest 20k"]["plain_ms"],
                   (keys42["ModelTest 20k"]["bound_ms"],
                    keys42["ModelTest 20k"]["bound_by"]),
                   keys42["ModelTest 20k"]["device_ms"]),
             replaces="rust_pathtracer_tpu/ops/projected.py:793 (passset_sort_keys, "
                      "XLA; no Pallas kernel)",
             tables={n: {"ms": v["ms"], "device_ms": v["device_ms"][0],
                         "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
                         "bound_by": v["bound_by"], "perm_ms": v["perm_ms"]}
                     for n, v in keys42.items()},
             launches_a_frame={n: f["counts"]["True"]["keys"] for n, f in frames.items()}),
        # phase 46's 1M random lanes (its other lane sets under "sets");
        # launches: the serving frame's, a launch a chunk (phase 5; every
        # path's under "launches_a_path")
        dict(entry("camera_lanes", "lanes.cu", "", lane_paths["serving (phase 5)"],
                   max(v["max_abs_err"] for v in lanes46.values()),
                   lanes46["random"]["ms"], lanes46["random"]["plain_ms"],
                   (lanes46["random"]["bound_ms"], lanes46["random"]["bound_by"]),
                   lanes46["random"]["device_ms"]),
             replaces="rust_pathtracer_tpu/render.py:162 (_make_lanes, and wavefront.py:148 "
                      "spawn: XLA's threefry; no Pallas kernel)",
             sets={n: {"lanes": v["lanes"], "ms": v["ms"], "device_ms": v["device_ms"][0],
                       "plain_ms": v["plain_ms"], "bound_ms": v["bound_ms"],
                       "bound_by": v["bound_by"]}
                   for n, v in lanes46.items() if n != "random"},
             launches_a_path=lane_paths),
        # phase 47's first bounce of a 6,558,720-lane SphereField chunk (its
        # second under "second_bounce"); launches: the SphereField frame's,
        # one a bounce (phase 15)
        dict(entry("shade_bounce", "shade.cu", "", shade_launches,
                   max(v["max_abs_err"] for v in shade47.values()),
                   shade47["bounce 1"]["ms"], shade47["bounce 1"]["plain_ms"],
                   (shade47["bounce 1"]["bound_ms"], shade47["bounce 1"]["bound_by"]),
                   shade47["bounce 1"]["device_ms"]),
             replaces="rust_pathtracer_tpu/integrator.py:562-631 (the tail of "
                      "_bounce_step after the projected search, XLA; no Pallas kernel)",
             lanes=shade47["bounce 1"]["lanes"],
             second_bounce={"device_ms": shade47["bounce 2"]["device_ms"][0],
                            **{k: shade47["bounce 2"][k]
                               for k in ("ms", "plain_ms", "bound_ms", "bound_by")}}),
        # phase 48's full-queue window end of the benchmark's LightTest frame
        # (8,388,608 lanes; the window where the queue runs out under
        # "queue_runs_out"): ms and device_ms the three kernels and CUB's
        # sort between them (by kernel under "by_kernel"), bound_ms the
        # kernels' bytes and sort_bound_ms the sort's; plain_ms the tensor-op
        # twin on the card; launches: the LightTest regen's (phase 21)
        dict(entry("window_end", "window_end.cu", "", regen["window_end_launches"], 0.0,
                   we48["full queue"]["ms"], we48["full queue"]["plain_ms"],
                   (we48["full queue"]["bound_ms"], we48["full queue"]["bound_by"])),
             replaces="rust_pathtracer_tpu/wavefront.py:374-409 (flush_refill: XLA's "
                      "scatter-add, cumsum and spawn; no Pallas kernel)",
             device_ms=we48["full queue"]["device_ms"],
             **{k: we48["full queue"][k] for k in ("lanes", "finished", "taken", "by_kernel",
                                                    "sort_bound_ms")},
             queue_runs_out={k: we48["queue runs out"][k]
                             for k in ("finished", "taken", "ms", "device_ms", "plain_ms",
                                       "bound_ms", "sort_bound_ms")},
             sort=we48["sort"], library_ms=we48["sort"]["cub_ms"]),
    ]}
    print(json.dumps(kernels), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
