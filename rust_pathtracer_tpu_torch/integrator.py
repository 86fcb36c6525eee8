"""Iterative wavefront integrator: the forward bounce loop.

Counterpart of ``rust_pathtracer_tpu/integrator.py``; plain tensor
code around the fused-bounce kernel (``ops/fused_bounce.py``), which
runs each bounce.

The reference integrator is the recursive ``Ray::color``
(ray.rs:20-41).  The wavefront form carries (origin, direction,
throughput, radiance, alive) for every lane as 13 (R,) columns and
peels one bounce per iteration:

    radiance += throughput * emitted            (hit lanes)
    radiance += throughput * background         (miss lanes; lane dies)
    throughput *= attenuation                   (scatter lanes)

The non-differentiable loop is ``_trace_fused_cols``' while loop: it
stops at ``max_bounces`` or once no lane is alive.  The differentiable
one is the whole-scan ``autograd.Function`` of ``ops/fused_bounce.py``
(``fused_scan_trace``): exactly ``max_bounces`` bounces through K1 with
residuals, and K2 in the backward.  Optional russian roulette (off by
default; the reference has none) runs between bounces.  t_min = 0.001
(ray.rs:25) is in units of |direction|.

Not ported yet: the generic bounce path for scenes the fused kernels
refuse (ROADMAP queue 1 item 8; in differentiable mode that includes
perlin), its remat modes, the regen wavefront (item 9) and the cascade
(item 11).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from rust_pathtracer_tpu_torch import sampling
from rust_pathtracer_tpu_torch.ops.fused_bounce import (
    _COL_KEYS,
    fused_bounce_cols,
    fused_bounce_diff_ok,
    fused_bounce_ok,
    fused_scan_trace,
    pack_prims_shaded,
    roulette,
)

T_MIN = 1e-3  # ray.rs:25

# fixed histogram length, as in the JAX package
MAX_BOUNCE_STATS = 64


class TraceStats(NamedTuple):
    segments: torch.Tensor   # f32 scalar: total ray segments traced
    bounces: int             # bounce iterations executed (kernel launches)
    occupancy: torch.Tensor  # f32 (MAX_BOUNCE_STATS,): alive lanes per bounce


def _precompute_draws(lane_keys, max_bounces, rr_start, start_bounce=0):
    """Per-bounce uniforms for bounces [start_bounce, max_bounces).

    The draws depend only on (lane key, bounce, purpose), never on the
    path state, so they are drawn for every bounce at once.  Returns a
    dict of (B, R, ...) tensors: ``sphere_u`` (B, R, 2), ``ball_u``
    (B, R, 3), ``coin`` (B, R) and, when roulette can fire,
    ``roulette`` (B, R).  Bit-equal to the JAX legacy stream.
    """
    rr = rr_start < max_bounces
    b = torch.arange(start_bounce, max_bounces, dtype=torch.int64,
                     device=lane_keys.device)[:, None]
    out = dict(
        sphere_u=sampling.uniform2(
            sampling.bounce_keys(lane_keys, b, sampling.P_LAMBERT)),
        ball_u=sampling.uniform3(
            sampling.bounce_keys(lane_keys, b, sampling.P_FUZZ)),
        coin=sampling.uniform(
            sampling.bounce_keys(lane_keys, b, sampling.P_SCHLICK)),
    )
    if rr:
        out["roulette"] = sampling.uniform(
            sampling.bounce_keys(lane_keys, b, sampling.P_ROULETTE))
    return out


def trace(
    scene,
    origins: torch.Tensor,
    directions: torch.Tensor,
    lane_keys: torch.Tensor,
    background,
    max_bounces: int,
    russian_roulette_start: Optional[int] = None,
    differentiable: bool = False,
):
    """Estimate radiance for a wavefront of rays.

    origins, directions: (R, 3) f32; lane_keys: (R, 2) lane keys;
    background: (3,) miss color.  All on one device, which the scene
    must share.  Returns (radiance (R, 3), TraceStats).

    ``differentiable`` runs the whole-scan ``autograd.Function``:
    gradients reach origins, directions, ``scene.textures.color`` and
    the background (the detached-sampling estimator of the JAX package;
    hit distances do not differentiate through the primitive data).
    """
    ok = fused_bounce_diff_ok if differentiable else fused_bounce_ok
    if not ok(scene):
        raise NotImplementedError(
            "this scene needs the generic bounce path, which is not ported "
            "yet (ROADMAP queue 1 item 8): only scenes of at most 128 "
            "primitives with solid / checker / perlin textures render, and "
            "in differentiable mode solid / checker only")
    dev = origins.device
    if scene.device != dev:
        raise ValueError(f"scene on {scene.device}, rays on {dev}")
    background = torch.as_tensor(background, dtype=torch.float32, device=dev)
    rr_start = (
        max_bounces + 1 if russian_roulette_start is None
        else russian_roulette_start
    )

    zeros = torch.zeros_like(origins[:, 0])
    ones = torch.ones_like(zeros)
    cols = dict(zip(_COL_KEYS, (
        origins[:, 0], origins[:, 1], origins[:, 2],
        directions[:, 0], directions[:, 1], directions[:, 2],
        ones, ones, ones, zeros, zeros, zeros, ones,
    )))
    draws = _precompute_draws(lane_keys, max_bounces, rr_start)

    if differentiable:
        cols, segments, occupancy = fused_scan_trace(
            scene, cols, draws, background, T_MIN, max_bounces, rr_start,
            MAX_BOUNCE_STATS)
        rad = torch.stack([cols["r0"], cols["r1"], cols["r2"]], dim=1)
        return rad, TraceStats(segments=segments, bounces=max_bounces,
                               occupancy=occupancy)

    table = pack_prims_shaded(scene)
    seed = scene.textures.perlin_seed
    segments = torch.zeros((), dtype=torch.float32, device=dev)
    occupancy = torch.zeros(MAX_BOUNCE_STATS, dtype=torch.float32, device=dev)
    bounce = 0
    while bounce < max_bounces and bool((cols["al"] > 0.5).any()):
        n_alive = cols["al"].sum()
        segments = segments + n_alive
        occupancy[min(bounce, MAX_BOUNCE_STATS - 1)] = n_alive
        su, bu = draws["sphere_u"][bounce], draws["ball_u"][bounce]
        cols = fused_bounce_cols(
            table, background, seed, cols, su[:, 0], su[:, 1],
            bu[:, 0], bu[:, 1], bu[:, 2], draws["coin"][bounce],
            kinds=scene.kinds_static, mat_types=scene.mat_types,
            tex_types=scene.tex_types, t_min=T_MIN,
        )
        if bounce >= rr_start:
            cols = roulette(cols, draws["roulette"][bounce])[0]
        bounce += 1

    rad = torch.stack([cols["r0"], cols["r1"], cols["r2"]], dim=1)
    return rad, TraceStats(segments=segments, bounces=bounce,
                           occupancy=occupancy)
