"""One bounce's threefry uniforms for every lane: the draw kernel.

No Pallas counterpart: in the JAX package XLA runs threefry in
``sampling.bounce_draws``, hoisted for every bounce at once
(``integrator._precompute_draws``) or at each lane's own depth (the
regen wavefront).  This module wraps a CUDA kernel
(``csrc/draws.cu``, on ``csrc/threefry.cuh``) that draws the same bits
bounce by bounce, and holds its plain twin, ``bounce_draws_plain``
(``sampling.bounce_draws`` on the key words).

The generic and big-scene routes (``integrator._trace_generic``) draw
each bounce here, and the regen wavefront (``wavefront.py``) at each
lane's depth.  ``bounce_draws`` dispatches on where its tensors lie: CUDA
tensors launch the kernel (and count in ``launches``); CPU tensors run
the plain version.
"""

from __future__ import annotations

import contextlib

import torch

from rust_pathtracer_tpu_torch import sampling
from rust_pathtracer_tpu_torch.ops.fused_bounce import _lane_keys

# kernel launches (CUDA tensors only)
launches = 0

_M32 = 0xFFFFFFFF
N_ROWS = 6  # sphere_u (2), ball_u (3), coin; roulette's is a seventh row

_entry = None


def _split(rows, with_roulette):
    """(6 or 7, R) rows -> (sphere_u (R, 2), ball_u (R, 3), coin (R,),
    roulette (R,) or None), views of the rows."""
    return (rows[0:2].T, rows[2:5].T, rows[5],
            rows[N_ROWS] if with_roulette else None)


def bounce_draws_plain(keys, bounce, with_roulette):
    """``bounce_draws`` in plain tensor ops: ``sampling.bounce_draws`` on
    the lanes' keys.  Runs on any device."""
    at = bounce.to(torch.int64) if isinstance(bounce, torch.Tensor) else bounce
    return sampling.bounce_draws(_lane_keys(keys), at, with_roulette)


def bounce_draws(keys, bounce, with_roulette):
    """One bounce's scatter uniforms of R lanes, as ``sampling.bounce_draws``
    draws them: ``(sphere_u (R, 2), ball_u (R, 3), coin (R,), roulette (R,)
    or None)``, roulette's only ``with_roulette``.

    ``keys`` the lanes' threefry keys as (2, R) int32 rows
    (``fused_bounce.key_words``); ``bounce`` the bounce index, or an (R,)
    int32 tensor of each lane's own bounce.  CUDA tensors launch the
    kernel, whose uniforms are views of one (6 or 7, R) buffer; CPU
    tensors run ``bounce_draws_plain``."""
    dev = keys.device
    R = keys.shape[-1]
    if keys.dim() != 2 or keys.shape[0] != 2 or keys.dtype != torch.int32:
        raise ValueError(f"bounce_draws: keys must be (2, R) int32 rows, got "
                         f"{tuple(keys.shape)} {keys.dtype}")
    if isinstance(bounce, torch.Tensor):
        if bounce.shape != (R,) or bounce.dtype != torch.int32 or bounce.device != dev:
            raise ValueError(f"bounce_draws: a per-lane bounce must be ({R},) int32 "
                             f"on {dev}")
    elif not 0 <= int(bounce) <= _M32:
        raise ValueError(f"bounce_draws: bounce {bounce} out of range")
    if dev.type == "cpu":
        return bounce_draws_plain(keys, bounce, with_roulette)
    if dev.type != "cuda":
        raise ValueError(f"bounce_draws: no kernel for device {dev}")
    return _split(_launch(keys, bounce, bool(with_roulette)), with_roulette)


def _launch(keys, bounce, with_roulette):
    """One launch on CUDA tensors; returns the (6 or 7, R) rows."""
    global launches, _entry
    from rust_pathtracer_tpu_torch.ops._build import load_library

    if _entry is None:
        _entry = load_library("draws").bounce_draws_launch
    keys = keys.contiguous()
    depth = bounce.contiguous() if isinstance(bounce, torch.Tensor) else None
    R = keys.shape[1]
    out = torch.empty((N_ROWS + int(with_roulette), R), dtype=torch.float32,
                      device=keys.device)
    current = keys.device.index is None or keys.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(keys.device):
        err = _entry(keys.data_ptr(), None if depth is None else depth.data_ptr(),
                     0 if depth is not None else int(bounce), int(with_roulette),
                     out.data_ptr(), R, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("bounce_draws kernel launch failed: "
                           f"{load_library('draws').error_string(err).decode()}")
    launches += 1
    return out
