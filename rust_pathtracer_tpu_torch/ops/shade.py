"""The shade kernel: the big-scene forward bounce after the search.

No Pallas counterpart: in the JAX package XLA runs this part of the
bounce (the tail of ``integrator._bounce_step``, JAX integrator.py:562-631)
after the projected search.  This module wraps a CUDA kernel
(``csrc/shade.cu``) that takes the search's (t, column), reads the
winner's payload row from the tables by column, and computes in one pass
the hit record, the texture, the background and emission banking, the
draws' sphere and ball transforms, the lambertian / metal / dielectric
scatter, the state commit and roulette: the new (o, d, thr, rad, alive).

Its plain twin is the tensor-op route, ``integrator.shade_bounce_plain``
(``projected.record_from_payload`` and ``integrator._bounce_tail``), which
shades every bounce the kernel does not take.  ``shade_kernel_ok`` says
which bounces it takes: forward, on a CUDA device, over projected tables
whose payload rows hold complete shading rows (``ProjTables.shade_ready``),
on a scene whose textures are solid or checkers (no kind it takes reads
uv).  ``integrator.forward_bounce`` asks it; ``shade_bounce`` launches the
kernel on CUDA tensors (and counts in ``launches``) or raises.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

from rust_pathtracer_tpu_torch.ops.fused_bounce import _MAT_BITS, _TEX_BITS, _type_flags
from rust_pathtracer_tpu_torch.scene.types import TEX_CHECKER, TEX_SOLID

# kernel launches (CUDA tensors only)
launches = 0

# the texture kinds the kernel evaluates
TEX_KINDS = (TEX_SOLID, TEX_CHECKER)
N_PTRS = 22  # csrc/shade.cu enum Ptr

_lib = None


def shade_kernel_ok(scene, device) -> bool:
    """Whether a forward bounce of ``scene`` on ``device`` shades in the
    kernel: one on a CUDA device, over projected tables (``kinds_static``
    None) whose payload rows hold complete shading rows (``shade_ready``),
    on a scene whose textures are solid or checkers.  Perlin and image
    textures and every scene of up to 128 primitives keep the tensor ops,
    as every differentiable bounce does (``integrator.forward_bounce``
    alone asks)."""
    return (torch.device(device).type == "cuda" and scene.kinds_static is None
            and scene.proj is not None and scene.proj.shade_ready
            and set(scene.tex_types) <= set(TEX_KINDS))


def shade_bounce(scene, search, state, draws_b, background, rr_u=None, rr_sel=None):
    """One forward bounce after the big-scene search, for a scene that
    ``shade_kernel_ok`` admits.

    ``search``: (t, column, payload) of ``projected.closest_hit_routed``
    (t f32, column int32 with -1 on a miss; the kernel reads the winner's
    row from ``scene.proj.payload`` and not the (R, 32) payload); ``state``
    (o, d, thr, rad, alive): (R, 3) f32 and an (R,) bool mask; ``draws_b``
    the bounce's ``sphere_u`` (R, 2), ``ball_u`` (R, 3) and ``coin`` (R,);
    ``background`` (3,); ``rr_u`` roulette's (R,) uniforms or None (no
    roulette); ``rr_sel`` an optional (R,) bool mask of the lanes roulette
    may act on.  Returns the new (o, d, thr, rad, alive).  The tensors
    must be on a CUDA device; the kernel is built at the first call and a
    failed build or launch raises."""
    dev = state[0].device
    if dev.type != "cuda":
        raise ValueError(f"shade_bounce: no kernel for device {dev}")
    return _launch(scene, search, state, draws_b, background, rr_u, rr_sel)


def _checked(x, shape, dtype, dev, what):
    """``x`` where it has this shape, type and device, else a ValueError."""
    if tuple(x.shape) != shape or x.dtype != dtype or x.device != dev:
        raise ValueError(f"shade_bounce: {what} must be {shape} {dtype} on {dev}, got "
                         f"{tuple(x.shape)} {x.dtype} on {x.device}")
    return x


def _launch(scene, search, state, draws_b, background, rr_u, rr_sel):
    """One launch on CUDA tensors; returns the new state."""
    global launches, _lib
    if _lib is None:
        from rust_pathtracer_tpu_torch.ops._build import load_library

        _lib = load_library("shade")
    f32 = torch.float32
    dev = state[0].device
    R = state[0].shape[0]
    o, d, thr, rad = (_checked(x, (R, 3), f32, dev, name)
                      for x, name in zip(state[:4], ("o", "d", "thr", "rad")))
    alive = _checked(state[4], (R,), torch.bool, dev, "alive")
    t = _checked(search[0], (R,), f32, dev, "t")
    col = _checked(search[1], (R,), torch.int32, dev, "column")
    su = _checked(draws_b["sphere_u"], (R, 2), f32, dev, "sphere_u")
    bu = _checked(draws_b["ball_u"], (R, 3), f32, dev, "ball_u")
    # the uniforms by column: rows of the draw kernel's buffer, no copy
    u_cols = [su[:, 0], su[:, 1], bu[:, 0], bu[:, 1], bu[:, 2],
              _checked(draws_b["coin"], (R,), f32, dev, "coin")]
    rr = None if rr_u is None else _checked(rr_u, (R,), f32, dev, "roulette")
    sel = None if rr_sel is None else _checked(rr_sel, (R,), torch.bool, dev, "rr_sel")
    bg = torch.as_tensor(background, dtype=f32, device=dev)
    if bg.shape != (3,):
        raise ValueError(f"shade_bounce: background must be (3,), got {tuple(bg.shape)}")
    outs = [torch.empty((R, 3), dtype=f32, device=dev) for _ in range(4)]
    alive_out = torch.empty(R, dtype=torch.bool, device=dev)
    tensors = [x if x is None else x.contiguous()
               for x in (scene.proj.payload, t, col, o, d, thr, rad, alive, *u_cols, rr, sel,
                         bg)]
    tensors += [*outs, alive_out]
    ptrs = (ctypes.c_void_p * N_PTRS)(*(None if x is None else x.data_ptr() for x in tensors))
    current = dev.index is None or dev.index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(dev):
        err = _lib.shade_bounce_launch(
            ptrs, _type_flags(scene.mat_types, _MAT_BITS, "material"),
            _type_flags(scene.tex_types, _TEX_BITS, "texture"), R,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"shade kernel launch failed: {_lib.error_string(err).decode()}")
    launches += 1
    return (*outs, alive_out)
