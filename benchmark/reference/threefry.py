"""The random stream of a render: threefry-2x32 and its uniforms.

A frozen copy of the arithmetic of ``rust_pathtracer_tpu_torch/sampling.py``
at commit 305d6da3becbf006a816fecd12ece25b3c47b12a (``threefry2x32``,
``fold_in``, the 23-bit uniforms of the legacy stream), so that the
reference draws the numbers the program draws without importing it.
A lane's key is ``fold_in(frame_key, pixel * spp + sample)``; a purpose
of a bounce draws under ``fold_in(lane_key, bounce * 8 + purpose)``.
Words are uint32 values held in int64 tensors.
"""

from __future__ import annotations

import torch

M32 = 0xFFFFFFFF
_C240 = 0x1BD11BDA
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))

P_JITTER, P_LENS, P_LAMBERT, P_FUZZ, P_SCHLICK = 0, 1, 2, 3, 4
STRIDE = 8


def threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 with 20 rounds on uint32 words in int64 tensors."""
    ks = (k0, k1, k0 ^ k1 ^ _C240)
    x0 = (x0 + k0) & M32
    x1 = (x1 + k1) & M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & M32
            x1 = x0 ^ (((x1 << r) & M32) | (x1 >> (32 - r)))
        x0 = (x0 + ks[(i + 1) % 3]) & M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & M32
    return x0, x1


def fold_in(k0, k1, data):
    """``jax.random.fold_in``: the block of (0, data) under the key."""
    return threefry2x32(k0, k1, torch.zeros_like(k0), data & M32)


def uniforms(k0, k1, n):
    """``n`` U[0, 1) floats a key, (R, n) float32: the bits ``((x0 ^ x1)
    >> 9) | 0x3f800000`` of block (0, i), minus 1."""
    cols = []
    for i in range(n):
        x0, x1 = threefry2x32(k0, k1, torch.zeros_like(k0), torch.full_like(k0, i))
        bits = (((x0 ^ x1) >> 9) | 0x3F800000).to(torch.int32)
        cols.append(bits.view(torch.float32) - 1.0)
    return torch.stack(cols, dim=-1)


def purpose_uniforms(k0, k1, bounce: int, purpose: int, n: int):
    """The ``n`` uniforms of ``purpose`` at ``bounce`` under lane keys."""
    p0, p1 = fold_in(k0, k1, torch.full_like(k0, bounce * STRIDE + purpose))
    return uniforms(p0, p1, n)


def frame_key(seed: int, index: int):
    """The (2,) key words of frame or step ``index`` of a run of ``seed``:
    every (seed, index) pair its own key, for any whole seed."""
    s = int(seed)
    return [((s >> 32) * 0x9E3779B1 + int(index)) & M32, s & M32]
