"""Batched 3-vector helpers on ``(..., 3)`` tensors.

Counterpart of ``rust_pathtracer_tpu/vecmath.py``; plain tensor code.
Only what the forward slice uses is ported: the two guard constants
(the fused-bounce kernel reads them too), the ``normalize`` / ``cross``
the camera builds its frame with, and ``sqrt``.
"""

from __future__ import annotations

import torch

# Reference NEAR_ZERO = 1e-8 (vec3.rs:7): the degenerate-lambertian guard.
NEAR_ZERO = 1e-8

# Tiny guard for normalization to avoid 0/0 NaNs.
_SAFE_EPS = 1e-20


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded f32 square root, as XLA and CUDA's sqrtf give it.

    PyTorch's CPU f32 sqrt is not correctly rounded (about 0.6% of
    random f32 inputs come out an ulp off, torch 2.13 on AVX-512); the
    f64 root rounded to f32 is, since 53 >= 2 * 24 + 2 bits."""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def length_squared(v: torch.Tensor) -> torch.Tensor:
    """|v|^2, summed x, y, z left to right."""
    return (v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]) + v[..., 2] * v[..., 2]


def normalize(v: torch.Tensor) -> torch.Tensor:
    """v / |v| (``unit_vector``, vec3.rs:101-103), safe at |v| ~ 0."""
    return v / sqrt(torch.clamp(length_squared(v), min=_SAFE_EPS))[..., None]


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched cross product (vec3.rs:93-99)."""
    return torch.stack(
        [
            a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
            a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
            a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0],
        ],
        dim=-1,
    )
