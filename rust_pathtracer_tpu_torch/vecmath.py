"""Batched 3-vector helpers on ``(..., 3)`` tensors.

Counterpart of ``rust_pathtracer_tpu/vecmath.py``; plain tensor code.
The two guard constants (the fused-bounce kernel reads them too), the
vector ops of the generic bounce path, a correctly rounded ``sqrt`` and
``cbrt``, and the gradient guards ``safe_acos`` / ``safe_atan2`` /
``safe_sqrt``.  Sums over x, y, z run left to right.
"""

from __future__ import annotations

import math

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


def cbrt(x: torch.Tensor) -> torch.Tensor:
    """Cube root of U[0,1) draws.  PyTorch has no cbrt: the f64 power
    rounds to the nearest f32 (CUDA's cbrtf is within 1 ulp of it)."""
    return torch.pow(x.to(torch.float64), 1.0 / 3.0).to(x.dtype)


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched dot product (vec3.rs:87-89).  Returns (...)."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def length_squared(v: torch.Tensor) -> torch.Tensor:
    """|v|^2, summed x, y, z left to right."""
    return dot(v, v)


def length(v: torch.Tensor) -> torch.Tensor:
    """|v| (vec3.rs:79-81)."""
    return sqrt(length_squared(v))


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


def where(mask: torch.Tensor, a, b) -> torch.Tensor:
    """Select (..., 3) vectors by a (...) mask."""
    return torch.where(mask[..., None], a, b)


def near_zero(v: torch.Tensor) -> torch.Tensor:
    """True where every |component| < NEAR_ZERO (vec3.rs:110-112)."""
    return (torch.abs(v) < NEAR_ZERO).all(dim=-1)


def reflect(v: torch.Tensor, n: torch.Tensor) -> torch.Tensor:
    """Mirror reflection v - 2(v.n)n (vec3.rs:114-116)."""
    return v - 2.0 * dot(v, n)[..., None] * n


def refract(v: torch.Tensor, n: torch.Tensor, eta: torch.Tensor) -> torch.Tensor:
    """Snell refraction of unit v about unit n (vec3.rs:118-127):
    out_perp = eta (v + cos n), out_parallel = -sqrt(|1 - |out_perp|^2|) n
    with cos = min(-v.n, 1).  ``eta`` has shape (...)."""
    cos_theta = torch.clamp(dot(-v, n), max=1.0)
    out_perp = eta[..., None] * (v + cos_theta[..., None] * n)
    # the reference takes abs() before sqrt; safe_sqrt keeps the
    # gradient finite at the total-internal-reflection edge
    out_parallel = -safe_sqrt(torch.abs(1.0 - length_squared(out_perp)))[..., None] * n
    return out_perp + out_parallel


# --- gradient-safe transcendentals ------------------------------------
# acos'(x) and atan2 are unbounded or undefined at the sphere-uv poles,
# and a branch that ``where`` leaves out still takes part in the
# backward, where 0 * inf = NaN.  These route pole lanes through
# constants: forward values stay exact, pole gradients become 0.

_POLE_EPS = 1e-6


def safe_acos(x: torch.Tensor) -> torch.Tensor:
    xc = torch.clamp(x, -1.0, 1.0)
    is_pole = torch.abs(xc) >= 1.0 - _POLE_EPS
    xs = torch.where(is_pole, torch.zeros_like(xc), xc)
    pole_val = torch.where(xc > 0.0, torch.zeros_like(xc),
                           torch.full_like(xc, math.pi))
    return torch.where(is_pole, pole_val, torch.acos(xs))


def safe_atan2(y: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    degenerate = (torch.abs(x) < 1e-12) & (torch.abs(y) < 1e-12)
    xs = torch.where(degenerate, torch.ones_like(x), x)
    ys = torch.where(degenerate, torch.zeros_like(y), y)
    return torch.where(degenerate, torch.zeros_like(x), torch.atan2(ys, xs))


def safe_sqrt(x: torch.Tensor) -> torch.Tensor:
    """sqrt with zero gradient at 0 instead of inf."""
    is_zero = x <= 0.0
    xs = torch.where(is_zero, torch.ones_like(x), x)
    return torch.where(is_zero, torch.zeros_like(x), sqrt(xs))
