"""Hashed-lattice Perlin noise and the marble pattern.

Counterpart of ``rust_pathtracer_tpu/perlin.py``; plain tensor code.
``marble_planes`` is the plain twin of the perlin branch of the
fused-bounce kernel (``ops/csrc/fused_bounce.cu``), which ports the
same formulas to CUDA; ``marble`` is the same over (R, 3) points, for
the generic bounce path.  Both are differentiable in the points through
the fractional parts; floor and the hash carry no gradient, as in the
JAX package.

The lattice hash is uint32 arithmetic.  PyTorch has no uint32 multiply
on the CPU, so words live in int64 masked to 32 bits, and each 32x32
multiply is split into 16-bit halves so that no int64 product
overflows.  The result is bit for bit the JAX hash.

Marble (texture.rs:60-80):
  turb(p, depth=7) = | sum_k 0.5^k * noise(2^k * p) |
  value = 0.5 * (1 - sin(scale * z + 10 * turb(p)))
"""

from __future__ import annotations

import torch

TURBULENCE_DEPTH = 7  # texture.rs:80

_M32 = 0xFFFFFFFF


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32) and a uint32 constant."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fade(t):
    # 6t^5 - 15t^4 + 10t^3 (improved Perlin quintic)
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def _hash3(ix, iy, iz, seed: int):
    """Arithmetic lattice hash of int64 lattice coordinates -> uint32 words."""
    h = (
        _mul32(ix & _M32, 0x8DA6B343)
        ^ _mul32(iy & _M32, 0xD8163841)
        ^ _mul32(iz & _M32, 0xCB1AB31F)
    )
    h = (h + (seed & _M32)) & _M32
    h = h ^ (h >> 15)
    h = _mul32(h, 0x2C1B3C6D)
    h = h ^ (h >> 12)
    h = _mul32(h, 0x297A2D39)
    h = h ^ (h >> 15)
    return h


def _grad(h, x, y, z):
    """Gradient dot product for hashed corner h (improved Perlin set)."""
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return torch.where((h & 1) == 0, u, -u) + torch.where((h & 2) == 0, v, -v)


def noise3_planes(px, py, pz, seed: int = 0):
    """Improved Perlin noise on component planes; output roughly [-1, 1]."""
    xf, yf, zf = torch.floor(px), torch.floor(py), torch.floor(pz)
    # f32 -> int32 -> int64, as the JAX hash reads int32 lattice coordinates
    ix, iy, iz = (f.to(torch.int32).to(torch.int64) for f in (xf, yf, zf))
    x, y, z = px - xf, py - yf, pz - zf

    u, v, w = _fade(x), _fade(y), _fade(z)

    n000 = _grad(_hash3(ix, iy, iz, seed), x, y, z)
    n100 = _grad(_hash3(ix + 1, iy, iz, seed), x - 1.0, y, z)
    n010 = _grad(_hash3(ix, iy + 1, iz, seed), x, y - 1.0, z)
    n110 = _grad(_hash3(ix + 1, iy + 1, iz, seed), x - 1.0, y - 1.0, z)
    n001 = _grad(_hash3(ix, iy, iz + 1, seed), x, y, z - 1.0)
    n101 = _grad(_hash3(ix + 1, iy, iz + 1, seed), x - 1.0, y, z - 1.0)
    n011 = _grad(_hash3(ix, iy + 1, iz + 1, seed), x, y - 1.0, z - 1.0)
    n111 = _grad(_hash3(ix + 1, iy + 1, iz + 1, seed), x - 1.0, y - 1.0, z - 1.0)

    def lerp(t, lo, hi):
        return lo + t * (hi - lo)

    return lerp(
        w,
        lerp(v, lerp(u, n000, n100), lerp(u, n010, n110)),
        lerp(v, lerp(u, n001, n101), lerp(u, n011, n111)),
    )


def turbulence_planes(px, py, pz, seed: int = 0, depth: int = TURBULENCE_DEPTH):
    """|sum_k 0.5^k noise(2^k p)| (texture.rs:60-72)."""
    acc = torch.zeros_like(px)
    weight = 1.0
    for _ in range(depth):
        acc = acc + weight * noise3_planes(px, py, pz, seed)
        weight *= 0.5
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return torch.abs(acc)


def marble_planes(px, py, pz, seed: int, scale):
    """Marble pattern 0.5*(1 - sin(scale*z + 10*turb(p))) (texture.rs:76-80).

    ``seed`` is the scene's perlin hash-stream seed (an int); ``scale``
    is a tensor that broadcasts against the planes, or a float.
    """
    t = turbulence_planes(px, py, pz, seed)
    return 0.5 * (1.0 - torch.sin(scale * pz + 10.0 * t))


def marble(points: torch.Tensor, seed: int, scale):
    """``marble_planes`` over (..., 3) points; returns (...,)."""
    return marble_planes(points[..., 0], points[..., 1], points[..., 2], seed, scale)
