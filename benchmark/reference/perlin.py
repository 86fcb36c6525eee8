"""The marble texture (texture.rs:47-81) as the reference computes it.

A frozen, independent copy of the formulas the port renders with, in
plain tensor code, as ``threefry.py`` is of its random stream:

* the lattice hash: three uint32 multiplies of the lattice coordinates,
  xored, plus the scene's ``perlin_seed``, then two multiply-xorshift
  rounds (words in int64 masked to 32 bits, each multiply split into
  16-bit halves so that no int64 product overflows);
* the gradient of a hashed corner from the improved Perlin set of 16;
* the quintic fade 6t^5 - 15t^4 + 10t^3 and trilinear interpolation;
* turbulence |sum_k 0.5^k noise(2^k p)| to depth 7;
* marble 0.5 * (1 - sin(scale * z + 10 * turb(p))), grey in all three
  channels.

This is the port's hashed lattice, not the random permutation and
gradient tables of texture.rs: the port inherits that departure from
the JAX package, and the reference follows the port so that pixels can
be compared.  Nothing here reads the program.
"""

from __future__ import annotations

import torch

DEPTH = 7  # texture.rs:80
M32 = 0xFFFFFFFF
HASH_X, HASH_Y, HASH_Z = 0x8DA6B343, 0xD8163841, 0xCB1AB31F
MIX_1, MIX_2 = 0x2C1B3C6D, 0x297A2D39


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32) and a uint32 ``c``."""
    lo = a * (c & 0xFFFF)
    hi = ((a * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def hash3(ix: torch.Tensor, iy: torch.Tensor, iz: torch.Tensor, seed: int) -> torch.Tensor:
    """The uint32 word (in int64) of int64 lattice coordinates."""
    h = mul32(ix & M32, HASH_X) ^ mul32(iy & M32, HASH_Y) ^ mul32(iz & M32, HASH_Z)
    h = (h + (int(seed) & M32)) & M32
    h = h ^ (h >> 15)
    h = mul32(h, MIX_1)
    h = h ^ (h >> 12)
    h = mul32(h, MIX_2)
    return h ^ (h >> 15)


def gradient(h, x, y, z):
    """The dot product of the corner's gradient, picked by the hash's low
    four bits, with the offset (x, y, z)."""
    h = h & 15
    u = torch.where(h < 8, x, y)
    v = torch.where(h < 4, y, torch.where((h == 12) | (h == 14), x, z))
    return torch.where((h & 1) == 0, u, -u) + torch.where((h & 2) == 0, v, -v)


def fade(t):
    return t * t * t * (t * (t * 6.0 - 15.0) + 10.0)


def noise(px, py, pz, seed: int):
    """Gradient noise at points given by their three coordinate tensors."""
    xf, yf, zf = torch.floor(px), torch.floor(py), torch.floor(pz)
    ix, iy, iz = (f.to(torch.int32).to(torch.int64) for f in (xf, yf, zf))
    x, y, z = px - xf, py - yf, pz - zf
    u, v, w = fade(x), fade(y), fade(z)

    def corner(dx, dy, dz):
        return gradient(hash3(ix + dx, iy + dy, iz + dz, seed),
                        x - float(dx), y - float(dy), z - float(dz))

    def lerp(t, lo, hi):
        return lo + t * (hi - lo)

    return lerp(w,
                lerp(v, lerp(u, corner(0, 0, 0), corner(1, 0, 0)),
                     lerp(u, corner(0, 1, 0), corner(1, 1, 0))),
                lerp(v, lerp(u, corner(0, 0, 1), corner(1, 0, 1)),
                     lerp(u, corner(0, 1, 1), corner(1, 1, 1))))


def turbulence(px, py, pz, seed: int, depth: int = DEPTH):
    acc = torch.zeros_like(px)
    weight = 1.0
    for _ in range(depth):
        acc = acc + weight * noise(px, py, pz, seed)
        weight *= 0.5
        px, py, pz = px * 2.0, py * 2.0, pz * 2.0
    return torch.abs(acc)


def marble(points: torch.Tensor, seed: int, scale) -> torch.Tensor:
    """The marble value (n,) of (n, 3) points; ``scale`` a float or (n,)."""
    px, py, pz = points[:, 0], points[:, 1], points[:, 2]
    return 0.5 * (1.0 - torch.sin(scale * pz + 10.0 * turbulence(px, py, pz, seed)))
