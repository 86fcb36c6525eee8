"""Counter-based random draws, bit-exact with the JAX package.

Counterpart of ``rust_pathtracer_tpu/sampling.py``; plain tensor code.
Both of the JAX package's streams of scatter draws: the legacy
per-purpose stream (its default, ``RPT_RNG_SCHEME`` unset) and the
packed counter-mode stream (``RPT_RNG_SCHEME=packed``,
``scatter_uniforms``), chosen by the ``rng_scheme`` argument of
``bounce_draws``, the one chooser every draw site goes through, so that
a render never mixes the two.  Camera jitter and lens draws take the
legacy stream under both.  The sphere and ball transforms of the
uniforms run where the draws are used, at the wavefront's own shape, as
in the JAX package.

Every lane owns a threefry-2x32 key ``fold_in(base_key, counter)``
and every bounce draws under ``fold_in(lane_key, bounce * 8 +
purpose)``.  With jax's ``jax_threefry_partitionable`` (the default in
jax 0.9):

* ``fold_in(k, d)`` is ``threefry2x32(k, (0, d))``;
* ``jax.random.uniform(k, (n,))[i]`` is the f32 whose bits are
  ``((x0 ^ x1) >> 9) | 0x3f800000``, minus 1, where
  ``(x0, x1) = threefry2x32(k, (0, i))``.

The packed stream draws one bounce of a lane from the raw lane key, with
no fold: block j is ``threefry2x32(lane_key, (bounce, j))``, both output
words kept, and word w converts as ``(w >> 8) * 2**-24`` (24 bits, not
the 23-bit mantissa trick above).  Words 0-1 are ``sphere_u``, 2-4
``ball_u``, 5 the coin and 6 roulette: 4 blocks a lane-bounce.

Keys are ``(..., 2)`` int64 tensors holding uint32 words.  PyTorch has
no uint32 add on the CPU, so all words live in int64 and are masked to
32 bits after every add and shift.
"""

from __future__ import annotations

import math

import torch

from rust_pathtracer_tpu_torch.vecmath import cbrt, sqrt

# purpose tags for per-bounce draws
P_PIXEL_JITTER = 0  # 2 uniforms (renderer.rs:22-25)
P_LENS = 1          # 2 uniforms for the aperture disk (camera.rs:47)
P_LAMBERT = 2       # 2 uniforms: on-sphere dir (material.rs:42)
P_FUZZ = 3          # 3 uniforms: in-ball dir (material.rs:84)
P_SCHLICK = 4       # 1 uniform: reflect/refract coin (material.rs:128)
P_ROULETTE = 5      # 1 uniform: optional russian roulette (not in reference)
_STRIDE = 8

# the scatter-draw streams (JAX RPT_RNG_SCHEME)
RNG_SCHEMES = ("legacy", "packed")

_M32 = 0xFFFFFFFF
_TF_C240 = 0x1BD11BDA
_ROT_EVEN = (13, 15, 26, 6)
_ROT_ODD = (17, 29, 16, 24)


def prng_key(seed: int, device="cpu") -> torch.Tensor:
    """The raw key words of ``jax.random.PRNGKey(seed)``: ``[0, seed]``."""
    if not 0 <= seed <= _M32:
        raise ValueError(f"seed must lie in [0, 2**32), got {seed}")
    return torch.tensor([0, seed], dtype=torch.int64, device=device)


def _rotl(x, r):
    return ((x << r) & _M32) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """Spec threefry-2x32, 20 rounds (``sampling._threefry2x32``).

    All arguments are int64 tensors (or ints) of uint32 values that
    broadcast together; returns the two output words, masked.
    """
    k2 = k0 ^ k1 ^ _TF_C240
    ks = (k0, k1, k2)
    x0 = (x0 + k0) & _M32
    x1 = (x1 + k1) & _M32
    for i in range(5):
        for r in (_ROT_EVEN if i % 2 == 0 else _ROT_ODD):
            x0 = (x0 + x1) & _M32
            x1 = x0 ^ _rotl(x1, r)
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over (..., 2) keys; ``data`` broadcasts
    against ``keys[..., 0]`` and is taken modulo 2**32."""
    k0, k1 = keys[..., 0], keys[..., 1]
    if isinstance(data, torch.Tensor):
        data = data.to(torch.int64) & _M32
    else:
        data = int(data) & _M32
    x0, x1 = threefry2x32(k0, k1, 0, data)
    x0, x1 = torch.broadcast_tensors(x0, x1)
    return torch.stack([x0, x1], dim=-1)


def lane_keys(base_key: torch.Tensor, counters: torch.Tensor) -> torch.Tensor:
    """Per-lane keys from lane counters, shape (R,) -> (R, 2)."""
    return fold_in(base_key, counters)


def bounce_keys(lkeys: torch.Tensor, bounce, purpose: int) -> torch.Tensor:
    """Fold (bounce, purpose) into per-lane keys.  ``bounce`` is an
    int, or a tensor that broadcasts against ``lkeys[..., 0]``."""
    return fold_in(lkeys, bounce * _STRIDE + purpose)


def _bits_to_uniform(bits: torch.Tensor) -> torch.Tensor:
    """uint32 words -> U[0, 1) as ``jax.random.uniform`` makes them."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def _uniforms(keys: torch.Tensor, n: int) -> torch.Tensor:
    """n iid U[0,1) per key; keys (..., 2) -> (..., n)."""
    k0, k1 = keys[..., 0], keys[..., 1]
    cols = []
    for i in range(n):
        x0, x1 = threefry2x32(k0, k1, 0, i)
        cols.append(_bits_to_uniform(x0 ^ x1))
    return torch.stack(cols, dim=-1)


def uniform(keys: torch.Tensor) -> torch.Tensor:
    """One U[0,1) per lane, shape (...,)."""
    return _uniforms(keys, 1)[..., 0]


def uniform2(keys: torch.Tensor) -> torch.Tensor:
    """Two U[0,1) per lane, shape (..., 2)."""
    return _uniforms(keys, 2)


def uniform3(keys: torch.Tensor) -> torch.Tensor:
    """Three U[0,1) per lane, shape (..., 3)."""
    return _uniforms(keys, 3)


def on_unit_sphere_from_u(u: torch.Tensor) -> torch.Tensor:
    """Uniform direction on S^2 from (..., 2) uniforms, shape (..., 3):
    z = 2u - 1, phi = 2 pi v, r = sqrt(1 - z^2) (``random_on_unitsphere``,
    vec3.rs:51-53, computed analytically)."""
    z = 2.0 * u[..., 0] - 1.0
    phi = (2.0 * math.pi) * u[..., 1]
    r = sqrt(torch.clamp(1.0 - z * z, min=0.0))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), z], dim=-1)


def in_unit_sphere_from_u(u: torch.Tensor) -> torch.Tensor:
    """Uniform point in the unit ball from (..., 3) uniforms: a uniform
    direction scaled by u^(1/3) (vec3.rs:41-49)."""
    z = 2.0 * u[..., 0] - 1.0
    phi = (2.0 * math.pi) * u[..., 1]
    rho = sqrt(torch.clamp(1.0 - z * z, min=0.0))
    d = torch.stack([rho * torch.cos(phi), rho * torch.sin(phi), z], dim=-1)
    return d * cbrt(u[..., 2])[..., None]


def check_rng_scheme(rng_scheme: str) -> str:
    """``rng_scheme`` if it names a stream, else a ValueError."""
    if rng_scheme not in RNG_SCHEMES:
        raise ValueError(f"rng_scheme {rng_scheme!r}, want one of {RNG_SCHEMES}")
    return rng_scheme


def _bits_to_unit(w: torch.Tensor) -> torch.Tensor:
    """uint32 words -> U[0, 1) at 24-bit resolution, exact in f32."""
    return (w >> 8).to(torch.float32) * (2.0 ** -24)


def scatter_uniforms(lkeys: torch.Tensor, bounce, with_roulette: bool):
    """All of one bounce's scatter draws from 4 counter-mode threefry
    blocks under the raw lane keys (the packed scheme).

    ``lkeys`` (R, 2) lane keys; ``bounce`` an int, an (R,) per-lane depth
    or any tensor that broadcasts against (R,), taken modulo 2**32.
    Returns (sphere_u (.., R, 2), ball_u (.., R, 3), coin (.., R),
    roulette (.., R) or None); block j in 0..3 yields words (2j, 2j+1)."""
    k0, k1 = lkeys[..., 0], lkeys[..., 1]
    if isinstance(bounce, torch.Tensor):
        b = bounce.to(torch.int64) & _M32
    else:
        b = torch.tensor(int(bounce) & _M32, dtype=torch.int64, device=lkeys.device)
    b, k0, k1 = torch.broadcast_tensors(b, k0, k1)
    words = []
    for j in range(4 if with_roulette else 3):
        w0, w1 = threefry2x32(k0, k1, b, j)
        words.extend([w0, w1])
    u = [_bits_to_unit(w) for w in words]
    return (torch.stack(u[0:2], dim=-1), torch.stack(u[2:5], dim=-1), u[5],
            u[6] if with_roulette else None)


def bounce_draws(lkeys: torch.Tensor, bounce, with_roulette: bool,
                 rng_scheme: str = "legacy"):
    """One bounce's scatter uniforms under ``rng_scheme`` (the JAX
    package's single chooser): (sphere_u (..., 2), ball_u (..., 3), coin
    (...), roulette (...) or None).  "packed" is ``scatter_uniforms``;
    "legacy" the per-purpose fold chains."""
    if check_rng_scheme(rng_scheme) == "packed":
        return scatter_uniforms(lkeys, bounce, with_roulette)
    su = uniform2(bounce_keys(lkeys, bounce, P_LAMBERT))
    bu = uniform3(bounce_keys(lkeys, bounce, P_FUZZ))
    cn = uniform(bounce_keys(lkeys, bounce, P_SCHLICK))
    rl = (uniform(bounce_keys(lkeys, bounce, P_ROULETTE))
          if with_roulette else None)
    return su, bu, cn, rl


def in_unit_disk_xy(keys: torch.Tensor) -> torch.Tensor:
    """Uniform point in the unit disk in the xy plane, shape (..., 3):
    r = sqrt(u), theta = 2*pi*v, z = 0 (vec3.rs:55-67)."""
    u = _uniforms(keys, 2)
    r = sqrt(u[..., 0])
    theta = (2.0 * math.pi) * u[..., 1]
    return torch.stack(
        [r * torch.cos(theta), r * torch.sin(theta), torch.zeros_like(r)], dim=-1
    )
