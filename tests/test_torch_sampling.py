"""The port's counter RNG against the JAX package: bit for bit.

Keys, counters and bounces come from numpy and go through both
``rust_pathtracer_tpu.sampling`` (jax 0.9, threefry partitionable) and
``rust_pathtracer_tpu_torch.sampling``.  Every draw must be bit-equal:
the goldens, and every render identity, rest on the stream.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_pathtracer_tpu import sampling as js
from rust_pathtracer_tpu.integrator import _precompute_draws as j_precompute
from rust_pathtracer_tpu_torch import sampling as ts
from rust_pathtracer_tpu_torch.integrator import _precompute_draws as t_precompute

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _legacy_stream(monkeypatch):
    # the legacy per-purpose stream is the code default and the one ported
    monkeypatch.delenv("RPT_RNG_SCHEME", raising=False)


def _u32(rng, shape):
    return rng.integers(0, 2**32, size=shape, dtype=np.uint64).astype(np.uint32)


def _keys(rng, n):
    """n random raw keys as (jax uint32, torch int64) pairs."""
    k = _u32(rng, (n, 2))
    return jnp.asarray(k), torch.from_numpy(k.astype(np.int64))


def _eq(j, t):
    j = np.asarray(j)
    t = t.numpy()
    if j.dtype == np.uint32:
        j = j.astype(np.int64)
    assert j.shape == t.shape
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("seed", [0, 1234, 2**31 - 1])
def test_prng_key_and_lane_keys(seed):
    jk = jnp.asarray(jax.random.PRNGKey(seed))
    tk = ts.prng_key(seed)
    _eq(jk, tk)
    rng = np.random.default_rng(seed % 1000)
    counters = _u32(rng, 777)
    _eq(js.lane_keys(jk, jnp.asarray(counters)),
        ts.lane_keys(tk, torch.from_numpy(counters.astype(np.int64))))


def test_bounce_keys_scalar_and_per_lane():
    rng = np.random.default_rng(1)
    jk, tk = _keys(rng, 300)
    for bounce in (0, 1, 19, 63):
        for purpose in range(6):
            _eq(js.bounce_keys(jk, bounce, purpose),
                ts.bounce_keys(tk, bounce, purpose))
    per_lane = rng.integers(0, 50, size=300).astype(np.int32)
    _eq(js.bounce_keys(jk, jnp.asarray(per_lane), js.P_FUZZ),
        ts.bounce_keys(tk, torch.from_numpy(per_lane.astype(np.int64)), ts.P_FUZZ))


def test_uniforms_bit_equal():
    rng = np.random.default_rng(2)
    jk, tk = _keys(rng, 1000)
    _eq(js.uniform(jk), ts.uniform(tk))
    _eq(js.uniform2(jk), ts.uniform2(tk))
    _eq(js.uniform3(jk), ts.uniform3(tk))
    u = ts.uniform3(tk)
    assert u.dtype == torch.float32 and (u >= 0).all() and (u < 1).all()


def test_in_unit_disk_close():
    """sqrt is exact on both sides; cos/sin differ by an ulp between
    XLA and PyTorch, hence the 4-ulp tolerance."""
    rng = np.random.default_rng(3)
    jk, tk = _keys(rng, 512)
    np.testing.assert_allclose(ts.in_unit_disk_xy(tk).numpy(),
                               np.asarray(js.in_unit_disk_xy(jk)),
                               rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("rr_start", [None, 3])
def test_precompute_draws_bit_equal(rr_start):
    """20 bounces of hoisted draws, with and without roulette."""
    rng = np.random.default_rng(4)
    jk, tk = _keys(rng, 256)
    max_bounces = 20
    rr = max_bounces + 1 if rr_start is None else rr_start
    jd = j_precompute(jk, max_bounces, rr)
    td = t_precompute(tk, max_bounces, rr)
    assert set(jd) == set(td)
    assert ("roulette" in td) == (rr_start is not None)
    for name in jd:
        _eq(jd[name], td[name])


@pytest.mark.parametrize("with_roulette", [False, True])
def test_bounce_draws_bit_equal(with_roulette):
    """One bounce's scatter uniforms, and the same as the hoisted draws'
    row of that bounce."""
    rng = np.random.default_rng(5)
    jk, tk = _keys(rng, 300)
    j = js.bounce_draws(jk, 7, with_roulette)
    t = ts.bounce_draws(tk, 7, with_roulette)
    assert (t[3] is None) == (not with_roulette)
    for a, b in zip(j, t):
        if b is not None:
            _eq(a, b)
    hoisted = t_precompute(tk, 8, 0 if with_roulette else 9)
    _eq(np.asarray(j[0]), hoisted["sphere_u"][7])
    _eq(np.asarray(j[2]), hoisted["coin"][7])


def test_sphere_and_ball_transforms_close():
    """on_unit_sphere_from_u / in_unit_sphere_from_u: cos, sin and cbrt
    differ by an ulp between XLA and PyTorch, hence 4 ulp."""
    u = np.random.default_rng(6).random((512, 3)).astype(np.float32)
    np.testing.assert_allclose(
        ts.on_unit_sphere_from_u(torch.from_numpy(u[:, :2])).numpy(),
        np.asarray(js.on_unit_sphere_from_u(jnp.asarray(u[:, :2]))), rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        ts.in_unit_sphere_from_u(torch.from_numpy(u)).numpy(),
        np.asarray(js.in_unit_sphere_from_u(jnp.asarray(u))), rtol=1e-6, atol=1e-7)
