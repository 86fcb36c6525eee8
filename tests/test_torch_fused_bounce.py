"""K1's plain PyTorch version against the JAX package's Pallas kernel.

One bounce: ``fused_bounce_cols_plain`` vs ``_fused_bounce_cols`` run
by the Pallas interpreter (``interpret=True``, as the JAX package's own
tests run it on the CPU), on the same numpy inputs.  Alive-out and hit
masks and the winning primitive are EXACT.  Floats: see
``test_plain_bounce_matches_pallas_interpret``.

Many bounces: ``trace`` vs the JAX ``trace`` under the statistical
contract of ``tests/test_fused_bounce.py::_compare_diverging`` (an ulp
can flip a discrete choice and reroute a lane's whole path).

The CUDA kernel itself is compared with the plain version by
``tests/test_torch_cuda.py`` and by ``chip_smoke.py`` on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_pathtracer_tpu import perlin as jperlin
from rust_pathtracer_tpu import sampling as js
from rust_pathtracer_tpu.integrator import T_MIN
from rust_pathtracer_tpu.integrator import trace as j_trace
from rust_pathtracer_tpu.ops.fused_bounce import (
    FLG_BESTI_SHIFT,
    FLG_HIT,
    _fused_bounce_cols,
)
from rust_pathtracer_tpu.ops.fused_bounce import pack_prims_shaded as j_pack
from rust_pathtracer_tpu_torch import perlin as tperlin
from rust_pathtracer_tpu_torch import sampling as ts
from rust_pathtracer_tpu_torch.integrator import trace as t_trace
from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
from test_fused_bounce import _compare_diverging
from test_fused_bounce import _full_scene as j_full_scene
from test_torch_cuda import _random_lanes, _run_plain, t_full_scene

torch.set_num_threads(2)


def test_plain_bounce_matches_pallas_interpret():
    """512 lanes through every primitive kind, material and texture."""
    jscene, tscene = j_full_scene(), t_full_scene()
    np.testing.assert_array_equal(fb.pack_prims_shaded(tscene).numpy(),
                                  np.asarray(j_pack(jscene)))
    cols, uni = _random_lanes(512, seed=11)
    bg = (0.2, 0.1, 0.05)
    jcols = {k: jnp.asarray(cols[i]) for i, k in enumerate(fb._COL_KEYS)}
    jout, jres = _fused_bounce_cols(
        j_pack(jscene), jnp.asarray(bg, jnp.float32),
        jnp.asarray(jscene.textures.perlin_seed, jnp.uint32), jcols,
        *[jnp.asarray(u) for u in uni], kinds=jscene.kinds_static,
        mat_types=jscene.mat_types, tex_types=jscene.tex_types,
        t_min=float(T_MIN), interpret=True, want_residuals=True)
    j_out = np.stack([np.asarray(jout[k]) for k in fb._COL_KEYS])
    flags = np.asarray(jres["flags"]).reshape(-1)[:512]
    j_win = np.where(flags & FLG_HIT, flags >> FLG_BESTI_SHIFT, -1)

    t_out, t_win = _run_plain(tscene, cols, uni, bg)
    np.testing.assert_array_equal(t_out[12], j_out[12])      # alive-out
    np.testing.assert_array_equal(t_win, j_win)              # hit + winner
    hits = t_win >= 0
    dead = cols[12] <= 0.5
    assert hits.sum() > 200 and (~dead).sum() > hits.sum()
    assert len(set(t_win[hits])) == tscene.num_prims      # every prim won somewhere

    # Dead lanes pass their state through untouched.
    np.testing.assert_array_equal(t_out[:, dead], j_out[:, dead])
    # Floats.  The port rounds every f32 op (as the CUDA kernel, built
    # with --fmad=false, does); XLA:CPU contracts multiply-adds into FMAs
    # in the interpreted kernel.  Away from spheres that is all that
    # differs: within rtol 1e-5 / atol 1e-6 on at least 95% of those
    # lanes (sin/cos and cbrt differ by ulps between the libraries, well
    # inside).  A sphere's roots the port takes in f64
    # (``closest_hit.sphere_roots``), where JAX's f32 discriminant
    # half_b^2 - a*c cancels near grazing hits and on the r=100 ground
    # sphere, to up to ~1e-3 relative in t and the hit point (and so in
    # what follows from it: directions, marble).  So on the lanes a
    # sphere wins, the port's hit point is held to the f64 oracle's,
    # within 5e-7 of max(1, |p|) (f32 rounding of o + t d), and JAX's to
    # the JAX package's own single-bounce contract
    # (test_fused_bounce.py:153-161) below.
    kinds = np.array([k for k, _ in tscene.kinds_static])
    sphere = hits & (kinds[np.maximum(t_win, 0)] == 0)
    close = np.isclose(t_out, j_out, rtol=1e-5, atol=1e-6).all(axis=0)
    assert close[~sphere].mean() >= 0.95, close[~sphere].mean()
    table = fb.pack_prims_shaded(tscene).numpy().astype(np.float64)
    o, d = cols[0:3].astype(np.float64), cols[3:6].astype(np.float64)
    for i in np.flatnonzero(sphere & ~dead):
        oc = o[:, i] - table[0:3, t_win[i]]
        a, half_b = d[:, i] @ d[:, i], d[:, i] @ oc
        sq = np.sqrt(half_b * half_b - a * (oc @ oc - table[3, t_win[i]] ** 2))
        t = (-half_b - sq) / a
        t = t if t >= T_MIN else (-half_b + sq) / a
        p = o[:, i] + t * d[:, i]
        assert np.abs(t_out[0:3, i] - p).max() <= 5e-7 * max(1.0, np.abs(p).max()), i
    np.testing.assert_allclose(t_out, j_out, rtol=2e-3, atol=1e-4)


def test_dispatch_by_device(monkeypatch):
    """K1's wrapper (``fused_bounce_keyed``): CPU tensors take the plain
    version (no launch is counted); other devices, mixed devices and a
    malformed table raise."""
    scene = t_full_scene()
    table = fb.pack_prims_shaded(scene)
    cols, _ = _random_lanes(64, seed=3)
    state = torch.from_numpy(cols)
    keys = fb.key_words(ts.lane_keys(ts.prng_key(5), torch.arange(64)))
    kw = dict(with_roulette=False, kinds=scene.kinds_static, mat_types=scene.mat_types,
              tex_types=scene.tex_types, t_min=T_MIN)
    bg = torch.tensor((0.1, 0.1, 0.1))
    monkeypatch.setattr(fb, "launches", 0)
    out = fb.fused_bounce_keyed(table, bg, 0, state, keys, 0, **kw)
    ref = fb.fused_bounce_keyed_plain(table, bg, 0, state, keys, 0, **kw)
    assert torch.equal(out, ref)
    assert fb.launches == 0

    meta = [x.to("meta") for x in (table, bg, state, keys)]
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fb.fused_bounce_keyed(*meta[:2], 0, *meta[2:], 0, **kw)
    with pytest.raises(ValueError, match="tensors on"):
        fb.fused_bounce_keyed(table, meta[1], 0, state, keys, 0, **kw)
    with pytest.raises(TypeError, match="float32"):
        fb.fused_bounce_keyed(table.double(), bg, 0, state, keys, 0, **kw)
    with pytest.raises(ValueError, match="shape"):
        fb.fused_bounce_keyed(table[:5], bg, 0, state, keys, 0, **kw)


def test_perlin_hash_and_marble():
    """The lattice hash is bit-equal (negative coordinates included);
    marble within 1e-6 (sin differs by ulps)."""
    rng = np.random.default_rng(9)
    ijk = rng.integers(-2**20, 2**20, (3, 4096)).astype(np.int32)
    for seed in (0, 7, 2**32 - 1):
        jh = jperlin._hash3(*[jnp.asarray(x) for x in ijk], jnp.uint32(seed))
        th = tperlin._hash3(*[torch.from_numpy(x.astype(np.int64)) for x in ijk], seed)
        np.testing.assert_array_equal(th.numpy(), np.asarray(jh).astype(np.int64))
    p = rng.uniform(-40.0, 40.0, (3, 4096)).astype(np.float32)
    for seed, scale in ((0, 4.0), (7, 0.5)):
        jm = jperlin.marble_planes(*[jnp.asarray(x) for x in p],
                                   jnp.uint32(seed), jnp.float32(scale))
        tm = tperlin.marble_planes(*[torch.from_numpy(x) for x in p], seed,
                                   torch.tensor(scale))
        np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=1e-6)


def _rays(n):
    ang = np.linspace(-0.5, 0.5, n)
    o = np.tile([[0.0, 0.8, 1.5]], (n, 1))
    d = np.stack([np.sin(ang), 0.3 * np.cos(5 * ang) - 0.3, -np.cos(ang)], 1)
    return o.astype(np.float32), d.astype(np.float32)


@pytest.mark.parametrize("rr", [None, 3])
def test_trace_matches_jax_trace(rr):
    """Multi-bounce trace, with and without russian roulette: <= 2% of
    lanes flipped, lane means within rtol 0.03 / atol 5e-3, segments
    within 5%."""
    n, bg, nb = 256, (0.3, 0.4, 0.5), 8
    o, d = _rays(n)
    jkeys = js.lane_keys(jax.random.PRNGKey(5), jnp.arange(n, dtype=jnp.uint32))
    tkeys = ts.lane_keys(ts.prng_key(5), torch.arange(n))
    rad0, st0 = j_trace(j_full_scene(), jnp.asarray(o), jnp.asarray(d), jkeys,
                        bg, max_bounces=nb, russian_roulette_start=rr)
    rad1, st1 = t_trace(t_full_scene(), torch.from_numpy(o), torch.from_numpy(d),
                        tkeys, bg, max_bounces=nb, russian_roulette_start=rr)
    assert 0 < st1.bounces <= nb
    assert float(st1.occupancy[0]) == n
    _compare_diverging(rad0, rad1.numpy(), st0, st1)


def test_trace_refuses_what_is_not_ported():
    """remat acts on the generic route only: under "bf16" the fused
    route keeps K1's residuals and K2, so the radiance and the origins'
    gradient are bit for bit those of the default remat.  What the port
    refuses: a gradient of the primitive geometry under "analytic",
    which the detached estimator would return as zero.  Scenes the fused
    kernel refuses render on the generic route
    (tests/test_torch_generic_grad.py)."""
    import dataclasses

    scene = t_full_scene()
    o, d = _rays(8)
    keys = ts.lane_keys(ts.prng_key(0), torch.arange(8))
    args = (torch.from_numpy(o), torch.from_numpy(d), keys, (0.0, 0.0, 0.0), 4)

    def step(remat):
        org = torch.from_numpy(o).requires_grad_(True)
        rad, _ = t_trace(scene, org, *args[1:], differentiable=True, remat=remat)
        rad.sum().backward()
        return rad.detach(), org.grad

    for a, b in zip(step(None), step("bf16")):
        assert torch.equal(a, b)
    prims = dataclasses.replace(scene.prims,
                                data=scene.prims.data.clone().requires_grad_(True))
    with pytest.raises(NotImplementedError, match="geometry"):
        t_trace(dataclasses.replace(scene, prims=prims), *args, differentiable=True)
    rad, st = t_trace(dataclasses.replace(scene, shade_static=False), *args)
    assert torch.isfinite(rad).all() and st.bounces > 0
