"""K3's and K4's plain PyTorch versions against the JAX package's Pallas
kernels, and the differentiable route's hit record against JAX's.

``closest_hit_plain`` / ``closest_hit_record_plain`` vs
``closest_hit_pallas`` / ``closest_hit_record_pallas`` run by the Pallas
interpreter (``interpret=True``, as the JAX package's own tests run it
on the CPU), on the same numpy rays: in CornellBox and in a scene with
every primitive kind and material.  The CUDA kernels themselves are
compared with the plain versions by ``tests/test_torch_cuda.py`` and by
``chip_smoke.py`` on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_pathtracer_tpu.integrator import T_MIN
from rust_pathtracer_tpu.models import get_scene as j_get_scene
from rust_pathtracer_tpu.ops import intersect as jx
from rust_pathtracer_tpu.ops.pallas_intersect import (
    closest_hit_pallas,
    closest_hit_record_pallas,
)
from rust_pathtracer_tpu.ops.pallas_intersect import pack_prims as j_pack_prims
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.ops import closest_hit as ch
from rust_pathtracer_tpu_torch.ops import intersect as tx
from test_fused_bounce import _full_scene as j_full_scene
from test_torch_cuda import _random_lanes, t_full_scene

torch.set_num_threads(2)

# The single-bounce contract of tests/test_torch_fused_bounce.py: the
# port rounds every f32 op; XLA:CPU contracts multiply-adds into FMAs in
# the interpreted kernel.  Away from spheres: at least 95% of lanes within
# rtol 1e-5 / atol 1e-6.  A sphere's roots the port takes in f64
# (``closest_hit.sphere_roots``), where JAX's f32 discriminant cancels,
# to ~1e-3 relative on some lanes (grazing hits, the r=100 and r=555-box
# scales): on the lanes a sphere wins, the port's t is the f64 root
# rounded to f32 (within F64_T_RTOL) and its hit point within
# F64_POINT_RTOL of max(1, |p|) of the f64 point.  Every lane within
# rtol 2e-3 / atol 1e-4 of JAX's.
TIGHT = dict(rtol=1e-5, atol=1e-6)
LOOSE = dict(rtol=2e-3, atol=1e-4)
F64_T_RTOL = 1.2e-7    # half an f32 ulp, with room for the root's own rounding
F64_POINT_RTOL = 5e-7  # and the f32 rounding of o + t d


def cornell_rays(n, seed):
    """Rays from the camera side into the box and from inside the box."""
    rng = np.random.default_rng(seed)
    o = np.array([278.0, 278.0, -800.0]) + rng.normal(0.0, 30.0, (n, 3))
    tgt = rng.uniform([0.0, 0.0, 0.0], [555.0, 555.0, 555.0], (n, 3))
    d = (tgt - o) * rng.uniform(0.001, 0.01, (n, 1))
    k = n // 2
    o[:k] = rng.uniform([10.0, 10.0, 10.0], [545.0, 545.0, 545.0], (k, 3))
    d[:k] = rng.normal(0.0, 1.0, (k, 3))
    return o.astype(np.float32), d.astype(np.float32)


def _cases():
    cols, _ = _random_lanes(1024, seed=17)
    full = (j_full_scene, t_full_scene, cols[0:3].T.copy(), cols[3:6].T.copy())
    co, cd = cornell_rays(1024, seed=4)
    cornell = (lambda: j_get_scene("CornellBox").build(),
               lambda: get_scene("CornellBox").build(), co, cd)
    return {"every_kind": full, "CornellBox": cornell}


CASES = _cases()


def _close(got, want, sphere):
    """The single-bounce contract over lanes (rows of got / want);
    ``sphere`` marks the lanes a sphere won, held to f64 instead."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    tight = np.isclose(got, want, **TIGHT).reshape(len(got), -1).all(axis=1)
    assert tight[~sphere].mean() >= 0.95, tight[~sphere].mean()
    np.testing.assert_allclose(got, want, **LOOSE)


def _hold_spheres_to_f64(tscene, o, d, t, idx, sphere, point=None):
    """On the ``sphere`` lanes, t (and the hit point) against the f64
    roots of the winning sphere, nearest in [T_MIN, inf)."""
    data = tscene.prims.data.numpy().astype(np.float64)
    o, d = o.astype(np.float64), d.astype(np.float64)
    for i in np.flatnonzero(sphere):
        oc = o[i] - data[idx[i], 0:3]
        a, half_b = d[i] @ d[i], d[i] @ oc
        sq = np.sqrt(half_b * half_b - a * (oc @ oc - data[idx[i], 3] ** 2))
        t64 = (-half_b - sq) / a
        t64 = t64 if t64 >= T_MIN else (-half_b + sq) / a
        assert abs(t[i] - t64) <= F64_T_RTOL * abs(t64), (i, t[i], t64)
        if point is not None:
            p = o[i] + t64 * d[i]
            assert np.abs(point[i] - p).max() <= F64_POINT_RTOL * max(1.0, np.abs(p).max()), i


@pytest.mark.parametrize("case", sorted(CASES))
def test_k4_plain_matches_pallas_interpret(case):
    jbuild, tbuild, o, d = CASES[case]
    jscene, tscene = jbuild(), tbuild()
    table = ch.pack_prims(tscene.prims)
    np.testing.assert_array_equal(table.numpy(), np.asarray(j_pack_prims(jscene.prims)))
    jh, jt, ji = closest_hit_pallas(jscene, jnp.asarray(o), jnp.asarray(d), T_MIN,
                                    interpret=True)
    th, tt, ti = ch.closest_hit(table, torch.from_numpy(o), torch.from_numpy(d),
                                kinds=tscene.kinds_static, t_min=T_MIN)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert ti.dtype == torch.int32 and th.dtype == torch.bool
    hit = th.numpy()
    assert 0.2 < hit.mean() < 1.0
    # every prim won somewhere, bar the two box faces that lie on the floor
    assert len(set(ti.numpy()[hit])) >= tscene.num_prims - 2
    np.testing.assert_array_equal(tt.numpy()[~hit], np.float32(tx.T_MISS))
    sphere = hit & (tscene.prims.kind.numpy()[ti.numpy()] == 0)
    _close(tt.numpy()[hit, None], np.asarray(jt)[hit, None], sphere[hit])
    _hold_spheres_to_f64(tscene, o, d, tt.numpy(), ti.numpy(), sphere)


@pytest.mark.parametrize("case", sorted(CASES))
def test_k3_plain_matches_pallas_interpret(case):
    """hit, idx, the winner's kind, mat and front exact; t, point,
    normal, u, v under the single-bounce contract."""
    jbuild, tbuild, o, d = CASES[case]
    jscene, tscene = jbuild(), tbuild()
    jh, jt, ji, jrec = closest_hit_record_pallas(jscene, jnp.asarray(o), jnp.asarray(d),
                                                 T_MIN, interpret=True)
    th, tt, ti, trec = ch.closest_hit_record(
        ch.pack_prims(tscene.prims), torch.from_numpy(o), torch.from_numpy(d),
        kinds=tscene.kinds_static, t_min=T_MIN)
    for got, want in ((th, jh), (ti, ji), (trec.valid, jrec.valid),
                      (trec.front_face, jrec.front_face), (trec.mat, jrec.mat),
                      (trec.prim, jrec.prim)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    hit = th.numpy()
    kinds = tscene.prims.kind.numpy()
    np.testing.assert_array_equal(np.where(hit, kinds[ti.numpy()], -1),
                                  np.where(np.asarray(jh), kinds[np.asarray(ji)], -1))
    np.testing.assert_array_equal(tt.numpy()[~hit], 1.0)
    got = np.concatenate([tt.numpy()[:, None], trec.point.numpy(), trec.normal.numpy(),
                          trec.u.numpy()[:, None], trec.v.numpy()[:, None]], 1)
    want = np.concatenate([np.asarray(jt)[:, None], np.asarray(jrec.point),
                           np.asarray(jrec.normal), np.asarray(jrec.u)[:, None],
                           np.asarray(jrec.v)[:, None]], 1)
    sphere = hit & (kinds[ti.numpy()] == 0)
    _close(got, want, sphere)
    _hold_spheres_to_f64(tscene, o, d, tt.numpy(), ti.numpy(), sphere,
                         point=trec.point.numpy())
    assert (kinds[ti.numpy()[hit]] == 0).any() and (kinds[ti.numpy()[hit]] == 1).any()


def test_record_from_rows_matches_jax():
    """gather_prim_rows exact; record_from_rows (the differentiable
    route's record: division for the sphere normal, safe_acos /
    safe_atan2, _safe_div) within 1e-5 rel / 1e-6 abs on 512 lanes, the
    front face exact."""
    jscene, tscene = j_full_scene(), t_full_scene()
    rng = np.random.default_rng(2)
    n = 512
    idx = rng.integers(0, tscene.num_prims, n).astype(np.int32)
    cols, _ = _random_lanes(n, seed=8)
    o, d = cols[0:3].T.copy(), cols[3:6].T.copy()
    t = rng.uniform(0.1, 3.0, n).astype(np.float32)
    valid = rng.random(n) < 0.8
    jrows = jx.gather_prim_rows(jscene.prims, jnp.asarray(idx))
    trows = tx.gather_prim_rows(tscene.prims, torch.from_numpy(idx))
    for a, b in zip(trows, jrows):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jrec = jx.record_from_rows(*jrows, jnp.asarray(idx), jnp.asarray(o), jnp.asarray(d),
                               jnp.asarray(t), jnp.asarray(valid), jscene.prim_types)
    trec = tx.record_from_rows(*trows, torch.from_numpy(idx), torch.from_numpy(o),
                               torch.from_numpy(d), torch.from_numpy(t),
                               torch.from_numpy(valid), tscene.prim_types)
    for f in ("valid", "front_face", "mat", "prim"):
        np.testing.assert_array_equal(getattr(trec, f).numpy(),
                                      np.asarray(getattr(jrec, f)), err_msg=f)
    for f in ("point", "normal", "u", "v"):
        np.testing.assert_allclose(getattr(trec, f).numpy(), np.asarray(getattr(jrec, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    # and hit_record is the gather followed by the record
    hr = tx.hit_record(tscene.prims, torch.from_numpy(idx), torch.from_numpy(o),
                       torch.from_numpy(d), torch.from_numpy(t), torch.from_numpy(valid),
                       tscene.prim_types)
    assert all(torch.equal(a, b) for a, b in zip(hr, trec))


def test_dispatch_by_device(monkeypatch):
    """CPU tensors take the plain versions (no launch is counted); other
    devices, mixed devices and malformed inputs raise."""
    scene = t_full_scene()
    table = ch.pack_prims(scene.prims)
    o, d = torch.zeros(6, 3), torch.ones(6, 3)
    kw = dict(kinds=scene.kinds_static, t_min=T_MIN)
    monkeypatch.setattr(ch, "hit_launches", 0)
    monkeypatch.setattr(ch, "record_launches", 0)
    for fn, plain in ((ch.closest_hit, ch.closest_hit_plain),
                      (ch.closest_hit_record, ch.closest_hit_record_plain)):
        a, b = fn(table, o, d, **kw), plain(table, o, d, **kw)
        assert all(torch.equal(x, y) for x, y in zip(a[:3], b[:3]))
        with pytest.raises(ValueError, match="no kernel for device meta"):
            fn(table.to("meta"), o.to("meta"), d.to("meta"), **kw)
        with pytest.raises(ValueError, match="tensors on"):
            fn(table, o.to("meta"), d, **kw)
        with pytest.raises(TypeError, match="float32"):
            fn(table, o.double(), d, **kw)
        with pytest.raises(ValueError, match="rays of shape"):
            fn(table, o[:, :2], d, **kw)
        with pytest.raises(ValueError, match="kinds"):
            fn(table, o, d, kinds=scene.kinds_static[:-1], t_min=T_MIN)
    assert ch.hit_launches == ch.record_launches == 0
