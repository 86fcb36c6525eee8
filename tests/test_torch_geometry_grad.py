"""Gradients of the primitive geometry (``diff_t="rederive"``) on the CPU.

The differentiable re-intersection ``intersect.prim_intersect_t`` per
kind, the rederive step against the analytic one and against the JAX
package's ``jax.grad`` under ``RPT_DIFF_T=rederive``, the routing, and
the sharded geometry gradient.  Tolerances and why:

* rects: the port's t and valid mask equal JAX's eager ``rect_t`` bit
  for bit.  Triangles: the port's t is K4's (f32, no fused multiply-add,
  sums left to right) and equals an f32 numpy reference of the same
  formula bit for bit; JAX's ``jnp.cross`` runs as one XLA:CPU fusion,
  which contracts its multiply-subtracts into FMAs, so JAX's t differs
  from K4's on about a fifth of the hit lanes, mostly by an ulp or two
  and by up to 3.4e-5 relative where the cross products cancel (rtol
  1e-4; the valid masks are equal).  Spheres: the port's root is the f64 root rounded to f32,
  to the last bit; JAX's f32 root within its own f32 error;
* ``gradcheck`` in f64 on each kind, with respect to o, d and data;
* the TwoSphereCheckers rederive loss equals the analytic loss bit for
  bit (the re-derived t is K4's t), the gradients within rtol 2e-3,
  atol 1e-6 (``tests/test_grad.py:182``'s form);
* against JAX: the loss within 2e-3 relative, each leaf (the
  ``DiffParams`` leaves and ``prims.data``) within rtol 0.05 and 2e-3 of
  its largest |g| (``test_torch_generic_grad.py``).  On CornellBox and
  TriangleTest every texture is a solid colour: the image is piecewise
  constant in the geometry under the detached-sampling estimator, and
  the ``prims.data`` gradient is exactly zero on both sides;
* the sharded geometry gradient (a 1x2 gloo grid) equals the
  single-device one within 1e-6 relative in the loss and 1e-4 of the
  leaf's largest gradient, plus 1e-6 of the largest of any leaf
  (``test_torch_sharding_grad.py``'s bounds).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_pathtracer_tpu.grad import CameraParams as JCameraParams
from rust_pathtracer_tpu.grad import DiffParams as JDiffParams
from rust_pathtracer_tpu.grad import l2_loss as j_l2_loss
from rust_pathtracer_tpu.models import get_scene as j_get_scene
from rust_pathtracer_tpu.ops import intersect as ji
from rust_pathtracer_tpu.render import RenderSettings as JRenderSettings
from rust_pathtracer_tpu_torch import integrator, sampling
from rust_pathtracer_tpu_torch.grad import (
    CameraParams,
    DiffParams,
    diff_params_from_numpy,
    render_loss_and_grad,
)
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.ops import intersect as ti
from rust_pathtracer_tpu_torch.ops.closest_hit import closest_hit_plain, pack_prims
from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
from test_torch_generic_grad import _leaves, _spy_routes
from torch_spawn import run_ranks

torch.set_num_threads(2)

T_MIN, T_MAX = integrator.T_MIN, integrator.T_MAX
# scene -> (width, height, spp, bounces, background, key)
STEPS = {
    "CornellBox": (16, 16, 2, 5, (1.0, 1.0, 1.0), 0),
    "TwoSphereCheckers": (16, 9, 4, 6, (1.0, 1.0, 1.0), 0),
    "TriangleTest": (16, 16, 2, 5, (1.0, 1.0, 1.0), 0),
}


def _rays(n, seed, scale=3.0):
    rng = np.random.default_rng(seed)
    o = (rng.normal(size=(n, 3)) * scale).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return rng, o, d


def _rect_rows(rng, n):
    data = rng.normal(size=(n, 12)).astype(np.float32)
    data[:, 1:3] = -np.abs(data[:, 1:3]) - 0.2
    data[:, 3:5] = np.abs(data[:, 3:5]) + 0.2
    return data, rng.integers(0, 3, n).astype(np.int32)


def _j(x):
    return jnp.asarray(x)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def test_rect_t_matches_jax_bitwise():
    rng, o, d = _rays(20000, 1)
    data, aux = _rect_rows(rng, 20000)
    kind = np.full(20000, 1, np.int32)
    jt, jv = ji.prim_intersect_t(_j(kind), _j(aux), _j(data), _j(o), _j(d), T_MIN,
                                 np.float32(T_MAX))
    tt, tv = ti.prim_intersect_t(_t(kind), _t(aux), _t(data), _t(o), _t(d), T_MIN, T_MAX)
    assert tv.sum() > 300
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(_bits(tt), _bits(jt))


def test_triangle_t_is_k4s_and_within_ulps_of_jax():
    rng, o, d = _rays(20000, 2)
    data = rng.normal(size=(20000, 12)).astype(np.float32)
    kind = np.full(20000, 2, np.int32)
    aux = np.zeros(20000, np.int32)
    tt, tv = ti.prim_intersect_t(_t(kind), _t(aux), _t(data), _t(o), _t(d), T_MIN, T_MAX)
    jt, jv = ji.prim_intersect_t(_j(kind), _j(aux), _j(data), _j(o), _j(d), T_MIN,
                                 np.float32(T_MAX))
    # the f32 formula op for op, no contraction (K4's order)
    p1, e1, e2 = data[:, 0:3], data[:, 3:6], data[:, 6:9]

    def cross(a, b):
        return np.stack([a[:, 1] * b[:, 2] - a[:, 2] * b[:, 1],
                         a[:, 2] * b[:, 0] - a[:, 0] * b[:, 2],
                         a[:, 0] * b[:, 1] - a[:, 1] * b[:, 0]], 1)

    def dot(a, b):
        return (a[:, 0] * b[:, 0] + a[:, 1] * b[:, 1]) + a[:, 2] * b[:, 2]

    pv = cross(d, e2)
    det = dot(e1, pv)
    inv = np.float32(1.0) / np.where(np.abs(det) > 1e-30, det, np.float32(1.0))
    t_ref = dot(e2, cross(o - p1, e1)) * inv
    valid = tv.numpy()
    assert valid.sum() > 30
    np.testing.assert_array_equal(_bits(tt)[valid], _bits(t_ref)[valid])
    np.testing.assert_array_equal(valid, np.asarray(jv))
    np.testing.assert_allclose(tt.numpy()[valid], np.asarray(jt)[valid], rtol=1e-4)


def test_sphere_t_is_the_f64_root():
    """The port's root is the f64 root rounded to f32; JAX's f32 root
    within its f32 error (half_b^2 - a c cancels on grazing rays)."""
    rng, o, d = _rays(20000, 3)
    data = rng.normal(size=(20000, 12)).astype(np.float32)
    data[:, 3] = (np.abs(data[:, 3]) + 0.5) * np.where(rng.random(20000) < 0.2, -1, 1)
    tt, tv = ti.sphere_t(_t(data), _t(o), _t(d), T_MIN, T_MAX)
    jt, jv = ji.sphere_t(_j(data), _j(o), _j(d), T_MIN, np.float32(T_MAX))
    o64, d64, c64 = o.astype(np.float64), d.astype(np.float64), data.astype(np.float64)
    oc = o64 - c64[:, 0:3]

    def dot(u, v):
        return u[:, 0] * v[:, 0] + u[:, 1] * v[:, 1] + u[:, 2] * v[:, 2]

    a, hb = dot(d64, d64), dot(d64, oc)
    dis = hb * hb - a * (dot(oc, oc) - c64[:, 3] * c64[:, 3])
    sq = np.sqrt(np.maximum(dis, 0.0))
    r1 = ((-hb - sq) / a).astype(np.float32)
    r2 = ((-hb + sq) / a).astype(np.float32)
    want = np.where(r1 >= T_MIN, r1, r2)
    valid = tv.numpy()
    assert valid.sum() > 1000
    np.testing.assert_array_equal(valid, (dis >= 0) & ((r1 >= T_MIN) | (r2 >= T_MIN)))
    np.testing.assert_array_equal(_bits(tt)[valid], _bits(want)[valid])
    both = valid & np.asarray(jv)
    assert both.mean() > 0.99 * valid.mean()
    np.testing.assert_allclose(np.asarray(jt)[both], want[both], rtol=2e-3, atol=1e-4)


def _kind_case(kind, n=24, seed=4):
    rng = np.random.default_rng(seed)
    o = rng.normal(size=(n, 3)) * 0.15 + np.array([0.0, 0.0, 3.0])
    d = np.array([0.0, 0.0, -1.0]) + rng.normal(size=(n, 3)) * 0.05
    data = np.zeros((n, 12))
    aux = np.full(n, 2, np.int64)
    if kind == 0:
        data[:, 0:3] = rng.normal(size=(n, 3)) * 0.1
        data[:, 3] = 1.0 + rng.random(n) * 0.2
    elif kind == 1:
        data[:, 0] = 0.1 * rng.normal(size=n)
        data[:, 1:5] = [-1.0, -1.0, 1.0, 1.0]
        data[:, 5] = 1.0
    else:
        data[:, 0:3] = [-1.0, -1.0, 0.0]
        data[:, 3:6] = [4.0, 0.0, 0.0]
        data[:, 6:9] = [0.0, 4.0, 0.0]
        data[:, 0:9] += rng.normal(size=(n, 9)) * 0.05
        data[:, 9:12] = [0.0, 0.0, 1.0]
    # two lanes that miss, pointing away
    d[:2] = -d[:2]
    f = lambda x: torch.tensor(x, dtype=torch.float64, requires_grad=True)  # noqa: E731
    return (torch.full((n,), kind, dtype=torch.int32), torch.from_numpy(aux), f(data),
            f(o), f(d))


@pytest.mark.parametrize("kind", [0, 1, 2])
def test_gradcheck_per_kind(kind):
    """``prim_intersect_t`` in f64 against finite differences, with
    respect to o, d and the primitive's row; miss lanes give zero
    gradients and no NaN."""
    k, aux, data, o, d = _kind_case(kind)

    def t_of(data, o, d):
        return ti.prim_intersect_t(k, aux, data, o, d, T_MIN, T_MAX)[0]

    valid = ti.prim_intersect_t(k, aux, data, o, d, T_MIN, T_MAX)[1]
    assert valid[2:].all() and not valid[:2].any()
    # the hit lanes alone: a miss lane's T_MISS is a constant
    hits = slice(2, None)
    assert torch.autograd.gradcheck(
        lambda data, o, d: t_of(data, o, d)[hits], (data, o, d), eps=1e-6, atol=1e-5)
    t = t_of(data, o, d)
    gd, go, gdd = torch.autograd.grad(torch.where(valid, t, 0.0).sum(), (data, o, d))
    for g in (gd, go, gdd):
        assert torch.isfinite(g).all()
        assert (g[:2] == 0).all() and (g[2:] != 0).any()


def test_rederive_t_is_k4s_on_its_winners():
    """On CornellBox camera and bounce rays, the re-derived t of K4's
    winner is K4's t (its plain version) bit for bit on every hit lane."""
    sd = get_scene("CornellBox")
    scene = sd.build()
    rng = np.random.default_rng(5)
    n = 4000
    o = torch.from_numpy((np.array([278.0, 278.0, 278.0])
                          + rng.uniform(-250, 250, (n, 3))).astype(np.float32))
    d = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    hit, t, idx = closest_hit_plain(pack_prims(scene.prims), o, d,
                                    kinds=scene.kinds_static, t_min=T_MIN)
    kind, aux, data, _ = ti.gather_prim_rows(scene.prims, idx)
    t_re, valid = ti.prim_intersect_t(kind, aux, data, o, d, T_MIN, T_MAX,
                                      scene.prim_types)
    assert hit.sum() > 3000
    np.testing.assert_array_equal(valid[hit].numpy(), np.ones(int(hit.sum()), bool))
    np.testing.assert_array_equal(_bits(t_re[hit]), _bits(t[hit]))


def _settings(name, cls=RenderSettings, **kw):
    w, h, spp, nb, bg, _ = STEPS[name]
    return cls(w, h, spp, nb, bg, **kw)


def _with_data(scene, data):
    return dataclasses.replace(scene, prims=dataclasses.replace(scene.prims, data=data))


def _cam(name, cls):
    """The scene's camera as ``cls`` (either package's CameraParams)."""
    args, kw = get_scene(name).camera_at(0.0, make=lambda *a, device="cpu", **k: (a, k))
    return cls.create(*args, **kw)


def _port_step(name, diff_t, geometry):
    """The port's (loss, DiffParams grads as numpy leaves, prims.data
    grad or None)."""
    sd = get_scene(name)
    scene = sd.build()
    cam = _cam(name, CameraParams)
    s = _settings(name, diff_t=diff_t)
    data = None
    if geometry:
        data = scene.prims.data.clone().requires_grad_(True)
        scene = _with_data(scene, data)
    params = DiffParams.from_scene(scene, cam, s.background)
    loss, g = render_loss_and_grad(params, scene, s, sampling.prng_key(STEPS[name][5]),
                                   torch.zeros(s.height, s.width, 3), device="cpu")
    return loss, _leaves(g), None if data is None else data.grad.numpy()


def test_rederive_loss_bitwise_analytic():
    """TwoSphereCheckers takes the generic route under both modes: the
    rederive loss is the analytic loss bit for bit, every DiffParams
    gradient within rtol 2e-3, atol 1e-6."""
    la, ga, _ = _port_step("TwoSphereCheckers", "analytic", False)
    lr, gr, gd = _port_step("TwoSphereCheckers", "rederive", True)
    assert float(la) == float(lr)
    for k in ga:
        np.testing.assert_allclose(gr[k], ga[k], rtol=2e-3, atol=1e-6, err_msg=k)
    assert np.isfinite(gd).all() and np.abs(gd).max() > 0


@pytest.fixture(scope="module")
def jax_geometry():
    """JAX's loss and gradients with respect to (DiffParams, prims.data)
    under RPT_DIFF_T=rederive, for each scene of STEPS; the variable is
    read at trace time, so the caches are cleared before and after."""
    out = {}
    saved = os.environ.get("RPT_DIFF_T")
    os.environ["RPT_DIFF_T"] = "rederive"
    jax.clear_caches()
    try:
        for name in STEPS:
            jsd = j_get_scene(name)
            jscene = jsd.build()
            w, h, spp, nb, bg, key = STEPS[name]
            s = JRenderSettings(w, h, spp, nb, bg, differentiable=True)
            jcam = _cam(name, JCameraParams)
            params = JDiffParams.from_scene(jscene, jcam, bg)

            def loss(p, data, _scene=jscene, _s=s, _key=key):
                sc = dataclasses.replace(_scene, prims=_scene.prims._replace(data=data))
                return j_l2_loss(p, sc, _s, jax.random.PRNGKey(_key), jnp.zeros((h, w, 3)))

            val, (gp, gdata) = jax.value_and_grad(loss, argnums=(0, 1))(
                params, jscene.prims.data)
            out[name] = (_leaves(params), float(val), _leaves(gp), np.asarray(gdata))
    finally:
        if saved is None:
            os.environ.pop("RPT_DIFF_T")
        else:
            os.environ["RPT_DIFF_T"] = saved
        jax.clear_caches()
    return out


@pytest.mark.parametrize("name", list(STEPS))
def test_geometry_grad_matches_jax(name, jax_geometry):
    """Loss, every DiffParams leaf and the prims.data gradient against
    ``jax.grad`` under RPT_DIFF_T=rederive, from the same parameters."""
    jparams, jloss, jg, jdata = jax_geometry[name]
    sd = get_scene(name)
    data = sd.build().prims.data.clone().requires_grad_(True)
    scene = _with_data(sd.build(), data)
    s = _settings(name, diff_t="rederive")
    loss, g = render_loss_and_grad(diff_params_from_numpy(jparams), scene, s,
                                   sampling.prng_key(STEPS[name][5]),
                                   torch.zeros(s.height, s.width, 3), device="cpu")
    np.testing.assert_allclose(float(loss), jloss, rtol=2e-3)
    got = dict(_leaves(g), data=data.grad.numpy())
    want = dict(jg, data=jdata)
    assert np.isfinite(got["data"]).all()
    for k in want:
        scale = np.abs(want[k]).max()
        np.testing.assert_allclose(got[k], want[k], rtol=0.05, atol=2e-3 * scale,
                                   err_msg=k)
    if name == "TwoSphereCheckers":  # the perlin sphere carries it
        assert (np.abs(jdata[:, 0:4]).max(axis=1) > 0).all()
        assert (np.abs(got["data"][:, 0:4]).max(axis=1) > 0).all()
    else:  # solid colours only: zero on both sides
        assert not jdata.any() and not got["data"].any()


@pytest.mark.parametrize("diff_t,route", [("rederive", "_trace_generic"),
                                          ("analytic", "_trace_fused")])
def test_routing(monkeypatch, diff_t, route):
    """Rederive sends CornellBox's differentiable step to the generic
    route; analytic keeps it on K1 and K2."""
    calls = _spy_routes(monkeypatch)
    sd = get_scene("CornellBox")
    s = RenderSettings(4, 3, 1, 2, (0.5, 0.5, 0.5), differentiable=True, diff_t=diff_t)
    img, _ = render_radiance(sd.build(), sd.camera_at(0.0), s, sampling.prng_key(1),
                             device="cpu")
    assert calls == [route] and torch.isfinite(img).all()


@pytest.mark.parametrize("settings", [
    dict(differentiable=True, diff_t="analytic"),
    dict(differentiable=False, diff_t="rederive"),
])
def test_geometry_leaf_needs_rederive(settings):
    """A prims.data leaf raises under "analytic", and on a forward
    render; an unknown diff_t raises."""
    sd = get_scene("TwoSphereCheckers")
    scene = _with_data(sd.build(), sd.build().prims.data.clone().requires_grad_(True))
    s = RenderSettings(4, 3, 1, 2, (0.5, 0.5, 0.5), **settings)
    with pytest.raises(NotImplementedError, match='diff_t="rederive"'):
        render_radiance(scene, sd.camera_at(0.0), s, sampling.prng_key(1), device="cpu")
    with pytest.raises(ValueError, match="diff_t"):
        render_radiance(sd.build(), sd.camera_at(0.0),
                        dataclasses.replace(s, diff_t="exact"), sampling.prng_key(1),
                        device="cpu")


def test_geometry_step_deterministic_and_big_scene(monkeypatch):
    """The same step twice: the prims.data gradient bit for bit.  On
    SphereField the search is K5's plain version (``detached_search`` on
    the projected tables) and the prims.data gradient is finite."""
    runs = [_port_step("TwoSphereCheckers", "rederive", True)[2] for _ in range(2)]
    np.testing.assert_array_equal(runs[0], runs[1])
    calls = []
    search = integrator.closest_hit_projected

    def spy(*a, **k):
        calls.append(1)
        return search(*a, **k)

    monkeypatch.setattr(integrator, "closest_hit_projected", spy)
    sd = get_scene("SphereField")
    scene = sd.build()
    data = scene.prims.data.clone().requires_grad_(True)
    scene = _with_data(scene, data)
    s = RenderSettings(12, 8, 1, 4, sd.output.image.background, diff_t="rederive")
    params = DiffParams.from_scene(scene, sd.camera_at(0.0, make=CameraParams.create),
                                   s.background)
    render_loss_and_grad(params, scene, s, sampling.prng_key(2), torch.zeros(8, 12, 3),
                         device="cpu")
    assert len(calls) == 4 and data.grad.shape == data.shape
    assert torch.isfinite(data.grad).all()


# the sharded geometry step, the packed sharded render and the sharded
# checkpoint's scheme guard share one spawn of two ranks (a 1x2 grid)
SHARDED_GEOMETRY = dict(mesh=[1, 2], scene="TwoSphereCheckers",
                        settings=dict(width=16, height=9, samples_per_pixel=4,
                                      max_bounces=4, background=[1.0, 1.0, 1.0],
                                      spp_chunk=2, diff_t="rederive"),
                        key=0, camera=[[13.0, 2.0, 3.0], [0.0, 0.0, 0.0],
                                       [0.0, 1.0, 0.0], 20.0, 854.0 / 480.0, 0.0, 10.0],
                        geometry=True)
SHARDED_PACKED = dict(mesh=[1, 2], scene="SphereField",
                      settings=dict(width=16, height=9, samples_per_pixel=8,
                                    max_bounces=5, background=[1.0, 1.0, 1.0],
                                    spp_chunk=1, rng_scheme="packed"), key=3)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("geometry")
    ckpt = dict(SHARDED_PACKED, path=str(tmp / "ck.npz"), every=1)
    legacy = dict(ckpt, settings=dict(SHARDED_PACKED["settings"], rng_scheme="legacy"))
    return run_ranks("slice", 2, tmp, timeout=150, grad=[SHARDED_GEOMETRY],
                     render=[SHARDED_PACKED],
                     checkpoint=[dict(ckpt, stop_at=2), dict(legacy, stop_at=0), ckpt])


def test_sharded_geometry_grad_matches_single_device(sharded):
    job = SHARDED_GEOMETRY
    s = RenderSettings(**dict(job["settings"], background=(1.0, 1.0, 1.0)))
    sd = get_scene(job["scene"])
    data = sd.build().prims.data.clone().requires_grad_(True)
    scene = _with_data(sd.build(), data)
    params = DiffParams.from_scene(scene, CameraParams.create(*job["camera"]),
                                   s.background)
    loss, g = render_loss_and_grad(params, scene, s, sampling.prng_key(job["key"]),
                                   torch.zeros(s.height, s.width, 3), device="cpu")
    recs = [r["grad"]["jobs"][0] for r in sharded]
    for r in recs:
        assert r["loss"] == recs[0]["loss"] and torch.equal(r["data"], recs[0]["data"])
    np.testing.assert_allclose(recs[0]["loss"], float(loss), rtol=1e-6)
    want = data.grad.numpy()
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(recs[0]["data"].numpy(), want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    floor = 1e-6 * max(float(w.abs().max()) for w in g.leaves())
    for got, w in zip(recs[0]["grads"], g.leaves()):
        scale = float(w.abs().max())
        np.testing.assert_allclose(got.numpy(), w.numpy(), rtol=0,
                                   atol=1e-4 * scale + floor)


def test_sharded_packed_render_matches_single_device(sharded):
    job = SHARDED_PACKED
    sd = get_scene(job["scene"])
    s = RenderSettings(**dict(job["settings"], background=(1.0, 1.0, 1.0)))
    img, st = render_radiance(sd.build(), sd.camera_at(0.0), s,
                              sampling.prng_key(job["key"]), device="cpu")
    legacy, _ = render_radiance(sd.build(), sd.camera_at(0.0),
                                dataclasses.replace(s, rng_scheme="legacy"),
                                sampling.prng_key(job["key"]), device="cpu")
    rec = sharded[0]["render"]["jobs"][0]
    np.testing.assert_allclose(rec["img"].numpy(), img.numpy(), rtol=0, atol=2e-6)
    assert rec["segments"] == float(st.segments)
    assert not torch.equal(img, legacy)  # another stream


def test_sharded_checkpoint_guards_the_scheme(sharded):
    """A packed sharded checkpoint stopped after 2 of a rank's 4 chunks:
    a legacy job on the file does not resume from it (it starts at chunk
    0, where it is stopped before it saves), and a packed one resumes at
    chunk 2 and equals the uninterrupted packed render bit for bit."""
    stopped, legacy, resumed = sharded[0]["checkpoint"]["jobs"]
    assert stopped == {"stopped": True, "ran": [0, 1]}
    assert legacy == {"stopped": True, "ran": []}
    assert resumed["ran"] == [2, 3]
    rec = sharded[0]["render"]["jobs"][0]
    assert torch.equal(resumed["img"], rec["img"])
