"""The generic bounce's shading against the JAX package, on the CPU:
textures (solid, checker at depth 1 and 2, perlin, image), emission and
scatter, the texture VJP, and the non-differentiable generic trace
(K3's plain version) on an image-textured scene.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_pathtracer_tpu import materials as jm
from rust_pathtracer_tpu import sampling as js
from rust_pathtracer_tpu import textures as jt
from rust_pathtracer_tpu.integrator import trace as j_trace
from rust_pathtracer_tpu.ops.intersect import HitRecord as JHitRecord
from rust_pathtracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from rust_pathtracer_tpu_torch import materials as tm
from rust_pathtracer_tpu_torch import sampling as ts
from rust_pathtracer_tpu_torch import textures as tt
from rust_pathtracer_tpu_torch.integrator import trace as t_trace
from rust_pathtracer_tpu_torch.ops.intersect import HitRecord as THitRecord
from rust_pathtracer_tpu_torch.scene import SceneBuilder as TSceneBuilder
from test_fused_bounce import _compare_diverging

torch.set_num_threads(2)

N = 1024


def _texture_scene(builder):
    """Every texture kind: solids, a checker of solids (depth 1), a
    checker of a checker and an image (depth 2), a checker of perlin and
    a second, smaller image (padded into the stack); every material."""
    b = builder()
    red = b.solid_texture((0.8, 0.1, 0.1))
    white = b.solid_texture((0.9, 0.9, 0.9))
    ck1 = b.checker_texture(red, white, 3.0)
    rng = np.random.default_rng(1)
    img = b.image_texture(rng.uniform(0.0, 1.0, (5, 7, 3)).astype(np.float32))
    img2 = b.image_texture(rng.uniform(0.0, 1.0, (3, 4, 3)).astype(np.float32))
    pl = b.perlin_texture(2.5)
    ck2 = b.checker_texture(ck1, img, 5.0)
    ck3 = b.checker_texture(pl, img2, 1.5)
    mats = [b.lambertian(t) for t in (red, ck1, img, ck2)]
    mats += [b.metal(ck3, 0.3), b.metal(white, 0.0), b.dielectric(1.5),
             b.dielectric(0.7), b.diffuse_light(pl), b.diffuse_light(img2)]
    for i, m in enumerate(mats):
        b.add_sphere((float(i), 0.0, -3.0), 0.4, m)
    return b.build(use_bvh=False)


@pytest.fixture(scope="module")
def scenes():
    return _texture_scene(JSceneBuilder), _texture_scene(TSceneBuilder)


def _inputs(n_tex, seed):
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, n_tex, N).astype(np.int32)
    u, v = rng.uniform(-0.1, 1.1, (2, N)).astype(np.float32)
    p = rng.uniform(-3.0, 3.0, (N, 3)).astype(np.float32)
    return tex, u, v, p


def test_scene_tables_equal(scenes):
    """The image stack, image ids, sizes and checker depth carry over."""
    js_, ts_ = scenes
    for f in ("kind", "color", "child", "scale", "image_id", "images", "image_hw"):
        np.testing.assert_array_equal(getattr(ts_.textures, f).numpy(),
                                      np.asarray(getattr(js_.textures, f)), err_msg=f)
    assert ts_.checker_depth == js_.checker_depth == 2
    assert ts_.tex_types == js_.tex_types and not ts_.shade_static


def test_eval_texture_matches_jax(scenes):
    """Every kind on 1024 lanes: within 1e-5 rel / 1e-6 abs (sin and the
    perlin marble differ by ulps; XLA contracts the bilinear blend into
    FMAs)."""
    js_, ts_ = scenes
    tex, u, v, p = _inputs(js_.textures.kind.shape[0], seed=3)
    want = jt.eval_texture(js_.textures, jnp.asarray(tex), jnp.asarray(u), jnp.asarray(v),
                           jnp.asarray(p), js_.tex_types, checker_depth=js_.checker_depth)
    got = tt.eval_texture(ts_.textures, torch.from_numpy(tex), torch.from_numpy(u),
                          torch.from_numpy(v), torch.from_numpy(p), ts_.tex_types,
                          checker_depth=ts_.checker_depth)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    kinds = ts_.textures.kind.numpy()[tex]
    assert all((kinds == k).sum() > 50 for k in range(4))
    # depth 1 alone leaves the depth-2 checker on its child checker
    one = tt.eval_texture(ts_.textures, torch.from_numpy(tex), torch.from_numpy(u),
                          torch.from_numpy(v), torch.from_numpy(p), ts_.tex_types,
                          checker_depth=1)
    assert not torch.equal(one, got)


def test_eval_texture_vjp_matches_jax(scenes):
    """The VJP with respect to the colours, the texels, the point and
    u, v against jax.vjp: within 1e-4 rel + 1e-5 of the largest."""
    js_, ts_ = scenes
    tex, u, v, p = _inputs(js_.textures.kind.shape[0], seed=5)
    cot = np.random.default_rng(6).normal(size=(N, 3)).astype(np.float32)

    def jfn(color, images, u_, v_, p_):
        texs = js_.textures._replace(color=color, images=images)
        return jt.eval_texture(texs, jnp.asarray(tex), u_, v_, p_, js_.tex_types,
                               checker_depth=js_.checker_depth)

    jargs = (js_.textures.color, js_.textures.images, jnp.asarray(u), jnp.asarray(v),
             jnp.asarray(p))
    _, vjp = jax.vjp(jfn, *jargs)
    want = vjp(jnp.asarray(cot))

    targs = [x.clone().requires_grad_(True) for x in (
        ts_.textures.color, ts_.textures.images, torch.from_numpy(u),
        torch.from_numpy(v), torch.from_numpy(p))]
    import dataclasses

    texs = dataclasses.replace(ts_.textures, color=targs[0], images=targs[1])
    out = tt.eval_texture(texs, torch.from_numpy(tex), *targs[2:], ts_.tex_types,
                          checker_depth=ts_.checker_depth)
    got = torch.autograd.grad(out, targs, torch.from_numpy(cot))
    for name, g, w in zip(("color", "images", "u", "v", "point"), got, want):
        w = np.asarray(w)
        assert np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)


def test_eval_texture_valid_mask_is_bit_neutral(scenes):
    """``valid`` (the lanes with a hit): the value on those lanes and the
    colour gradient of a cotangent that is 0 on the others (as the
    bounce's ``where`` makes it) are bit for bit those without the mask;
    the masked lanes read 0 from the spare rows, which keep their
    gradient off the table's rows."""
    import dataclasses

    _, ts_ = scenes
    tex, u, v, p = _inputs(ts_.textures.kind.shape[0], seed=7)
    valid = torch.from_numpy(np.random.default_rng(8).uniform(size=N) < 0.6)
    cot = torch.from_numpy(np.random.default_rng(9).normal(size=(N, 3)).astype(np.float32))
    cot = torch.where(valid[:, None], cot, 0.0)
    outs, grads = [], []
    for mask in (None, valid):
        color = ts_.textures.color.clone().requires_grad_(True)
        texs = dataclasses.replace(ts_.textures, color=color)
        out = tt.eval_texture(texs, torch.from_numpy(tex), torch.from_numpy(u),
                              torch.from_numpy(v), torch.from_numpy(p), ts_.tex_types,
                              checker_depth=ts_.checker_depth, valid=mask)
        outs.append(out.detach())
        grads.append(torch.autograd.grad(out, color, cot)[0])
    assert torch.equal(outs[1][valid], outs[0][valid])
    solid = ts_.textures.kind[torch.from_numpy(tex).long()] == tt.TEX_SOLID
    assert torch.equal(outs[1][~valid & solid], torch.zeros_like(outs[1][~valid & solid]))
    assert torch.equal(grads[1], grads[0]) and grads[0].abs().max() > 0


def _hit_inputs(n_mat, seed):
    rng = np.random.default_rng(seed)
    n = rng.normal(size=(N, 3))
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    d = rng.normal(size=(N, 3)) * rng.uniform(0.5, 2.0, (N, 1))
    # on half the lanes the normal faces the ray, as a record's does;
    # on the other half it need not, so that a metal can absorb
    n = np.where(((np.sum(d * n, 1) > 0) & (rng.random(N) < 0.5))[:, None], -n, n)
    front = rng.random(N) < 0.5
    return dict(
        normal=n.astype(np.float32), d=d.astype(np.float32), front=front,
        point=rng.uniform(-3.0, 3.0, (N, 3)).astype(np.float32),
        u=rng.uniform(0.0, 1.0, N).astype(np.float32),
        v=rng.uniform(0.0, 1.0, N).astype(np.float32),
        mat=rng.integers(0, n_mat, N).astype(np.int32),
        sphere_u=rng.random((N, 2)).astype(np.float32),
        ball_u=rng.random((N, 3)).astype(np.float32),
        coin=rng.random(N).astype(np.float32))


def test_scatter_and_emitted_match_jax(scenes):
    """Every material, both faces: emitted and the scatter's direction
    and attenuation within 1e-5 rel / 1e-6 abs (sin, cos, acos and cbrt
    differ by ulps between the libraries), the scatter mask exact."""
    js_, ts_ = scenes
    x = _hit_inputs(js_.materials.kind.shape[0], seed=9)
    R = N

    def rec(mod, H):
        a = {k: mod(x[k]) for k in ("point", "normal", "u", "v", "mat")}
        return H(valid=mod(np.ones(R, bool)), t=mod(np.ones(R, np.float32)),
                 point=a["point"], normal=a["normal"], front_face=mod(x["front"]),
                 u=a["u"], v=a["v"], mat=a["mat"], prim=mod(np.zeros(R, np.int32)))

    jrec, trec = rec(jnp.asarray, JHitRecord), rec(torch.from_numpy, THitRecord)
    jsi, tsi = jm.shade_inputs(js_, jrec), tm.shade_inputs(ts_, trec)
    np.testing.assert_allclose(tsi.value.numpy(), np.asarray(jsi.value), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(tm.emitted(ts_, trec, tsi).numpy(),
                               np.asarray(jm.emitted(js_, jrec, jsi)), rtol=1e-5,
                               atol=1e-6)
    jsd = js.on_unit_sphere_from_u(jnp.asarray(x["sphere_u"]))
    jbd = js.in_unit_sphere_from_u(jnp.asarray(x["ball_u"]))
    tsd = ts.on_unit_sphere_from_u(torch.from_numpy(x["sphere_u"]))
    tbd = ts.in_unit_sphere_from_u(torch.from_numpy(x["ball_u"]))
    np.testing.assert_allclose(tsd.numpy(), np.asarray(jsd), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tbd.numpy(), np.asarray(jbd), rtol=1e-6, atol=1e-6)
    jsc = jm.scatter(js_, jrec, jnp.asarray(x["d"]), jsd, jbd, jnp.asarray(x["coin"]), jsi)
    tsc = tm.scatter(ts_, trec, torch.from_numpy(x["d"]), tsd, tbd,
                     torch.from_numpy(x["coin"]), tsi)
    np.testing.assert_array_equal(tsc.did_scatter.numpy(), np.asarray(jsc.did_scatter))
    for f in ("direction", "attenuation"):
        np.testing.assert_allclose(getattr(tsc, f).numpy(), np.asarray(getattr(jsc, f)),
                                   rtol=1e-5, atol=1e-6, err_msg=f)
    kinds = ts_.materials.kind.numpy()[x["mat"]]
    did = tsc.did_scatter.numpy()
    assert all((kinds == k).sum() > 50 for k in range(4))
    assert not did[kinds == 3].any() and did[kinds == 2].all()
    assert 0 < did[kinds == 1].mean() < 1  # metal absorbs below the surface


def _scene_simple(builder):
    """tests/test_grad.py::_scene_simple: a lambertian sphere, a ground
    sphere with an 8x8 image ramp, a rect light."""
    b = builder()
    b.add_sphere((0.0, 0.5, -3.0), 0.5, b.lambertian((0.4, 0.5, 0.6)))
    ramp = np.linspace(0.1, 0.9, 8 * 8 * 3).reshape(8, 8, 3).astype(np.float32)
    b.add_sphere((0.0, -100.0, -3.0), 100.0, b.lambertian(b.image_texture(ramp)))
    b.add_rect("xz", (-2.0, 4.0, -5.0), (2.0, 4.0, -1.0), -1.0,
               b.diffuse_light((5.0, 5.0, 5.0)))
    return b.build(use_bvh=False)


@pytest.mark.parametrize("rr", [None, 3])
def test_generic_trace_matches_jax_trace(rr):
    """The non-differentiable generic route (K3's plain version, the
    shading in tensor ops) on the image-textured scene, 1024 lanes,
    8 bounces, with and without roulette, against the JAX trace under
    tests/test_fused_bounce.py::_compare_diverging."""
    rng = np.random.default_rng(11)
    o = np.tile([[0.0, 1.0, 2.0]], (N, 1)).astype(np.float32)
    d = np.stack([rng.uniform(-0.4, 0.4, N), rng.uniform(-0.6, 0.1, N),
                  -np.ones(N)], 1).astype(np.float32)
    jkeys = js.lane_keys(jax.random.PRNGKey(5), jnp.arange(N, dtype=jnp.uint32))
    tkeys = ts.lane_keys(ts.prng_key(5), torch.arange(N))
    bg = (0.3, 0.4, 0.5)
    rad0, st0 = j_trace(_scene_simple(JSceneBuilder), jnp.asarray(o), jnp.asarray(d),
                        jkeys, bg, max_bounces=8, russian_roulette_start=rr)
    tscene = _scene_simple(TSceneBuilder)
    assert not tscene.shade_static
    rad1, st1 = t_trace(tscene, torch.from_numpy(o), torch.from_numpy(d), tkeys, bg,
                        max_bounces=8, russian_roulette_start=rr)
    assert 0 < st1.bounces <= 8 and float(st1.occupancy[0]) == N
    _compare_diverging(rad0, rad1.numpy(), st0, st1)
