"""The packed counter-mode RNG scheme (``rng_scheme="packed"``) on the CPU.

The JAX package's ``RPT_RNG_SCHEME=packed`` draws a lane-bounce's
scatter uniforms from 4 threefry blocks under the raw lane key.  Here:

* the port's ``scatter_uniforms`` / ``bounce_draws(..., "packed")``
  against JAX's ``scatter_uniforms`` BIT FOR BIT, at a scalar bounce,
  per-lane depths and (B, 1) bounces, with and without roulette;
* the packed hoisted draws, ``bounce_draws_plain`` and the keyed K1's
  plain version against JAX's packed ``_precompute_draws`` (bit for
  bit), and the plain bounce against JAX's Pallas K1 in interpret mode
  fed those draws, under ``test_torch_fused_bounce.py``'s contract
  (masks and winners exact, floats within rtol 2e-3 / atol 1e-4: XLA:CPU
  contracts FMAs, and the port takes a sphere's roots in f64);
* the draw kernel's packed branch (``ops/csrc/draws.cu``) built with
  g++ against ``tests/cuda_emu.h``, bit for bit against its plain twin;
* packed renders against JAX's under ``RPT_RNG_SCHEME=packed`` (the
  variable is read at trace time, so the caches are cleared before and
  after): CornellBox (fused), the image scene (generic, forward),
  TwoSphereCheckers (generic, the differentiable render's image),
  SphereField (projected; both builders on the numpy BVH) and LightTest
  regen, under
  the image contract (``utils.image.image_agreement``: the mean within
  1%, 90% of the pixels close, no NaN), and a packed render's stream
  differs from the legacy one.  On CornellBox one lane of the 2,048
  differs (pixel 87, sample 5): its camera ray meets glass sphere 2 near
  the rim, JAX's f32 root lands its point inside the sphere and the
  scattered ray meets the sphere again, where the port's f64 root
  follows the f64 path to the light (``test_cornell_lane_follows_f64``).
  That lane is 1.875 of that pixel's 3 channels and 4.7% of the image
  mean; the contract holds on every other pixel, and that pixel differs
  by exactly the lane;
* the f64 oracle gate (``tests/oracle.py``, the JAX package's bounds) on
  a packed render; the cascade under packed equal to the chunked render
  bit for bit; a checkpoint stopped and resumed under packed equal to
  the uninterrupted render bit for bit, and a legacy file not resumed
  by a packed render (nor the other way round).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_pathtracer_tpu import integrator as j_integrator
from rust_pathtracer_tpu import sampling as js
from rust_pathtracer_tpu.integrator import T_MIN
from rust_pathtracer_tpu.ops.fused_bounce import FLG_BESTI_SHIFT, FLG_HIT
from rust_pathtracer_tpu.ops.fused_bounce import _fused_bounce_cols
from rust_pathtracer_tpu.ops.fused_bounce import pack_prims_shaded as j_pack
from rust_pathtracer_tpu.render import RenderSettings as JRenderSettings
from rust_pathtracer_tpu.render import render_radiance as j_render_radiance
from rust_pathtracer_tpu.wavefront import render_radiance_regen as j_render_regen
from rust_pathtracer_tpu_torch import integrator, render, sampling
from rust_pathtracer_tpu_torch.ops import draws
from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
from rust_pathtracer_tpu_torch.utils import checkpoint as ck
from rust_pathtracer_tpu_torch.utils.image import image_agreement
from rust_pathtracer_tpu_torch.wavefront import render_radiance_regen
from test_fused_bounce import _full_scene as j_full_scene
from test_torch_cuda import _random_lanes, t_full_scene
from test_torch_draws import _assert_draws_equal, _keys, emu_lib, launch_emulated  # noqa: F401
from test_torch_oracle import _case
from test_torch_wavefront import _scenes

torch.set_num_threads(2)

PACKED = "packed"
# name -> (width, height, spp, bounces, background); the renderers'
# cases
SHAPES = {
    "CornellBox": (16, 16, 8, 8, (0.0, 0.0, 0.0)),
    "image": (16, 12, 4, 6, (0.1, 0.1, 0.1)),
    "TwoSphereCheckers": (16, 9, 4, 6, (1.0, 1.0, 1.0)),
    "SphereField": (16, 9, 4, 6, (1.0, 1.0, 1.0)),
    "LightTest": (20, 20, 8, 10, (0.0, 0.0, 0.0)),
}
KEY = 5


def _bits(x):
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32)


def _packed_env():
    """Set RPT_RNG_SCHEME=packed for JAX (caches cleared); returns the
    undo."""
    saved = os.environ.get("RPT_RNG_SCHEME")
    os.environ["RPT_RNG_SCHEME"] = PACKED
    jax.clear_caches()

    def undo():
        if saved is None:
            os.environ.pop("RPT_RNG_SCHEME")
        else:
            os.environ["RPT_RNG_SCHEME"] = saved
        jax.clear_caches()
    return undo


@pytest.mark.parametrize("with_roulette", [False, True])
def test_scatter_uniforms_match_jax(with_roulette):
    n = 3000
    lk = sampling.lane_keys(sampling.prng_key(9), torch.arange(n))
    jlk = jnp.asarray(lk.numpy().astype(np.uint32))
    depth = np.random.default_rng(2).integers(0, 64, n)
    for bounce in (0, 7, 2**31 + 5, depth, np.arange(5)[:, None]):
        t_b = torch.as_tensor(bounce) if isinstance(bounce, np.ndarray) else bounce
        j_b = jnp.asarray(bounce, jnp.uint32) if isinstance(bounce, np.ndarray) else bounce
        got = sampling.bounce_draws(lk, t_b, with_roulette, PACKED)
        want = js.scatter_uniforms(jlk, j_b, with_roulette)
        assert (got[3] is None) == (want[3] is None)
        for g, w in zip(got, want):
            if w is not None:
                assert g.shape == w.shape
                np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=str(bounce))
    # not the legacy stream
    leg = sampling.bounce_draws(lk, 7, with_roulette)
    assert not torch.equal(leg[0], sampling.bounce_draws(lk, 7, with_roulette, PACKED)[0])
    with pytest.raises(ValueError, match="rng_scheme"):
        sampling.bounce_draws(lk, 7, with_roulette, "counter")


@pytest.fixture(scope="module")
def jax_draws():
    """JAX's packed hoisted draws of bounces 0-11 for 512 lanes, and its
    Pallas K1 in interpret mode on bounce 6's draws."""
    n, nb, b = 512, 12, 6
    lk = sampling.lane_keys(sampling.prng_key(13), torch.arange(n))
    undo = _packed_env()
    try:
        dr = j_integrator._precompute_draws(jnp.asarray(lk.numpy().astype(np.uint32)),
                                            nb, 3)
        dr = {k: np.asarray(v) for k, v in dr.items()}
        jscene = j_full_scene()
        cols, _ = _random_lanes(n, seed=11)
        jcols = {k: jnp.asarray(cols[i]) for i, k in enumerate(fb._COL_KEYS)}
        su, bu = dr["sphere_u"][b], dr["ball_u"][b]
        uni = [su[:, 0], su[:, 1], bu[:, 0], bu[:, 1], bu[:, 2], dr["coin"][b]]
        jout, jres = _fused_bounce_cols(
            j_pack(jscene), jnp.asarray((0.2, 0.1, 0.05), jnp.float32),
            jnp.asarray(jscene.textures.perlin_seed, jnp.uint32), jcols,
            *[jnp.asarray(u) for u in uni], kinds=jscene.kinds_static,
            mat_types=jscene.mat_types, tex_types=jscene.tex_types,
            t_min=float(T_MIN), interpret=True, want_residuals=True)
        j_out = np.stack([np.asarray(jout[k]) for k in fb._COL_KEYS])
        flags = np.asarray(jres["flags"]).reshape(-1)[:n]
    finally:
        undo()
    return lk, dr, cols, j_out, np.where(flags & FLG_HIT, flags >> FLG_BESTI_SHIFT, -1)


def test_packed_draws_match_jax_hoisted(jax_draws):
    """The hoisted draws and the draw kernel's plain twin, bounce by
    bounce and at per-lane depth, are JAX's packed hoisted draws."""
    lk, dr, _, _, _ = jax_draws
    mine = integrator._precompute_draws(lk, 12, 3, rng_scheme=PACKED)
    assert set(mine) == set(dr)
    for k in dr:
        np.testing.assert_array_equal(_bits(mine[k]), _bits(dr[k]), err_msg=k)
    keys = fb.key_words(lk)
    for b in (0, 6, 11):
        got = draws.bounce_draws(keys, b, b >= 3, PACKED)
        want = (dr["sphere_u"][b], dr["ball_u"][b], dr["coin"][b],
                dr["roulette"][b] if b >= 3 else None)
        for g, w in zip(got, want):
            assert (g is None) == (w is None)
            if w is not None:
                np.testing.assert_array_equal(_bits(g), _bits(w))
    depth = torch.from_numpy(np.random.default_rng(3).integers(0, 12, lk.shape[0])
                             .astype(np.int32))
    got = draws.bounce_draws(keys, depth, True, PACKED)
    lanes = np.arange(lk.shape[0])
    d = depth.numpy()
    for g, k in zip(got, ("sphere_u", "ball_u", "coin", "roulette")):
        np.testing.assert_array_equal(_bits(g), _bits(dr[k][d, lanes]))


def test_packed_plain_bounce_matches_pallas_interpret(jax_draws):
    """The keyed K1's plain version under packed against JAX's Pallas K1
    (interpret mode) fed JAX's packed draws of the same bounce."""
    lk, _, cols, j_out, j_win = jax_draws
    tscene = t_full_scene()
    win = torch.empty(cols.shape[1], dtype=torch.int32)
    out = fb.fused_bounce_keyed(
        fb.pack_prims_shaded(tscene), torch.tensor((0.2, 0.1, 0.05)),
        tscene.textures.perlin_seed, torch.from_numpy(cols), fb.key_words(lk), 6,
        with_roulette=False, kinds=tscene.kinds_static, mat_types=tscene.mat_types,
        tex_types=tscene.tex_types, t_min=T_MIN, winner_out=win, rng_scheme=PACKED)
    t_out = out.numpy()
    np.testing.assert_array_equal(t_out[12], j_out[12])
    np.testing.assert_array_equal(win.numpy(), j_win)
    assert (j_win >= 0).sum() > 200
    np.testing.assert_allclose(t_out, j_out, rtol=2e-3, atol=1e-4)
    # the plain version is the uniforms-in bounce on the packed draws
    su, bu, coin, _ = draws.bounce_draws(fb.key_words(lk), 6, False, PACKED)
    ref = fb.fused_bounce_cols_plain(
        fb.pack_prims_shaded(tscene), torch.tensor((0.2, 0.1, 0.05)),
        tscene.textures.perlin_seed, fb.state_cols(torch.from_numpy(cols)), su[:, 0],
        su[:, 1], bu[:, 0], bu[:, 1], bu[:, 2], coin, kinds=tscene.kinds_static,
        mat_types=tscene.mat_types, tex_types=tscene.tex_types, t_min=T_MIN)
    np.testing.assert_array_equal(_bits(out), _bits(torch.stack(
        [ref[k] for k in fb._COL_KEYS])))


@pytest.mark.parametrize("n", [1, 257, 1000])
def test_emulated_packed_draws_match_plain(n, emu_lib):
    """``draws.cu``'s packed branch on the emulated card, bit for bit
    against ``bounce_draws_plain(..., "packed")``."""
    keys, _ = _keys(n, 200 + n)
    depth = torch.from_numpy(np.random.default_rng(n).integers(0, 64, n).astype(np.int32))
    for bounce in (0, 19, 2**31 + 5, depth):
        for rr in (False, True):
            _assert_draws_equal(launch_emulated(emu_lib, keys, bounce, rr, packed=True),
                                draws.bounce_draws_plain(keys, bounce, rr, PACKED),
                                f"{bounce} {rr}")


def _settings(name, cls=RenderSettings, **kw):
    """The case's settings; TwoSphereCheckers renders differentiably, the
    generic route (its perlin sphere keeps it off K1 and K2)."""
    w, h, spp, nb, bg = SHAPES[name]
    return cls(w, h, spp, nb, bg, differentiable=name == "TwoSphereCheckers", **kw)


@pytest.fixture(scope="module")
def jax_renders():
    """JAX's packed images: the chunked render of CornellBox, the image
    scene, TwoSphereCheckers (differentiable) and SphereField (its
    projected route, RPT_PROJ_INTERPRET=1), and LightTest's regen with
    1,024 lanes."""
    out = {}
    undo = _packed_env()
    saved = os.environ.get("RPT_PROJ_INTERPRET")
    os.environ["RPT_PROJ_INTERPRET"] = "1"
    try:
        for name in ("CornellBox", "image", "TwoSphereCheckers", "SphereField"):
            jscene, jcam, _, _ = _scenes(name)
            img, _ = j_render_radiance(jscene, jcam, _settings(name, JRenderSettings),
                                       jax.random.PRNGKey(KEY))
            out[name] = np.asarray(img)
        jscene, jcam, _, _ = _scenes("LightTest")
        img, _ = j_render_regen(jscene, jcam, _settings("LightTest", JRenderSettings),
                                jax.random.PRNGKey(KEY), lanes=1024)
        out["LightTest"] = np.asarray(img)
    finally:
        if saved is None:
            os.environ.pop("RPT_PROJ_INTERPRET")
        else:
            os.environ["RPT_PROJ_INTERPRET"] = saved
        undo()
    return out


def _port(name, **kw):
    _, _, scene, cam = _scenes(name)
    s = _settings(name, **kw)
    if name == "LightTest":
        return render_radiance_regen(scene, cam, s, sampling.prng_key(KEY), lanes=1024,
                                     device="cpu")
    return render_radiance(scene, cam, s, sampling.prng_key(KEY), device="cpu")


# CornellBox 16x16, 8 spp, key 5, packed: the lane where JAX's f32 sphere
# root parts from the f64 path (module note); the glass sphere and the
# light are primitives 19 and 4
CB_PIXEL, CB_SAMPLE, CB_SPHERE, CB_LIGHT = 87, 5, 19, 4


@pytest.mark.parametrize("name", list(SHAPES))
def test_packed_render_matches_jax(name, jax_renders):
    img, _ = _port(name, rng_scheme=PACKED)
    got, want = img.detach().numpy(), jax_renders[name]
    if name == "CornellBox":  # the pinned lane, then the contract without it
        w, spp = SHAPES[name][0], SHAPES[name][2]
        row, col = divmod(CB_PIXEL, w)
        np.testing.assert_array_equal(got[row, col] - want[row, col],
                                      np.full(3, 15.0 / spp, np.float32))
        got, want = got.copy(), want.copy()
        got[row, col] = want[row, col] = 0.0
    a = image_agreement(got, want)
    assert a["ok"] and not a["has_nan"], a
    legacy, _ = _port(name)
    assert not torch.equal(img, legacy)


def test_cornell_lane_follows_f64():
    """The CornellBox lane of the module note, traced in f64 from the
    camera ray both packages agree on bit for bit: the f64 root puts the
    hit on glass sphere 2 within 1e-5 of its surface, as the port's
    point is, while JAX's f32 point lies 1e-3 inside; from the port's
    point its scattered ray meets the light first, in f64 too, and the
    lane's radiance is the light's 15 on the port's side."""
    from rust_pathtracer_tpu import render as j_render
    from rust_pathtracer_tpu_torch.ops.closest_hit import closest_hit_record_plain
    from rust_pathtracer_tpu_torch.ops.closest_hit import pack_prims
    from rust_pathtracer_tpu_torch.render import _make_lanes

    jscene, jcam, scene, cam = _scenes("CornellBox")
    w, h, spp, _, _ = SHAPES["CornellBox"]
    lk, o, d, _ = _make_lanes(cam, sampling.prng_key(KEY), torch.tensor([CB_PIXEL]),
                              CB_SAMPLE, width=w, height=h, spp_chunk=1, spp_total=spp)
    _, jo, jd, _ = j_render._make_lanes(
        jcam, jax.random.PRNGKey(KEY), np.array([CB_PIXEL], np.uint32),
        jnp.uint32(CB_SAMPLE), width=w, height=h, spp_chunk=1, spp_total=spp)
    np.testing.assert_array_equal(np.asarray(jo), o.numpy())
    np.testing.assert_array_equal(np.asarray(jd), d.numpy())
    table64 = pack_prims(scene.prims).double()
    hit, _, idx, rec = closest_hit_record_plain(table64, o.double(), d.double(),
                                                kinds=scene.kinds_static, t_min=T_MIN)
    assert bool(hit[0]) and int(idx[0]) == CB_SPHERE
    centre = scene.prims.data[CB_SPHERE, 0:3].double().numpy()
    radius = float(scene.prims.data[CB_SPHERE, 3])

    def off_surface(p):
        return float(np.linalg.norm(np.asarray(p, np.float64) - centre)) - radius

    assert abs(off_surface(rec.point[0].numpy())) < 1e-9
    one = torch.ones(1, 3)
    st, _ = integrator.trace_resume(scene, o, d, one, 0 * one, torch.ones(1, dtype=bool),
                                    lk, torch.zeros(3), 0, 1, rng_scheme=PACKED)
    jst, _ = j_integrator.trace_resume(jscene, jo, jd, jnp.ones((1, 3)),
                                       jnp.zeros((1, 3)), jnp.ones(1, bool),
                                       jnp.asarray(lk.numpy().astype(np.uint32)),
                                       jnp.zeros(3), 0, 1)
    assert abs(off_surface(st["o"][0].numpy())) < 1e-5
    assert off_surface(np.asarray(jst["o"])[0]) < -5e-4
    hit1, _, idx1, _ = closest_hit_record_plain(table64, st["o"].double(),
                                                st["d"].double(),
                                                kinds=scene.kinds_static, t_min=T_MIN)
    assert bool(hit1[0]) and int(idx1[0]) == CB_LIGHT
    rad, _ = integrator.trace(scene, o, d, lk, torch.zeros(3), SHAPES["CornellBox"][3],
                              rng_scheme=PACKED)
    np.testing.assert_array_equal(rad.numpy(), np.full((1, 3), 15.0, np.float32))


def test_packed_render_passes_the_oracle_gate():
    """CornellBox under the JAX package's f64 oracle bounds, packed."""
    scene, cam, settings, oracle_mean, oracle_img, mean_rtol, mad = _case("CornellBox")
    img, st = render_radiance(scene, cam, dataclasses.replace(settings, rng_scheme=PACKED),
                              sampling.prng_key(0), device="cpu")
    ours = img.numpy().astype(np.float64)
    assert np.isfinite(ours).all()
    assert abs(ours.mean() - oracle_mean) / oracle_mean < mean_rtol
    assert np.abs(ours - oracle_img).mean() < mad


@pytest.mark.parametrize("name,schedule", [("SphereField", "3:2,5:4"),
                                           ("CornellBox", None), ("image", "auto")])
def test_packed_cascade_equals_chunked(name, schedule):
    chunked = _port(name, rng_scheme=PACKED)
    cascade = _port(name, rng_scheme=PACKED, cascade=True, cascade_schedule=schedule)
    for a, b in ((chunked[0], cascade[0]), (chunked[1].segments, cascade[1].segments),
                 (chunked[1].occupancy, cascade[1].occupancy)):
        assert torch.equal(a, b)


class _Stop(RuntimeError):
    pass


def test_packed_checkpoint_resumes_exactly_and_guards_the_scheme(tmp_path, monkeypatch):
    """Stopped after 2 of 4 chunks and resumed under packed: the
    uninterrupted packed render bit for bit.  The file records the
    scheme: a legacy render does not resume from it (it renders every
    chunk), nor a packed render from a legacy file."""
    _, _, scene, cam = _scenes("CornellBox")
    s = RenderSettings(12, 12, 8, 6, (0.0, 0.0, 0.0), spp_chunk=2, rng_scheme=PACKED)
    key = sampling.prng_key(4)
    ref, ref_st = render_radiance(scene, cam, s, key, device="cpu")
    real, calls = render._render_chunk, []

    def counting(*a, stop=None, **k):
        if len(calls) == stop:
            raise _Stop()
        calls.append(a[3])
        return real(*a, **k)

    p = str(tmp_path / "ck.npz")
    monkeypatch.setattr(render, "_render_chunk", lambda *a, **k: counting(*a, stop=2, **k))
    with pytest.raises(_Stop):
        ck.render_radiance_checkpointed(scene, cam, s, key, p, device="cpu")
    assert calls == [0, 2] and ck.load_checkpoint(p).rng_scheme == PACKED
    monkeypatch.setattr(render, "_render_chunk", counting)
    legacy = dataclasses.replace(s, rng_scheme="legacy")
    q = str(tmp_path / "legacy.npz")
    ck.save_checkpoint(q, ck.load_checkpoint(p))  # a copy to start the legacy job on
    calls.clear()
    img, _ = ck.render_radiance_checkpointed(scene, cam, legacy, key, q, device="cpu")
    assert calls == [0, 2, 4, 6] and ck.load_checkpoint(q).rng_scheme == "legacy"
    assert torch.equal(img, render_radiance(scene, cam, legacy, key, device="cpu")[0])
    calls.clear()
    img, st = ck.render_radiance_checkpointed(scene, cam, s, key, p, device="cpu")
    assert calls == [4, 6]
    assert torch.equal(img, ref) and float(st.segments) == float(ref_st.segments)
    calls.clear()
    img, _ = ck.render_radiance_checkpointed(scene, cam, s, key, q, device="cpu")
    assert calls == [0, 2, 4, 6] and torch.equal(img, ref)  # the legacy file restarts
