"""The between-bounce reorder of big scenes on the CPU: the pass-set keys
(``ops/projected.py``, ``ops/passset.py``, ``ops/csrc/passset.cu``), the
routing, and the chunked, regen and cascade renders with and without it.

* keys and permutation: ``passset_sort_keys_plain`` against JAX's
  ``passset_sort_keys`` and ``passset_perm`` against JAX's, bit for bit,
  on ``tests/test_integrator.py::_cluster_scene(600)`` (5 clusters, one
  word), a table of exactly 32 clusters whose lanes pass all of them
  (JAX's ``test_passset_perm_full_mask_alias_safe``) and one of 40
  clusters (two words), with dead lanes, parked origins, zero and NaN
  direction components; ``cluster_entry_key`` and the binned sweep
  against JAX's (``tests/test_projected.py:253-312``);
* the kernel source built with g++ against ``tests/cuda_emu.h`` (as
  ``tests/test_torch_draws.py`` builds ``draws.cu``) held bit for bit to
  the plain version, at lane counts that leave partial blocks, as it is
  and with one block an SM;
* the routing of JAX's ``test_wavefront_reorder_auto_routing``;
* per lane nothing moves: the chunked trace and render, the static and
  dynamic cascades with the reorder equal them without it bit for bit
  (image, segments, occupancy); regen has equal segments and occupancy
  and its image within 2e-7 (the lanes take work ids in another order,
  so a pixel's sums add in another order);
* the port against JAX's reordered trace and regen (``RPT_PROJ_INTERPRET=1``,
  ``RPT_BIN=1``) at JAX's own tolerances (``tests/test_integrator.py:144-174``,
  ``tests/test_wavefront.py:91-117``).

The kernel on the card: ``chip_smoke.py`` phases 42-44.
"""

import dataclasses
import re
import shutil
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_pathtracer_tpu import integrator as j_integrator
from rust_pathtracer_tpu import sampling as j_sampling
from rust_pathtracer_tpu.camera import make_camera as j_make_camera
from rust_pathtracer_tpu.ops import projected as JP
from rust_pathtracer_tpu.render import RenderSettings as JRenderSettings
from rust_pathtracer_tpu.render import render_radiance as j_render_radiance
from rust_pathtracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
from rust_pathtracer_tpu.wavefront import render_radiance_regen as j_render_regen
from rust_pathtracer_tpu_torch import integrator, sampling
from rust_pathtracer_tpu_torch.camera import make_camera
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.ops import passset
from rust_pathtracer_tpu_torch.ops import projected as P
from rust_pathtracer_tpu_torch.ops._build import CSRC
from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
from rust_pathtracer_tpu_torch.scene import SceneBuilder
from rust_pathtracer_tpu_torch.wavefront import render_radiance_regen

torch.set_num_threads(2)

BG = (0.7, 0.8, 1.0)
REGEN_ATOL = 2e-7
CAM = ((0, 0, 30), (0, 0, 0), (0, 1, 0), 45.0, 1.0, 0.0, 10.0)
SMALL = (24, 24, 8, 5)  # tests/test_wavefront.py::test_regen_reorder_matches_chunked


def _cluster_scene(builder, n=600, seed=44):
    """``tests/test_integrator.py::_cluster_scene`` on ``builder``."""
    rng = np.random.default_rng(seed)
    b = builder()
    mats = [b.lambertian((0.6, 0.3, 0.3)), b.metal((0.8, 0.8, 0.8), 0.2),
            b.dielectric(1.5), b.diffuse_light((4.0, 4.0, 4.0))]
    for _ in range(n):
        b.add_sphere(rng.uniform(-12, 12, 3), rng.uniform(0.3, 0.9),
                     mats[int(rng.integers(len(mats)))])
    return b.build(use_bvh=False)


def _packed_scene(builder, n):
    """n spheres packed around the origin: every cluster's AABB holds the
    origin, so a ray from there passes every cluster."""
    rng = np.random.default_rng(n)
    b = builder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for _ in range(n):
        b.add_sphere(rng.uniform(-1.0, 1.0, 3), 0.5, m)
    return b.build(use_bvh=False)


TABLES = {"cluster600": lambda B: _cluster_scene(B),
          "full32": lambda B: _packed_scene(B, 32 * 128),
          "words2": lambda B: _cluster_scene(B, 40 * 128, seed=3)}
# hand-made cluster bounds: name -> (G, flaw); G past the 512 clusters the
# kernel stages at once at 600
HAND = {"G1": (1, None), "G31": (31, None), "G32": (32, None), "G33": (33, None),
        "G160": (160, None), "G600": (600, None), "unordered": (40, "unordered"),
        "nonfinite": (40, "nonfinite")}


def _hand_bounds(G, flaw):
    """(6, G) f32 cluster AABBs laid out as ``build_projected``'s (min
    xyz, max xyz): random boxes over the lanes' origins, the last of more
    than one a padding cluster at 1e30.  ``flaw`` "unordered" swaps
    cluster 3's x faces (an inverted box: the plain test, which takes the
    min and max of both faces, passes it where a test that picks the
    faces by the sign of 1/d fails it); "nonfinite" puts +inf at cluster
    5's max y, NaN at cluster 7's min z and -inf at cluster 9's min x."""
    rng = np.random.default_rng(G)
    c = rng.uniform(-14, 14, (3, G))
    h = rng.uniform(0.5, 6.0, (3, G))
    cb = np.concatenate([c - h, c + h]).astype(np.float32)
    if G > 1:
        cb[:, -1] = 1.0e30
    if flaw == "unordered":
        cb[[0, 3], 3] = cb[[3, 0], 3]
    elif flaw == "nonfinite":
        cb[4, 5], cb[2, 7], cb[0, 9] = np.inf, np.nan, -np.inf
    return cb


def _hand_tables(cb):
    """What the key functions read of ``ProjTables`` (``bounds8`` as the
    property builds it), for the bounds ``cb``: (JAX's, the port's)."""
    tt = types.SimpleNamespace(cluster_bounds=torch.from_numpy(cb),
                               device=torch.device("cpu"), num_groups=cb.shape[1])
    tt.bounds8 = P.ProjTables.bounds8.func(tt)
    return types.SimpleNamespace(cluster_bounds=jnp.asarray(cb)), tt


@pytest.fixture(scope="module", params=sorted(TABLES) + sorted(HAND))
def tables(request):
    """(name, JAX tables, port tables)."""
    if request.param in HAND:
        return (request.param, *_hand_tables(_hand_bounds(*HAND[request.param])))
    make = TABLES[request.param]
    return request.param, make(JSceneBuilder).proj, make(SceneBuilder).proj


def _lanes(n, seed, full=False, nonfinite=False):
    """o, d (n, 3) f32 and alive (n,) bool as numpy: random rays (from
    the origin where ``full``), a third dead, every 13th origin parked,
    zero and NaN direction components; where ``nonfinite``, infinite
    direction components and infinite and NaN origins too, so that a
    warp mixes them with finite lanes."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-14, 14, (n, 3)).astype(np.float32)
    if full:
        o[:] = 0.0
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::11, 1] = 0.0
    d[5::17, 2] = -0.0
    d[7::97, 0] = np.nan
    o[3::13] = 3.0e33
    if nonfinite:
        d[9::41, 2] = np.inf
        o[4::43, 1] = -np.inf
        o[6::47, 0] = np.nan
    alive = rng.random(n) > 1.0 / 3.0
    return o, d, alive


def _jax_keys(jt, o, d, alive):
    return np.stack([np.asarray(k) for k in JP.passset_sort_keys(
        jt, jnp.asarray(o), jnp.asarray(d), jnp.asarray(alive))])


def test_keys_and_perm_match_jax(tables):
    name, jt, tt = tables
    o, d, alive = _lanes(2048, 9, full=name == "full32")
    want = _jax_keys(jt, o, d, alive)
    got = P.passset_sort_keys_plain(tt, torch.from_numpy(o), torch.from_numpy(d),
                                    torch.from_numpy(alive))
    assert got.dtype == torch.int32 and got.shape == (1 + P.passset_words(tt.num_groups),
                                                      2048)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert passset.passset_keys(tt, torch.from_numpy(o), torch.from_numpy(d),
                                torch.from_numpy(alive)).equal(got)
    jperm = np.asarray(JP.passset_perm(jt, jnp.asarray(o), jnp.asarray(d),
                                       jnp.asarray(alive)))
    perm = P.passset_perm(tt, torch.from_numpy(o), torch.from_numpy(d),
                          torch.from_numpy(alive)).numpy()
    np.testing.assert_array_equal(perm, jperm)
    n_alive = int(alive.sum())
    assert alive[perm][:n_alive].all() and not alive[perm][n_alive:].any()
    if name == "full32":  # the alias case: live lanes with an all-ones word
        assert tt.num_groups == 32
        full = (want[1] == 0xFFFFFFFF) & alive
        assert full.sum() > 100
        assert set(np.flatnonzero(full)) <= set(perm[:n_alive])
    if name == "words2":
        assert tt.num_groups > 32


def test_entry_key_and_binned_sweep_match_jax():
    """``cluster_entry_key`` equals JAX's on the cluster scene (parked
    lanes key to G); K5 on the binned lanes equals K5 on the lanes as
    they are, bit for bit (JAX's test holds hits and winners exact and t
    to 1e-4, an interpreter artefact)."""
    jt, tt = _cluster_scene(JSceneBuilder).proj, _cluster_scene(SceneBuilder).proj
    o, d, _ = _lanes(913, 23)
    want = np.asarray(JP.cluster_entry_key(jt.cluster_bounds, jnp.asarray(o),
                                           jnp.asarray(d), 1e-3))
    got = P.cluster_entry_key(tt.cluster_bounds, torch.from_numpy(o),
                              torch.from_numpy(d), 1e-3)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want[3::13] == tt.num_groups).all()
    d = np.nan_to_num(d)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    for a, b in zip(P.closest_hit_projected(tt, to, td, 1e-3),
                    P.closest_hit_projected_binned(tt, to, td, 1e-3)):
        assert torch.equal(a, b)


@pytest.fixture(scope="module", params=["source", "one_block_an_sm"])
def emu_lib(request, tmp_path_factory):
    """``passset.cu`` built by ``emu_build``: as it is, and with
    BLOCKS_PER_SM = 1 (two blocks walk the tiles)."""
    from test_torch_projected_rows import emu_build

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    src = (CSRC / "passset.cu").read_text()
    if request.param == "one_block_an_sm":
        src, n = re.subn(r"constexpr int BLOCKS_PER_SM = \d+;",
                         "constexpr int BLOCKS_PER_SM = 1;", src)
        assert n == 1
    lib, n_launch = emu_build(tmp_path_factory.mktemp("passset"), "passset", src)
    assert n_launch == 1
    return lib


def _nan_free_keys(tables, o, d, alive, pick):
    """The pass-set words by the slab test with NaN-dropping min / max
    (``torch.fmin`` / ``fmax``), and where ``pick`` with the near and far
    faces picked by the sign of 1/d: what the kernel's fast test would
    give if it ran on every lane and table."""
    cb = tables.cluster_bounds
    tiny = torch.tensor(1e-30)
    inv = torch.reciprocal(torch.where(d.abs() < tiny, torch.where(d < 0, -tiny, tiny), d))
    lo = torch.full((o.shape[0], cb.shape[1]), 1e-3)
    hi = torch.full_like(lo, 1e30)
    for ax in range(3):
        b0 = (cb[ax][None] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        b1 = (cb[3 + ax][None] - o[:, ax:ax + 1]) * inv[:, ax:ax + 1]
        if pick:
            pos = inv[:, ax:ax + 1] >= 0
            near, far = torch.where(pos, b0, b1), torch.where(pos, b1, b0)
        else:
            near, far = torch.fmin(b0, b1), torch.fmax(b0, b1)
        lo, hi = torch.fmax(lo, near), torch.fmin(hi, far)
    keys = P.passset_sort_keys_plain(tables, o, d, alive)
    mask = (hi >= lo) & alive[:, None]
    for w in range(keys.shape[0] - 1):
        bits = mask[:, 32 * w:32 * (w + 1)].to(torch.int64)
        word = (bits << torch.arange(bits.shape[1])).sum(dim=1)
        keys[1 + w] = torch.where(alive, P._u32_as_i32(word), keys[1 + w])
    return keys


@pytest.mark.parametrize("n", [1, 255, 257, 1000, 3149])
def test_emulated_kernel_matches_plain(n, emu_lib, tables):
    """``passset._launch``'s call on CPU tensors, the output filled with a
    sentinel first, against ``passset_sort_keys_plain``: on the scene
    tables and the hand-made ones (G of 1, 31-33, 160 and 600, past the
    512 clusters the kernel stages at once; an inverted box; infinite and
    NaN bounds), with lanes whose o or d is infinite or NaN among finite
    ones, at lane counts below one tile of 512 lanes (256 threads of 2
    lanes) and past six (3,149: two blocks walk them where the card
    holds one an SM).  On the flawed tables a test that drops NaNs, or
    picks the faces by the sign of 1/d, gives other words: the case
    needs the kernel's exact path."""
    name, _, tt = tables
    o, d, alive = (torch.from_numpy(x) for x in _lanes(n, n, full=name == "full32",
                                                       nonfinite=True))
    want = P.passset_sort_keys_plain(tt, o, d, alive)
    if n >= 1000 and name in ("unordered", "nonfinite"):
        assert not torch.equal(_nan_free_keys(tt, o, d, alive, name == "unordered"), want)
    out = torch.full_like(want, 12345)
    err = emu_lib.passset_keys_launch(o.data_ptr(), d.data_ptr(), alive.data_ptr(),
                                      tt.bounds8.data_ptr(), tt.num_groups, 1e-3,
                                      out.data_ptr(), n, None)
    assert err == 0
    assert torch.equal(out, want)


def test_wrapper_dispatch(monkeypatch):
    """CPU tensors take the plain version (no launch counted); a wrong
    shape, dtype or device raises."""
    tt = _cluster_scene(SceneBuilder).proj
    o, d, alive = (torch.from_numpy(x) for x in _lanes(64, 1))
    monkeypatch.setattr(passset, "launches", 0)
    assert passset.passset_keys(tt, o, d, alive).shape == (2, 64)
    assert passset.launches == 0
    with pytest.raises(ValueError, match="rays"):
        passset.passset_keys(tt, o[:, :2], d, alive)
    with pytest.raises(TypeError, match="dtypes"):
        passset.passset_keys(tt, o.double(), d, alive)
    with pytest.raises(ValueError, match="tensors on meta"):
        passset.passset_keys(tt, o.to("meta"), d, alive)


def test_routing_matches_jax(monkeypatch):
    """JAX's ``test_wavefront_reorder_auto_routing``, and RPT_BIN=0/1 as
    ``reorder=False/True``: at least 4 real clusters, forward only, never
    on a scene without projected tables."""
    monkeypatch.setenv("RPT_PROJ_INTERPRET", "1")
    big = (_cluster_scene(JSceneBuilder), _cluster_scene(SceneBuilder))
    small = (_cluster_scene(JSceneBuilder, 200), _cluster_scene(SceneBuilder, 200))
    tiny = get_scene("CornellBox").build()
    for env, reorder in ((None, None), ("0", False), ("1", True)):
        if env is None:
            monkeypatch.delenv("RPT_BIN", raising=False)
        else:
            monkeypatch.setenv("RPT_BIN", env)
        for js, ts in (big, small):
            assert (integrator.use_wavefront_reorder(ts, False, reorder)
                    == j_integrator.use_wavefront_reorder(js)), (env, ts.proj.num_groups)
            assert not integrator.use_wavefront_reorder(ts, True, reorder)
            assert not j_integrator.use_wavefront_reorder(js, differentiable=True)
        assert not integrator.use_wavefront_reorder(tiny, False, reorder)
    assert integrator.use_wavefront_reorder(big[1])
    assert not integrator.use_wavefront_reorder(small[1])
    with pytest.raises(ValueError, match="reorder"):
        integrator.use_wavefront_reorder(big[1], False, "yes")


@pytest.fixture(scope="module")
def scene():
    return _cluster_scene(SceneBuilder)


def _rays(n=2048):
    rng = np.random.default_rng(9)
    o = rng.uniform(-14, 14, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    return o, d


def test_trace_bit_identical_with_reorder(scene, monkeypatch):
    """JAX's ``test_wavefront_reorder_equivalence`` on the port: the
    trace with the reorder equals it without, bit for bit, and the
    reorder ran (a permutation that moves lanes, on bounces 1-5)."""
    o, d = (torch.from_numpy(x) for x in _rays())
    keys = sampling.lane_keys(sampling.prng_key(3), torch.arange(o.shape[0]))
    calls = []
    perm_fn = integrator.passset_perm

    def spy(*a):
        calls.append(perm_fn(*a))
        return calls[-1]

    rad0, st0 = integrator.trace(scene, o, d, keys, BG, 6, reorder=False)
    assert not calls
    monkeypatch.setattr(integrator, "passset_perm", spy)
    rad1, st1 = integrator.trace(scene, o, d, keys, BG, 6)
    assert len(calls) >= 3
    assert any(not torch.equal(p, torch.arange(p.shape[0])) for p in calls)
    assert torch.equal(rad0, rad1)
    assert torch.equal(st0.segments, st1.segments) and st0.bounces == st1.bounces
    assert torch.equal(st0.occupancy, st1.occupancy)


@pytest.fixture(scope="module")
def renders(scene):
    """The chunked render of SMALL without the reorder."""
    s = RenderSettings(*SMALL, (0.6, 0.7, 0.9), spp_chunk=8)
    img, st = render_radiance(scene, make_camera(*CAM), dataclasses.replace(s, reorder=False),
                              sampling.prng_key(4), device="cpu")
    return s, img, st


@pytest.mark.parametrize("kw", [{"reorder": True}, {"reorder": None},
                                {"cascade_schedule": "1:1,2:2"},
                                {"cascade_schedule": "1:1,2:2", "reorder": False},
                                {"cascade_schedule": "2:2,3:4"}, {"cascade": True},
                                {"cascade": True, "reorder": False}])
def test_chunked_and_cascade_bit_identical_with_reorder(kw, scene, renders, monkeypatch):
    """The chunked render with the reorder, and the static (pass-set
    boundary, "1:1" a full-width regrouping) and dynamic (entry-key
    boundary) cascades with and without it, equal the chunked render
    without it bit for bit; the static boundary sorts by the pass-set
    keys unless ``reorder`` is False."""
    s, want, st = renders
    calls = []
    perm_fn = P.passset_perm

    def spy(*a):
        calls.append(1)
        return perm_fn(*a)

    from rust_pathtracer_tpu_torch import render

    monkeypatch.setattr(render, "passset_perm", spy)
    img, st2 = render_radiance(scene, make_camera(*CAM), dataclasses.replace(s, **kw),
                               sampling.prng_key(4), device="cpu")
    assert torch.equal(img, want)
    assert torch.equal(st2.segments, st.segments) and torch.equal(st2.occupancy,
                                                                  st.occupancy)
    static = "cascade_schedule" in kw
    assert bool(calls) == (static and kw.get("reorder") is not False)


@pytest.mark.parametrize("mode", ["queue", "stripe"])
@pytest.mark.parametrize("which", ["cluster", "SphereField"])
def test_regen_with_reorder(which, mode, scene, renders):
    """Regen with the reorder against without: equal segments and
    occupancy (those of the chunked render), the image within 2e-7 of a
    pixel's scale, max(1, |pixel|): a pixel's 8 samples add in another
    order, which moves a sum by ulps of its size (the cluster scene's
    lights make pixels up to ~4; SphereField's stay at most 1, so there
    the bound is 2e-7 as it stands)."""
    if which == "cluster":
        s, want, st = renders
        sc, cam, key, lanes = scene, make_camera(*CAM), sampling.prng_key(4), 1024
    else:
        sd = get_scene("SphereField")
        sc, cam, key, lanes = sd.build(), sd.camera_at(0.0), sampling.prng_key(0), 576
        s = RenderSettings(32, 18, 8, 8, (1.0, 1.0, 1.0))
        want, st = render_radiance(sc, cam, s, key, device="cpu")
        assert float(want.max()) <= 1.0
    out = {}
    for reorder in (False, True):
        out[reorder] = render_radiance_regen(sc, cam, dataclasses.replace(s, reorder=reorder),
                                             key, lanes=lanes, mode=mode, device="cpu")
    (a, sa), (b, sb) = out[False], out[True]
    scale = torch.clamp(b.abs(), min=1.0)
    assert float(((a - b).abs() / scale).max()) <= REGEN_ATOL
    for sx in (sa, sb):
        assert torch.equal(sx.segments, st.segments)
        assert torch.equal(sx.occupancy, st.occupancy)


@pytest.fixture(scope="module")
def jax_reordered():
    """JAX's reordered trace (tests/test_integrator.py:144-174's rays and
    keys) and reordered regen (tests/test_wavefront.py:91-117's frame, at
    the port's flush window of 2), on its projected route."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("RPT_PROJ_INTERPRET", "1")
        mp.setenv("RPT_BIN", "1")
        jax.clear_caches()
        js = _cluster_scene(JSceneBuilder)
        assert j_integrator.use_wavefront_reorder(js)
        o, d = _rays()
        keys = j_sampling.lane_keys(jax.random.PRNGKey(3), jnp.arange(2048,
                                                                      dtype=jnp.uint32))
        rad, st = j_integrator.trace(js, jnp.asarray(o), jnp.asarray(d), keys, BG,
                                     max_bounces=6)
        s = JRenderSettings(*SMALL, (0.6, 0.7, 0.9), spp_chunk=8)
        cam = j_make_camera(*CAM)
        img_c, st_c = j_render_radiance(js, cam, s, jax.random.PRNGKey(4))
        img_r, st_r = j_render_regen(js, cam, s, jax.random.PRNGKey(4), lanes=1024)
        out = dict(rad=np.asarray(rad), segments=float(st.segments),
                   regen=np.asarray(img_r), regen_segments=float(st_r.segments),
                   chunked=np.asarray(img_c), chunked_segments=float(st_c.segments))
    jax.clear_caches()
    return out


def test_trace_matches_jax_reordered(scene, jax_reordered):
    """The port's reordered trace against JAX's at JAX's tolerances for
    two reorder settings of one trace: lanes close at rtol / atol 1e-3
    (more than 99.5% of them), the channel means within 2e-3; segments
    within 0.1% (JAX's own runs compare compiled programs of one
    search; the port's f64 sphere roots part a few paths from JAX's f32
    ones)."""
    o, d = (torch.from_numpy(x) for x in _rays())
    keys = sampling.lane_keys(sampling.prng_key(3), torch.arange(o.shape[0]))
    rad, st = integrator.trace(scene, o, d, keys, BG, 6, reorder=True)
    r0, r1 = jax_reordered["rad"], rad.numpy()
    close = np.all(np.isclose(r0, r1, rtol=1e-3, atol=1e-3), axis=-1)
    assert close.mean() > 0.995, close.mean()
    np.testing.assert_allclose(r1.mean(axis=0), r0.mean(axis=0), rtol=2e-3)
    assert abs(float(st.segments) - jax_reordered["segments"]) <= (
        1e-3 * jax_reordered["segments"])


def test_regen_matches_jax_reordered(scene, renders, jax_reordered):
    """The port's reordered regen against JAX's reordered regen: the
    image contract (``utils/image.image_agreement``, the port-vs-JAX
    contract of every render test), the mean within JAX's 2e-3
    (tests/test_wavefront.py:91-117), and a segment gap to JAX no larger
    than the chunked renders' gap plus JAX's 0.1%: a few paths part
    between the port's f64 sphere roots and JAX's f32 ones in either
    renderer, and the reordered regen adds no parting of its own."""
    from rust_pathtracer_tpu_torch.utils.image import image_agreement

    s, cimg, cst = renders
    img, st = render_radiance_regen(scene, make_camera(*CAM),
                                    dataclasses.replace(s, reorder=True),
                                    sampling.prng_key(4), lanes=1024, device="cpu")
    a, b = jax_reordered["regen"], img.numpy()
    agree = image_agreement(b, a)
    assert agree["ok"] and not agree["has_nan"], agree
    np.testing.assert_allclose(b.mean(), a.mean(), rtol=2e-3)
    gap = float(st.segments) - jax_reordered["regen_segments"]
    chunked_gap = float(cst.segments) - jax_reordered["chunked_segments"]
    assert abs(gap - chunked_gap) <= 1e-3 * jax_reordered["regen_segments"], (
        gap, chunked_gap)


def test_sharded_bit_identical_with_reorder(tmp_path):
    """The sharded render (two gloo ranks, ``tests/torch_spawn.py``) of
    SphereField with the reorder, plain and through a static cascade
    whose "1:1" boundary regroups by pass-set, equals the same render
    without it bit for bit on every rank (image, segments, occupancy),
    on a (2, 1) and a (1, 2) grid."""
    from torch_spawn import run_ranks

    base = dict(width=16, height=8, samples_per_pixel=4, max_bounces=5,
                background=[1.0, 1.0, 1.0])
    jobs = [dict(mesh=mesh, scene="SphereField", key=5, settings=dict(base, **kw, reorder=r))
            for mesh in ([2, 1], [1, 2])
            for kw in ({}, {"cascade_schedule": "1:1,3:2"}) for r in (False, None)]
    ranks = run_ranks("render", 2, tmp_path, timeout=150, jobs=jobs)
    for rank in ranks:
        recs = rank["jobs"]
        for off, on in zip(recs[0::2], recs[1::2]):
            assert "raised" not in off and "raised" not in on
            assert torch.equal(off["img"], on["img"])
            assert off["segments"] == on["segments"]
            assert torch.equal(off["occupancy"], on["occupancy"])
    assert torch.equal(ranks[0]["jobs"][0]["img"], ranks[1]["jobs"][0]["img"])
