"""The port's big-scene search against the JAX package, on the CPU: the
BVH, the OBJ parser, the projected tables, the worklist, the plain
versions of K5, K6 and K7, the payload record and shading.

Tolerances and why:

* host-built arrays (BVH, OBJ, tables, worklist) are EQUAL: the same
  numpy code on the same inputs;
* plain K5 against JAX's Pallas kernel in interpret mode holds JAX's own
  kernel contract (tests/test_projected.py:82-100): hit masks equal,
  winners on >= 99.9% of hit lanes, payloads equal where the winners
  agree, t within rtol 1e-5.  The projections are 8-term dot products
  summed in another order than XLA's (whose CPU dot contracts into fused
  multiply-adds), so t differs in the last bits;
* the plain K5, K6 and K7 agree BIT FOR BIT with each other on a
  single-p-block table: one function with one order of operations
  (``projected._sweep_plain``), the per-lane cull and the take rules
  giving the same winners in ascending cluster order;
* sphere-heavy scenes: the expanded quadratic cancels on grazing rays,
  where either side's f32 t is off by up to ~5e-3 relative, so there t
  is held to JAX's own accuracy against f64 (``assert_jax_contract``);
* the payload hit record and shading against JAX's functions on the
  port's own payload and t: floats within rtol 1e-5 + atol 1e-6.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rust_pathtracer_tpu import bvh as jbvh
from rust_pathtracer_tpu import native as jnative
from rust_pathtracer_tpu.ops import projected as jproj
from rust_pathtracer_tpu.ops.worklist import build_pair_worklist as j_worklist
from rust_pathtracer_tpu.scene import obj_loader as jobj
from rust_pathtracer_tpu.scene.builder import SceneBuilder as JSceneBuilder
import rust_pathtracer_tpu_torch.scene.builder as t_builder
from rust_pathtracer_tpu_torch import bvh as tbvh
from rust_pathtracer_tpu_torch import native as tnative
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.ops import projected as P
from rust_pathtracer_tpu_torch.ops import resident as RS
from rust_pathtracer_tpu_torch.ops import worklist as WL
from rust_pathtracer_tpu_torch.scene import SceneBuilder
from rust_pathtracer_tpu_torch.scene import obj_loader as tobj

torch.set_num_threads(2)

T_MIN = 1e-3
PROJ_ARRAYS = ("a", "b", "const", "payload", "cluster_bounds", "cluster_bounds_v")
PROJ_STATIC = ("group_kinds", "shade_ready", "col_block")


def mixed_scene(builder, n_spheres=40, n_rects=12, n_tris=30, seed=0):
    """tests/test_projected.py::_mixed_scene on either builder."""
    rng = np.random.default_rng(seed)
    b = builder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for _ in range(n_spheres):
        b.add_sphere(rng.uniform(-8, 8, 3), rng.uniform(0.3, 1.2), m)
    for _ in range(n_rects):
        plane = ["xy", "xz", "yz"][rng.integers(3)]
        fixed = {"xy": 2, "xz": 1, "yz": 0}[plane]
        s = rng.uniform(-8, 8, 3)
        e = s + rng.uniform(0.5, 3.0, 3)
        e[fixed] = s[fixed]
        b.add_rect(plane, s, e, 1.0 if rng.random() < 0.5 else -1.0, m)
    for _ in range(n_tris):
        p0 = rng.uniform(-8, 8, 3)
        b.add_triangle(p0, p0 + rng.uniform(-2, 2, 3), p0 + rng.uniform(-2, 2, 3), m)
    return b.build(use_bvh=False)


def rays(n, seed=1, parked_every=0):
    """tests/test_projected.py::_rays as numpy; every ``parked_every``-th
    lane parked at the integrator's dead-lane origin 3e33."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    if parked_every:
        o[::parked_every] = 3.0e33
    return o, d


def prim_arrays(scene):
    return [np.asarray(x) for x in (scene.prims.kind, scene.prims.aux,
                                    scene.prims.data, scene.prims.mat)]


def assert_tables_equal(tt, jt):
    for name in PROJ_ARRAYS:
        got, want = getattr(tt, name).numpy(), np.asarray(getattr(jt, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    for name in PROJ_STATIC:
        assert getattr(tt, name) == getattr(jt, name), name


def sweep_t(tables, o, d):
    """K5 (its plain version) on numpy rays."""
    return P.projected_sweep(tables, torch.from_numpy(o), torch.from_numpy(d), T_MIN)


def exact_t(pay, o, d):
    """f64 hit distance of each lane's winning primitive (payload rows
    0-15): the sphere quadratic, the rect plane, the triangle plane."""
    data = pay[:, :12].astype(np.float64)
    kind = np.rint(pay[:, P.PAY_KIND]).astype(int)
    aux = np.rint(pay[:, P.PAY_AUX]).astype(int)
    o64, d64 = o.astype(np.float64), d.astype(np.float64)
    oc = o64 - data[:, :3]
    a = (d64 * d64).sum(1)
    hb = (oc * d64).sum(1)
    dis = hb * hb - a * ((oc * oc).sum(1) - data[:, 3] ** 2)
    sq = np.sqrt(np.maximum(dis, 0.0))
    r1 = (-hb - sq) / a
    t_sphere = np.where(r1 >= T_MIN, r1, (-hb + sq) / a)
    lanes = np.arange(len(kind))
    n = np.cross(data[:, 3:6], data[:, 6:9])
    with np.errstate(divide="ignore", invalid="ignore"):  # other kinds' rows
        t_rect = (data[:, 0] - o64[lanes, aux]) / d64[lanes, aux]
        t_tri = ((data[:, 0:3] - o64) * n).sum(1) / (d64 * n).sum(1)
    return np.select([kind == 0, kind == 1], [t_sphere, t_rect], t_tri)


def assert_jax_contract(port, jax_out, o=None, d=None):
    """JAX's kernel contract (test_projected.py:82-100) between the
    port's (t, column, payload) and JAX's (hit, t, payload): hit masks
    equal, winners on >= 99.9% of hits, payloads equal where they agree
    and t within rtol 1e-5.  Given the rays ``o``, ``d``, t is held
    instead to JAX's own accuracy: against the f64 t of the same
    primitive, the port's mean relative error at most 1.5 times JAX's
    (plus 1e-7) and its largest at most twice JAX's (plus 1e-6).  That is for sphere-heavy scenes, where
    the expanded quadratic (|o|^2 - 2 o.c + |c|^2 - r^2) cancels on
    grazing rays and either side's f32 t is off by up to ~5e-3 relative
    (measured on SphereField)."""
    t, col, pay = (x.numpy() for x in port)
    jh, jt, jp = (np.asarray(x) for x in jax_out)
    hit = col >= 0
    np.testing.assert_array_equal(hit, jh)
    same = hit & (pay[:, P.PAY_IDX] == jp[:, P.PAY_IDX])
    assert same[hit].mean() >= 0.999
    np.testing.assert_array_equal(pay[same], jp[same])
    assert (t[~hit] == P.T_MISS).all() and (pay[~hit] == 0).all()
    if o is None:
        np.testing.assert_allclose(t[same], jt[same], rtol=1e-5, atol=1e-5)
        return
    t64 = exact_t(pay[same], o[same], d[same])
    err_port = np.abs(t[same] - t64) / np.abs(t64)
    err_jax = np.abs(jt[same] - t64) / np.abs(t64)
    assert err_port.mean() <= 1.5 * err_jax.mean() + 1e-7
    assert err_port.max() <= 2.0 * err_jax.max() + 1e-6


def assert_bitwise(a, b):
    for x, y in zip(a, b):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# BVH and OBJ
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,leaf_size", [(1, 4), (9, 2), (300, 4), (1000, 8)])
def test_bvh_matches_jax_numpy(n, leaf_size):
    rng = np.random.default_rng(n)
    lo = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    hi = lo + rng.uniform(0.0, 2.0, (n, 3)).astype(np.float32)
    got = tbvh.build_bvh_numpy(lo, hi, leaf_size)
    want = jbvh.build_bvh_numpy(lo, hi, leaf_size)
    for name in tbvh.FlatBvh._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    assert sorted(got.prim_order.tolist()) == list(range(n))


def _scene_boxes(name, tmp_path):
    """The primitive AABBs and leaf size the port's builder hands
    ``build_bvh`` for a scene (ModelTest on write_benchmark_obj's asset)."""
    kw = {}
    if name == "ModelTest":
        kw["obj_path"] = str(tmp_path / "model.obj")
        tobj.write_benchmark_obj(kw["obj_path"])
    calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(t_builder, "build_bvh",
                   lambda lo, hi, leaf_size=4: calls.append((lo, hi, leaf_size))
                   or tbvh.build_bvh_numpy(lo, hi, leaf_size))
        get_scene(name, **kw).build()
    assert len(calls) == 1
    return calls[0]


@pytest.mark.parametrize("case", ["SphereField", "ModelTest", "random"])
def test_native_bvh_matches_jax_native(case, tmp_path):
    """The port's default builder (``bvh.build_bvh``: the native C++
    copy) against JAX's ``native.build_bvh`` on SphereField's and
    ModelTest's boxes and on a random set: every array equal, so the
    default primitive order is JAX's.  It differs from the numpy order
    (std::nth_element leaves each half in another order than
    np.argpartition), which is why the parity tests pin both builders."""
    if case == "random":
        rng = np.random.default_rng(17)
        lo = rng.uniform(-10, 10, (2000, 3)).astype(np.float32)
        hi = lo + rng.uniform(0.0, 1.0, (2000, 3)).astype(np.float32)
        leaf = 4
    else:
        lo, hi, leaf = _scene_boxes(case, tmp_path)
    assert tnative.available() == jnative.available()
    got = tbvh.build_bvh(lo, hi, leaf)
    want = jnative.build_bvh(lo, hi, leaf)
    for name in tbvh.FlatBvh._fields:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name),
                                      err_msg=name)
    if tnative.available():
        numpy_order = tbvh.build_bvh_numpy(lo, hi, leaf).prim_order
        assert (got.prim_order != numpy_order).sum() > lo.shape[0] // 4


@pytest.mark.parametrize("asset", ["test", "benchmark", "quirks", "no_mtl"])
def test_obj_matches_jax_native(asset, tmp_path):
    """The port's OBJ parse (its Python parser, the only one) against
    JAX's default parse (its native C++ parser where g++ builds it):
    every array and material equal, so the port needs no copy of the
    native parser to load a mesh in JAX's default order."""
    path = tmp_path / "m.obj"
    if asset == "test":
        tobj.write_test_obj(str(path))
    elif asset == "benchmark":
        tobj.write_benchmark_obj(str(path), rows=9, cols=10)
    elif asset == "quirks":
        _quirk_obj(path)
    else:
        tobj.write_test_obj(str(path), with_mtl=False)
    got = tobj.parse_obj_arrays(str(path))
    want = jobj.parse_obj_arrays(str(path))
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4]
    with pytest.raises(OSError):
        tobj.parse_obj_arrays(str(tmp_path / "missing.obj"))


def _quirk_obj(path):
    """An OBJ with the reference's quirks: vn lines indexed by POSITION,
    faces without a material, a metal with Ns 0, a quad, a bad index."""
    mtl = path.with_suffix(".mtl")
    mtl.write_text("newmtl zero\nKd 0.5 0.4 0.3\nNs 0\nillum 5\n")
    path.write_text(
        f"mtllib {mtl.name}\n"
        "v 0 0 0\nv 1 0 0\nv 0 1 0\nv 1 1 0\nv 0 0 1\n"
        "vn 0 0 1\nvn 0 1 0\n"
        "f 1 2 3\n"               # no material; vn of position 0
        "usemtl zero\n"
        "f 2//1 4//1 3//1\n"      # vn of position 1, not the //1 annotation
        "f 3 4 5 1\n"             # a quad, fan-triangulated; position 2: no vn
        "f 1 2 99\n"              # out of range: dropped
    )


@pytest.mark.parametrize("asset", ["test", "benchmark", "quirks", "no_mtl"])
def test_obj_matches_jax_python_parser(asset, tmp_path):
    path = tmp_path / "m.obj"
    if asset == "test":
        tobj.write_test_obj(str(path))
    elif asset == "benchmark":
        n = tobj.write_benchmark_obj(str(path), rows=9, cols=10)
        (tmp_path / "j").mkdir()
        assert n == jobj.write_benchmark_obj(str(tmp_path / "j" / "m.obj"), rows=9, cols=10)
        assert path.read_text() == (tmp_path / "j" / "m.obj").read_text()
        assert (tmp_path / "m.mtl").read_text() == (tmp_path / "j" / "m.mtl").read_text()
    elif asset == "quirks":
        _quirk_obj(path)
    else:
        tobj.write_test_obj(str(path), with_mtl=False)
    got = tobj.parse_obj_arrays(str(path))
    want = jobj.parse_obj_arrays(str(path), prefer_native=False)
    for a, b in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(a, b)
    assert got[4] == want[4]

    # loaded into the two builders: the same tables (BVH off)
    tb, jb = SceneBuilder(), JSceneBuilder()
    tobj.load_obj_into(tb, str(path))
    jobj.load_obj_into(jb, str(path))
    ts, js = tb.build(use_bvh=False), jb.build(use_bvh=False)
    for group in ("prims", "materials"):
        for name, val in getattr(js, group)._asdict().items():
            np.testing.assert_array_equal(getattr(getattr(ts, group), name).numpy(),
                                          np.asarray(val), err_msg=f"{group}.{name}")
    if asset == "quirks":
        assert np.isinf(ts.materials.fuzz.numpy()).any()  # Ns 0
        assert ts.materials.kind.shape[0] == 2  # the default, needed here


# ---------------------------------------------------------------------------
# projected tables and the worklist
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["mixed", "mixed_shaded", "streamed", "padded_stream"])
def test_build_projected_matches_jax(case):
    if case == "padded_stream":  # test_projected.py::test_padding_groups_*
        rng = np.random.default_rng(7)
        b = JSceneBuilder()
        m = b.lambertian((0.5, 0.5, 0.5))
        for p in rng.uniform(-10, 10, (700, 3)):
            b.add_sphere(tuple(p), 0.08, m)
        scene, kw = b.build(use_bvh=False), dict(max_single_cols=256)
    else:
        scene = mixed_scene(JSceneBuilder, *((1700, 30, 600) if case == "streamed"
                                             else (60, 20, 50)), seed=5)
        kw = dict(max_single_cols=P.COL_BLOCK) if case == "streamed" else {}
    args = prim_arrays(scene)
    if case == "mixed_shaded":
        tex = scene.textures
        kw = dict(mats=[np.asarray(x) for x in scene.materials],
                  texs=[np.asarray(x) for x in (tex.kind, tex.color, tex.child,
                                                tex.scale, tex.image_id)])
    tt, jt = P.build_projected(*args, **kw), jproj.build_projected(*args, **kw)
    assert_tables_equal(tt, jt)
    if case == "streamed":
        assert tt.col_block < tt.num_cols
    if case in ("streamed", "padded_stream"):
        assert -1 in tt.group_kinds


@pytest.mark.parametrize("rb,kcap", [(256, 12), (128, 3), (512, 64)])
def test_pair_worklist_matches_jax(rb, kcap):
    scene = mixed_scene(JSceneBuilder, 200, 20, 150, seed=8)
    tables = jproj.build_projected(*prim_arrays(scene))
    o, d = rays(2048, seed=9, parked_every=5)
    jm, _, _, jov = j_worklist(tables.cluster_bounds, tables.group_kinds,
                               jnp.asarray(o), jnp.asarray(d), T_MIN, rb, kcap)
    tm, tov = WL.build_pair_worklist(torch.from_numpy(np.array(tables.cluster_bounds)),
                                     tables.group_kinds, torch.from_numpy(o),
                                     torch.from_numpy(d), T_MIN, rb, kcap)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    assert bool(tov) == bool(jov)


# ---------------------------------------------------------------------------
# the plain kernels
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("case", ["mixed", "spheres_parked"])
def test_plain_k5_matches_jax_kernel(case):
    """test_projected.py::test_pallas_projected_matches_ref_interpret's
    scene and rays, and a sphere-only scene (the q domain) with parked
    lanes, against JAX's K5 in the Pallas interpreter."""
    if case == "mixed":
        jscene = mixed_scene(JSceneBuilder, 60, 20, 50, seed=7)
        o, d = rays(777, seed=11)
    else:
        jscene = mixed_scene(JSceneBuilder, 300, 0, 0, seed=3)
        o, d = rays(600, seed=5, parked_every=7)
    args = prim_arrays(jscene)
    tt, jt = P.build_projected(*args), jproj.build_projected(*args)
    jout = jproj.closest_hit_projected(jt, jnp.asarray(o), jnp.asarray(d), T_MIN,
                                       interpret=True)
    assert_jax_contract(sweep_t(tt, o, d), jout,
                        *(() if case == "mixed" else (o, d)))


def test_plain_k5_streamed_matches_jax_kernel():
    """A streamed table (several p-blocks, padding groups in the last)
    against JAX's K5 in the interpreter, under the same contract; and the
    port's K5 on it against K7 (always the q domain): same hits and
    winners, t equal but for the last bits of sphere hits in slots that
    mix sphere and other groups (none differ on a sphere-only slot)."""
    jscene = mixed_scene(JSceneBuilder, 1700, 30, 600, seed=5)
    args = prim_arrays(jscene)
    kw = dict(max_single_cols=P.COL_BLOCK)
    tt, jt = P.build_projected(*args, **kw), jproj.build_projected(*args, **kw)
    spheres = [g for g, k in enumerate(tt.group_kinds) if k == 0]
    assert tt.num_cols // tt.col_block == 2
    assert not all(tt.dense_q[g] for g in spheres) and any(tt.dense_q[g] for g in spheres)
    o, d = rays(300, seed=13, parked_every=9)
    k5 = sweep_t(tt, o, d)
    jout = jproj.closest_hit_projected(jt, jnp.asarray(o), jnp.asarray(d), T_MIN,
                                       interpret=True)
    assert_jax_contract(k5, jout, o, d)
    meta, ov = WL.build_pair_worklist(tt.cluster_bounds, tt.group_kinds,
                                      torch.from_numpy(o), torch.from_numpy(d), T_MIN,
                                      300, tt.num_groups)
    k7 = WL.pair_sweep(tt, torch.from_numpy(o), torch.from_numpy(d), T_MIN, meta, 300)
    assert not bool(ov)
    assert torch.equal(k5[1], k7[1]) and torch.equal(k5[2], k7[2])
    hit = k5[1] >= 0
    np.testing.assert_allclose(k7[0][hit].numpy(), k5[0][hit].numpy(), rtol=1e-6)
    q_hit = hit & torch.tensor([tt.dense_q[c // P.GROUP] for c in
                                k5[1].clamp(min=0).tolist()])
    assert torch.equal(k5[0][q_hit], k7[0][q_hit])


def _k6_k7(tables, o, d, rb, kcap=None):
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    G = tables.num_groups
    meta, _ = WL.build_pair_worklist(tables.cluster_bounds, tables.group_kinds,
                                     to, td, T_MIN, rb, G)
    packed, counts = RS.pack_slots(meta, o.shape[0] // rb)
    k6 = RS.resident_sweep(tables, to, td, T_MIN, packed, counts, rb)
    meta7, ov = WL.build_pair_worklist(tables.cluster_bounds, tables.group_kinds,
                                       to, td, T_MIN, rb, kcap or WL.WL_KCAP)
    k7 = None if bool(ov) else WL.pair_sweep(tables, to, td, T_MIN, meta7, rb)
    return k6, k7


@pytest.mark.parametrize("case", ["mixed", "sphere_only", "triangles", "parked"])
def test_plain_k6_k7_equal_k5(case):
    """On single-p-block tables the plain K6 and K7 equal the plain K5
    bit for bit (test_resident.py, test_worklist.py), at two block
    sizes; parked lanes (origin 3e33 or 1e8) come back as misses."""
    n_s, n_r, n_t = {"mixed": (300, 40, 260), "sphere_only": (500, 0, 0),
                     "triangles": (0, 0, 400), "parked": (120, 10, 80)}[case]
    tables = P.build_projected(*prim_arrays(mixed_scene(SceneBuilder, n_s, n_r, n_t,
                                                        seed=7)))
    assert tables.col_block == tables.num_cols
    o, d = rays(2048, seed=11, parked_every=7 if case == "parked" else 0)
    if case == "parked":
        o[:512] = 1e8
        d[:512] = (0.0, 1.0, 0.0)
    k5 = sweep_t(tables, o, d)
    for rb in (32, 256):
        k6, k7 = _k6_k7(tables, o, d, rb, kcap=tables.num_groups)
        assert_bitwise(k6, k5)
        assert_bitwise(k7, k5)
    if case == "parked":
        assert (k5[1][:512] == -1).all() and (k5[1][::7] == -1).all()
        assert (k5[1] >= 0).any()


def test_pairs_overflow_falls_back_to_k5():
    """kcap = 1: a block passing two clusters overflows the worklist and
    closest_hit_pairs returns K5's result; a wide kcap runs K7; both
    equal K5 (test_worklist.py::test_worklist_overflow_falls_back_dense)."""
    tables = P.build_projected(*prim_arrays(mixed_scene(SceneBuilder, 300, 40, 260,
                                                        seed=7)))
    o, d = rays(1500, seed=13)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    k5 = sweep_t(tables, o, d)
    _, ov = WL.build_pair_worklist(tables.cluster_bounds, tables.group_kinds,
                                   to[:1472], td[:1472], T_MIN, 32, 1)
    assert bool(ov)
    for kcap in (1, tables.num_groups):
        assert_bitwise(WL.closest_hit_pairs(tables, to, td, T_MIN, kcap=kcap), k5)
    assert_bitwise(RS.closest_hit_resident(tables, to, td, T_MIN), k5)
    hit, t, pay = P.closest_hit_projected(tables, to, td, T_MIN)
    assert torch.equal(hit, k5[1] >= 0) and torch.equal(t, k5[0])


def test_wrappers_raise_on_bad_inputs():
    tables = P.build_projected(*prim_arrays(mixed_scene(SceneBuilder, 30, 5, 20)))
    o, d = (torch.from_numpy(x) for x in rays(64))
    with pytest.raises(TypeError, match="float32"):
        P.projected_sweep(tables, o.double(), d.double(), T_MIN)
    with pytest.raises(ValueError, match=r"\(R, 3\)"):
        P.projected_sweep(tables, o[:, :2], d[:, :2], T_MIN)
    with pytest.raises(ValueError, match="inconsistent"):
        P.projected_sweep(P.ProjTables(**{**{n: getattr(tables, n) for n in PROJ_ARRAYS},
                                          "const": tables.const[:, :-1]},
                                       group_kinds=tables.group_kinds),
                          o, d, T_MIN)
    with pytest.raises(ValueError, match="slot table"):
        WL.pair_sweep(tables, o, d, T_MIN, torch.zeros((2, 3), dtype=torch.int32), 32)
    with pytest.raises(ValueError, match="counts"):
        RS.resident_sweep(tables, o, d, T_MIN, torch.zeros(8, dtype=torch.int32),
                          torch.zeros(3, dtype=torch.int32), 32)
    with pytest.raises(ValueError, match="route"):
        P.closest_hit_routed(tables, o, d, T_MIN, route="bvh")
    with pytest.raises(ValueError, match="multiple"):
        WL.build_pair_worklist(tables.cluster_bounds, tables.group_kinds, o[:60],
                               d[:60], T_MIN, 32, 12)


# ---------------------------------------------------------------------------
# the payload record and shading
# ---------------------------------------------------------------------------


def _shaded_scenes():
    """test_projected.py::test_payload_shading_matches_table_shading's
    scene on both builders: checker, perlin, metal, glass, a light."""
    out = []
    for builder in (JSceneBuilder, SceneBuilder):
        rng = np.random.default_rng(33)
        b = builder()
        ck = b.checker_texture(b.solid_texture((0.1, 0.2, 0.3)),
                               b.solid_texture((0.9, 0.8, 0.7)))
        pn = b.perlin_texture(3.0)
        mats = [b.lambertian(ck), b.lambertian(pn), b.metal((0.8, 0.7, 0.6), 0.3),
                b.dielectric(1.5), b.diffuse_light((4.0, 5.0, 6.0))]
        for _ in range(200):
            b.add_sphere(rng.uniform(-8, 8, 3), rng.uniform(0.3, 1.0),
                         mats[rng.integers(len(mats))])
        out.append(b.build(use_bvh=False))
    return out


@pytest.mark.parametrize("route", ["dense", "resident", "pairs"])
def test_record_and_payload_shading_match_jax(route):
    """closest_hit_record_projected and the payload shading, every route,
    against JAX's (K5 in interpret mode): the search under the contract
    of ``assert_jax_contract`` (a sphere scene: t held to JAX's
    accuracy), the shading rows equal where the winners agree; the
    record and ShadeInputs against JAX's ``record_from_rows`` and
    ``shade_inputs`` on the port's own payload and t (masks and integers
    equal, floats within rtol 1e-5 + atol 1e-6: sqrt, acos, atan2, sin
    and the perlin marble differ by ulps); the payload shading against
    the port's table shading, equal."""
    from rust_pathtracer_tpu.materials import shade_inputs as j_shade_inputs
    from rust_pathtracer_tpu.ops.intersect import record_from_rows as j_record
    from rust_pathtracer_tpu_torch.materials import shade_inputs

    jscene, tscene = _shaded_scenes()
    assert tscene.proj.shade_ready and tscene.kinds_static is None
    o, d = rays(512, seed=41, parked_every=11)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    jh, jt, jidx, jrec, jrow, _ = jproj.closest_hit_record_projected(
        jscene, jnp.asarray(o), jnp.asarray(d), T_MIN, interpret=True)
    th, tt, tidx, trec, trow = P.closest_hit_record_projected(
        tscene, to, td, T_MIN, route=route)
    t, col, pay = P.closest_hit_routed(tscene.proj, to, td, T_MIN, route)
    assert torch.equal(torch.where(th, t, torch.ones_like(t)), tt)
    jout = jproj.closest_hit_projected(jscene.proj, jnp.asarray(o), jnp.asarray(d),
                                       T_MIN, interpret=True)
    assert_jax_contract((t, col, pay), jout, o, d)
    np.testing.assert_array_equal(th.numpy(), np.asarray(jh))
    same = th.numpy() & (tidx.numpy() == np.asarray(jidx))
    np.testing.assert_array_equal(trow.numpy()[same], np.asarray(jrow)[same])

    p = pay.numpy()
    want = j_record(*(jnp.asarray(np.rint(p[:, k]).astype(np.int32)) for k in (12, 13)),
                    jnp.asarray(p[:, :12]), jnp.asarray(np.rint(p[:, 14]).astype(np.int32)),
                    jnp.asarray(tidx.numpy()), jnp.asarray(o), jnp.asarray(d),
                    jnp.asarray(tt.numpy()), jnp.asarray(th.numpy()),
                    prim_types=jscene.prim_types)
    for name in ("valid", "front_face", "mat", "prim"):
        np.testing.assert_array_equal(getattr(trec, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)
    hm = th.numpy()
    for name in ("t", "point", "normal", "u", "v"):
        np.testing.assert_allclose(getattr(trec, name).numpy()[hm],
                                   np.asarray(getattr(want, name))[hm],
                                   rtol=1e-5, atol=1e-6, err_msg=name)

    si = shade_inputs(tscene, trec, trow)
    jsi = j_shade_inputs(jscene, want, jnp.asarray(trow.numpy()))
    tab = shade_inputs(tscene, trec)
    for name in ("kind", "fuzz", "ir"):
        np.testing.assert_array_equal(getattr(si, name).numpy()[hm],
                                      np.asarray(getattr(jsi, name))[hm])
        np.testing.assert_array_equal(getattr(si, name).numpy()[hm],
                                      getattr(tab, name).numpy()[hm])
    np.testing.assert_allclose(si.value.numpy()[hm], np.asarray(jsi.value)[hm],
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(si.value.numpy()[hm], tab.value.numpy()[hm])
