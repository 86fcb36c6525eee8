"""The compact rows of the projected tables, the sparse plain sweep and the
warp's visit of K5 and K7, on the CPU, without JAX.

Tolerances and why: everything here is EQUAL, bit for bit.

* ``ProjTables.rows`` and ``bounds8`` are copies of the f32 values of
  ``a``, ``b``, ``const`` and ``cluster_bounds``, so the dense tables
  rebuilt from them are the same bits;
* the sparse projections (``projected._projections``) add +0 to the sum
  of the nonzero terms, which is the dense 8-term sum on finite rays, so
  the sweep's t, column and payload are the dense sweep's (the dense
  twin below is the sweep's projections before the compact rows);
* the warp-cooperative visit's (value, column) minimum is the sequential
  strict-< scan's result whenever no value is NaN, ties included;
* ``ops/csrc/projected.cu`` built with g++ against an emulation of the
  warp (``tests/cuda_emu.h``) equals the plain versions, as it stands and
  with its switch to the cooperative sweep moved so that every visit
  takes one sweep.
"""

import ctypes
import re
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.ops import projected as P
from rust_pathtracer_tpu_torch.ops import resident as RS
from rust_pathtracer_tpu_torch.ops import worklist as WL
from rust_pathtracer_tpu_torch.ops._build import CSRC, SIGNATURES
from rust_pathtracer_tpu_torch.scene import SceneBuilder
from rust_pathtracer_tpu_torch.scene.obj_loader import write_benchmark_obj

torch.set_num_threads(2)

T_MIN = 1e-3
PARKED = 3.0e33
ROW_QUADS = {0: 1, 1: 3, 2: 4}  # the quads of a row each type fills


def mixed_scene(n_spheres, n_rects, n_tris, seed, radius=(0.3, 1.2)):
    """tests/test_projected.py::_mixed_scene on the port's builder."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for _ in range(n_spheres):
        b.add_sphere(rng.uniform(-8, 8, 3), rng.uniform(*radius), m)
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


def _tables_of(scene, **kw):
    pr = scene.prims
    args = [x.numpy() for x in (pr.kind, pr.aux, pr.data, pr.mat)]
    return P.build_projected(*args, **kw)


def _model_tables(tmp_path, **kw):
    path = tmp_path / "model.obj"
    write_benchmark_obj(str(path), **kw)
    return get_scene("ModelTest", obj_path=str(path)).build().proj


# the scene boxes of chip_smoke.py's random lanes; the test scenes' own
BOXES = {"SphereField": ((-11.0, 0.05, -11.0), (11.0, 3.0, 11.0)),
         "ModelTest": ((-3.0, 0.05, -3.0), (3.0, 3.5, 3.0)),
         "mixed": ((-10.0, -10.0, -10.0), (10.0, 10.0, 10.0))}


def make_case(case, tmp_path):
    """(tables, scene definition or None, box) of a case: the test tables
    of test_torch_projected.py's table tests, and the three big scenes'
    own."""
    box = BOXES["mixed"]
    if case == "mixed":
        return _tables_of(mixed_scene(60, 20, 50, seed=5)), None, box
    if case == "mixed_shaded":
        scene = mixed_scene(60, 20, 50, seed=5)
        tex, pr = scene.textures, scene.prims
        return P.build_projected(
            *[x.numpy() for x in (pr.kind, pr.aux, pr.data, pr.mat)],
            mats=[getattr(scene.materials, f).numpy() for f in ("kind", "tex", "fuzz", "ir")],
            texs=[x.numpy() for x in (tex.kind, tex.color, tex.child, tex.scale,
                                      tex.image_id)]), None, box
    if case == "streamed":
        return (_tables_of(mixed_scene(1700, 30, 600, seed=5), max_single_cols=P.COL_BLOCK),
                None, box)
    if case == "padded_stream":
        return (_tables_of(mixed_scene(700, 0, 0, seed=7, radius=(0.08, 0.08)),
                           max_single_cols=256), None, box)
    if case == "SphereField":
        sd = get_scene("SphereField")
        return sd.build().proj, sd, BOXES["SphereField"]
    if case in ("ModelTest", "ModelTest 20k"):
        path = tmp_path / "model.obj"
        write_benchmark_obj(str(path), **({} if case == "ModelTest" else
                                          dict(rows=101, cols=100)))
        sd = get_scene("ModelTest", obj_path=str(path))
        return sd.build().proj, sd, BOXES["ModelTest"]
    raise ValueError(case)


def dense_from_rows(tables):
    """(a, b, const) rebuilt from ``tables.rows`` by the layout its
    docstring gives, zeros elsewhere; the padding clusters, which no
    kernel visits and the rows leave at zero, get K0 = 1e30."""
    G, C = tables.num_groups, tables.num_cols
    rows = tables.rows.permute(0, 2, 1, 3).reshape(C, 16)
    kind = np.repeat(np.asarray(tables.group_kinds), P.GROUP)
    a = torch.zeros((3, 8, C))
    b = torch.zeros((3, 8, C))
    k = torch.zeros((8, C))
    for c in range(C):
        r = rows[c]
        if kind[c] == 0:
            a[0, 0:3, c] = r[0:3]
            b[0, 3:6, c] = r[0:3]
            k[0, c] = r[3]
        elif kind[c] == 2:
            for j in range(3):
                a[j, 0:3, c] = r[4 * j:4 * j + 3]
                a[j, 6, c] = r[4 * j + 3]
                b[j, 3:6, c] = r[4 * j:4 * j + 3]
            k[0, c] = r[12]
        elif kind[c] == 1:
            f = int(r[0])
            fa, fb = P._RECT_FREE[f]
            a[0, f, c], a[0, 6, c] = r[6], r[1]
            a[1, fa, c], a[2, fb, c] = r[7], r[8]
            b[0, 3 + f, c], b[1, 3 + fa, c], b[2, 3 + fb, c] = r[9], r[10], r[11]
            k[0:4, c] = torch.stack([r[2], r[3], r[4], r[5]])
        else:
            k[0, c] = 1.0e30
    return a, b, k


@pytest.mark.parametrize("case", ["mixed", "mixed_shaded", "streamed", "padded_stream",
                                  "SphereField", "ModelTest", "ModelTest 20k"])
def test_rows_hold_the_tables_nonzero_coefficients(case, tmp_path):
    """The compact rows give back ``a``, ``b`` and ``const`` bit for bit
    (every nonzero coefficient, by type; zeros where the type has none),
    they hold nothing past a type's quads, and ``bounds8`` holds the
    cluster AABBs."""
    tables = make_case(case, tmp_path)[0]
    rows = tables.rows
    assert rows.shape == (tables.num_groups, 4, P.GROUP, 4)
    assert rows.dtype == torch.float32 and rows.is_contiguous()
    a, b, k = dense_from_rows(tables)
    for name, got, want in (("a", a, tables.a), ("b", b, tables.b), ("const", k, tables.const)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), name
    for g, kind in enumerate(tables.group_kinds):
        nq = ROW_QUADS.get(kind, 0)
        assert not rows[g, nq:].any(), (g, kind)
        if kind == 2:  # quad 3: K0 alone
            assert not rows[g, 3, :, 1:].any()
    cb = tables.bounds8
    assert cb.shape == (tables.num_groups, 8)
    assert torch.equal(cb[:, 0:3].T, tables.cluster_bounds[0:3])
    assert torch.equal(cb[:, 4:7].T, tables.cluster_bounds[3:6])
    assert not cb[:, 3].any() and not cb[:, 7].any()


# ---------------------------------------------------------------------------
# the sparse plain sweep against the dense one
# ---------------------------------------------------------------------------


def dense_projections(tables, kind, g, o, d):
    """The sweep's projections before the compact rows: the 8-term sums
    ``rays . a[j]`` and ``rays . b[j]`` over every coefficient, k = 0..7
    in order, and the constants read from ``const``."""
    sl = slice(g * P.GROUP, (g + 1) * P.GROUP)
    n = o.shape[0]
    rays = torch.cat([o, d, torch.ones((n, 1)), torch.zeros((n, 1))], dim=1)
    nrows = 1 if kind == 0 else 3

    def proj(m):
        acc = rays[:, 0, None, None] * m[None, :nrows, 0, sl]
        for kk in range(1, 8):
            acc = acc + rays[:, kk, None, None] * m[None, :nrows, kk, sl]
        return list(acc.unbind(1))

    K = tables.const[:, sl]
    return proj(tables.a), proj(tables.b), tuple(K[:4] if kind == 1 else K[:1])


def lane_set(name, box, n, seed, sd=None):
    """(o, d) f32 lanes: "camera" (the scene definition's camera at t = 0,
    one ray a pixel of a 32-wide frame; without one, a pinhole on the box
    from 2.5 box radii), "random" (origins in the box, normal
    directions), "parked" (half of random's origins at 3e33) and
    "signed_zeros" (origins on an integer grid with signed zeros,
    directions along the axes or diagonals, each zero of either sign)."""
    rng = np.random.default_rng(seed)
    lo, hi = np.asarray(box[0]), np.asarray(box[1])
    if name == "camera" and sd is not None:
        from rust_pathtracer_tpu_torch.render import _make_lanes
        from rust_pathtracer_tpu_torch.sampling import prng_key

        W = 32
        H = n // W
        _, o, d, _ = _make_lanes(sd.camera_at(0.0), prng_key(seed),
                                 torch.arange(W * H), 0, width=W, height=H, spp_chunk=1,
                                 spp_total=1)
        return o.contiguous(), d.contiguous()
    if name == "camera":
        centre, radius = (lo + hi) / 2, np.linalg.norm(hi - lo) / 2
        eye = centre + np.array([0.3, 0.4, 1.0]) * 2.5 * radius / np.sqrt(1.25)
        k = int(np.sqrt(n))
        u, v = np.meshgrid(np.linspace(-0.2, 0.2, k), np.linspace(-0.2, 0.2, k))
        fwd = (centre - eye) / np.linalg.norm(centre - eye)
        right = np.cross(fwd, [0.0, 1.0, 0.0])
        right /= np.linalg.norm(right)
        up = np.cross(right, fwd)
        d = fwd + u.reshape(-1, 1) * right + v.reshape(-1, 1) * up
        o = np.broadcast_to(eye, d.shape)
    elif name in ("random", "parked"):
        o = rng.uniform(lo, hi, (n, 3))
        d = rng.normal(size=(n, 3))
        if name == "parked":
            o[::2] = PARKED
    elif name == "signed_zeros":
        o = np.round(rng.uniform(lo, hi, (n, 3)))
        axes = np.eye(3)[rng.integers(0, 3, n)] * rng.choice([-1.0, 1.0], (n, 1))
        diag = np.where(rng.random((n, 3)) < 0.5, 0.0, rng.choice([-1.0, 1.0], (n, 3)))
        d = np.where(rng.random((n, 1)) < 0.5, axes, diag)
        d[(d == 0).all(axis=1)] = (0.0, -1.0, 0.0)
        o[::5, 0] = 0.0
        o = np.where((o == 0) & (rng.random((n, 3)) < 0.5), -0.0, o)
        d = np.where((d == 0) & (rng.random((n, 3)) < 0.5), -0.0, d)
    else:
        raise ValueError(name)
    return (torch.from_numpy(np.ascontiguousarray(o, np.float32)),
            torch.from_numpy(np.ascontiguousarray(d, np.float32)))


def _bits_equal(a, b):
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        if x.dtype == torch.float32:
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
        else:
            assert torch.equal(x, y)


@pytest.mark.parametrize("lanes", ["camera", "random", "parked", "signed_zeros"])
@pytest.mark.parametrize("case", ["mixed", "streamed", "SphereField", "ModelTest"])
def test_sparse_sweep_equals_dense_sweep(case, lanes, tmp_path, monkeypatch):
    """The plain sweep on the compact rows gives t, column and payload bit
    for bit as on the dense tables, for K5 (every cluster, K5's q rule)
    and K7's rule (the slots of blocks of 32, spheres always in q)."""
    tables, sd, box = make_case(case, tmp_path)
    o, d = lane_set(lanes, box, 1024, seed=len(case) * 7 + len(lanes), sd=sd)
    rb = WL.WL_RB
    meta, _ = WL.build_pair_worklist(tables.cluster_bounds, tables.group_kinds, o, d,
                                     T_MIN, rb, tables.num_groups)
    sparse = (P.projected_sweep_plain(tables, o, d, T_MIN),
              WL.pair_sweep_plain(tables, o, d, T_MIN, meta, rb))
    monkeypatch.setattr(P, "_projections", dense_projections)
    dense = (P.projected_sweep_plain(tables, o, d, T_MIN),
             WL.pair_sweep_plain(tables, o, d, T_MIN, meta, rb))
    for s, dn in zip(sparse, dense):
        _bits_equal(s, dn)
    if lanes != "parked":
        assert (sparse[0][1] >= 0).any()


def test_sparse_projections_equal_dense_projections():
    """Column by column, every projection of the sparse form is the dense
    one's bits (+0 where the dense sum ends in a zero), on lanes with
    signed zeros and parked origins, for every cluster of a mixed table."""
    tables = _tables_of(mixed_scene(60, 20, 50, seed=5))
    o, d = lane_set("signed_zeros", BOXES["mixed"], 512, seed=3)
    o[::7] = PARKED
    zeros = 0
    for g, kind in enumerate(tables.group_kinds):
        if kind < 0:
            continue
        so, sd, sk = P._projections(tables, kind, g, o, d)
        do, dd, dk = dense_projections(tables, kind, g, o, d)
        for x, y in zip(so + sd + list(sk), do + dd + list(dk)):
            assert torch.equal(x.view(torch.int32), y.view(torch.int32))
            zeros += int((x == 0).sum())
    assert zeros > 0


# ---------------------------------------------------------------------------
# the warp-cooperative visit
# ---------------------------------------------------------------------------


def sequential_take(vals):
    """The per-lane sweep's group minimum: columns in order, a strict <
    against the running best from (T_MISS, 0).  vals (n, 128) f32."""
    best = np.full(vals.shape[0], P.T_MISS, np.float32)
    col = np.zeros(vals.shape[0], np.int64)
    for j in range(vals.shape[1]):
        take = vals[:, j] < best
        best = np.where(take, vals[:, j], best)
        col = np.where(take, j, col)
    return best, col


def cooperative_take(vals):
    """The kernel's warp-cooperative visit: thread t scans columns t, t +
    32, t + 64, t + 96 in order with a strict < from (T_MISS, 0), then the
    butterfly of __shfl_xor_sync at offsets 16, 8, 4, 2, 1, each step
    taking the partner's pair on a smaller value, or an equal value at a
    lower column.  Returns every thread's pair (n, 32)."""
    n = vals.shape[0]
    bv = np.full((n, 32), P.T_MISS, np.float32)
    bc = np.zeros((n, 32), np.int64)
    for k in range(4):
        v = vals[:, 32 * k:32 * (k + 1)]
        take = v < bv
        bv = np.where(take, v, bv)
        bc = np.where(take, np.arange(32) + 32 * k, bc)
    for off in (16, 8, 4, 2, 1):
        partner = np.arange(32) ^ off
        ov, oc = bv[:, partner], bc[:, partner]
        take = (ov < bv) | ((ov == bv) & (oc < bc))
        bv = np.where(take, ov, bv)
        bc = np.where(take, oc, bc)
    return bv, bc


@pytest.mark.parametrize("pool", ["ties", "signed_zeros", "misses", "sweep_values"])
def test_cooperative_visit_equals_sequential_take(pool):
    """32 threads x 4 columns and the shuffle reduction give the
    sequential take's value (its bits) and column on every thread, with
    ties built on purpose; and the plain sweep's group minimum (lowest
    column at the minimum) agrees."""
    rng = np.random.default_rng(len(pool))
    n = 4096
    if pool == "ties":
        vals = rng.choice(np.float32([0.5, 1.0, 1.5, 2.0, P.T_MISS]), (n, 128))
    elif pool == "signed_zeros":
        vals = rng.choice(np.float32([-0.0, 0.0, 1.0, P.T_MISS]), (n, 128))
    elif pool == "misses":
        vals = np.full((n, 128), P.T_MISS, np.float32)
        vals[rng.random((n, 128)) < 0.01] = np.float32(np.inf)
        vals[:, 127] = rng.choice(np.float32([3.0, P.T_MISS]), n)
    else:  # the values one SphereField cluster gives random lanes
        tables = get_scene("SphereField").build().proj
        o, d = lane_set("random", BOXES["SphereField"], n, seed=5)
        onorm = ((o[:, 0] * o[:, 0] + o[:, 1] * o[:, 1]) + o[:, 2] * o[:, 2])[:, None]
        odot = ((o[:, 0] * d[:, 0] + o[:, 1] * d[:, 1]) + o[:, 2] * d[:, 2])[:, None]
        dnorm = ((d[:, 0] * d[:, 0] + d[:, 1] * d[:, 1]) + d[:, 2] * d[:, 2])[:, None]
        O, D, K = P._projections(tables, 0, 1, o, d)
        vals = P._group_values(0, True, O, D, K, onorm, odot, dnorm,
                               torch.tensor(T_MIN)).numpy()
        vals[:, ::3] = vals[:, 1::3]  # ties between neighbours
    vals = vals.astype(np.float32)
    best, col = sequential_take(vals)
    bv, bc = cooperative_take(vals)
    assert (bv.view(np.int32) == best.view(np.int32)[:, None]).all()
    assert (bc == col[:, None]).all()
    t = torch.from_numpy(vals)
    raw = t.min(dim=1, keepdim=True).values
    gc = torch.where(t <= raw, torch.arange(128), torch.full_like(t, 1 << 30,
                                                                 dtype=torch.int64))
    hit = best < P.T_MISS
    assert (gc.min(dim=1).values.numpy()[hit] == col[hit]).all()
    assert (raw[:, 0].numpy().view(np.int32)[hit] == best.view(np.int32)[hit]).all()
    assert hit.any() or pool == "misses"


# ---------------------------------------------------------------------------
# the kernel source, built with g++ on an emulated warp
# ---------------------------------------------------------------------------

# the source's COOP_P (None), and the test's copy with it moved so that
# every visit takes the per-lane sweep (1) or the cooperative one (33): the
# lane sets alone cannot hold each sweep to every visit
EMU_COOP_P = {"defaults": None, "per_lane_always": 1, "cooperative_always": 33}
COOP_P_LINE = re.compile(r"constexpr int COOP_P = (\d+);")


def build_emulated(tmp_path, coop_p=None):
    """``ops/csrc/projected.cu`` with its launches run by ``emu_launch``
    and its cp.async as a copy (and COOP_P set to ``coop_p`` where given),
    built with g++ against tests/cuda_emu.h."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    src = (CSRC / "projected.cu").read_text()
    assert [int(x) for x in COOP_P_LINE.findall(src)] == [P.COOP_P]
    if coop_p is not None:
        src = COOP_P_LINE.sub(f"constexpr int COOP_P = {coop_p};", src)
    src, n_launch = re.subn(
        r"(sweep_kernel<MODE_[A-Z]+>|resident_kernel)<<<\(unsigned\)blocks, THREADS, 0, s>>>\(",
        r"EMU_LAUNCH(blocks, \1, ", src)
    src, n_copy = re.subn(r'asm volatile\("cp\.async\.cg.*\);', "std::memcpy(dst, src, 16);",
                          src)
    src = re.sub(r"asm volatile\(.*\);", ";", src)
    src = src.replace("static_cast<unsigned>(__cvta_generic_to_shared(dst))", "0u")
    assert n_launch == 3 and n_copy == 1
    inc = tmp_path / "inc"
    inc.mkdir()
    (inc / "cuda_runtime.h").write_text(
        f'#include "{Path(__file__).resolve().parent / "cuda_emu.h"}"\n')
    (tmp_path / "projected_emu.cc").write_text(src)
    so = tmp_path / "projected_emu.so"
    subprocess.run([cxx, "-std=c++20", "-O1", "-shared", "-fPIC", "-pthread",
                    "-Wno-unknown-pragmas", f"-I{inc}", "-o", str(so),
                    str(tmp_path / "projected_emu.cc")], check=True)
    lib = ctypes.CDLL(str(so))
    for fn, (argtypes, restype) in SIGNATURES["projected"].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def launch_emulated(lib, mode, tables, o, d, words=None, counts=None, kcap=0, rb=1):
    """``projected.launch_sweep``'s call, on CPU tensors."""
    R = o.shape[0]
    t = torch.empty(R)
    col = torch.empty(R, dtype=torch.int32)
    pay = torch.empty((R, P.PAY_W))
    kinds, qflags = tables.kernel_ints
    tabs = (tables.a, tables.b, tables.const, tables.payload, tables.cluster_bounds,
            kinds, qflags, tables.rows, tables.bounds8)
    ptrs = (ctypes.c_void_p * 9)(*[x.data_ptr() for x in tabs])
    err = lib.projected_launch(
        mode, ptrs, tables.num_cols, tables.num_groups,
        None if words is None else words.data_ptr(),
        None if counts is None else counts.data_ptr(), kcap, rb,
        0 if words is None else words.shape[-1], o.data_ptr(), d.data_ptr(), T_MIN,
        t.data_ptr(), col.data_ptr(), pay.data_ptr(), R, None)
    assert err == 0
    return t, col, pay


@pytest.mark.parametrize("variant", list(EMU_COOP_P))
def test_emulated_kernel_source_matches_plain(variant, tmp_path):
    """K5, K6 and K7 of the CUDA source, run on the CPU with one thread a
    CUDA thread, equal their plain versions bit for bit on a mixed table
    (with rects) and a streamed one, on camera and random lanes whose
    warps visit clusters with 1 to 32 passing lanes."""
    lib = build_emulated(tmp_path, EMU_COOP_P[variant])
    rb = WL.WL_RB
    visits = np.zeros(33, np.int64)
    for tables in (_tables_of(mixed_scene(300, 40, 260, seed=5)),
                   _tables_of(mixed_scene(1700, 30, 600, seed=5),
                              max_single_cols=P.COL_BLOCK)):
        co, cd = lane_set("camera", BOXES["mixed"], 256, seed=1)
        ro, rd = lane_set("parked", BOXES["mixed"], 250, seed=2)  # 506 lanes: a ragged warp
        o, d = torch.cat([co, ro]), torch.cat([cd, rd])
        nb = -(-o.shape[0] // rb)
        pad = torch.zeros((nb * rb - o.shape[0], 3))
        meta, _ = WL.build_pair_worklist(tables.cluster_bounds, tables.group_kinds,
                                         torch.cat([o, pad]), torch.cat([d, pad]), T_MIN,
                                         rb, tables.num_groups)
        packed, counts = RS.pack_slots(meta, nb)
        stats = {}
        want = {0: P.projected_sweep_plain(tables, o, d, T_MIN, stats=stats),
                1: RS.resident_sweep_plain(tables, o, d, T_MIN, packed, counts, rb),
                2: WL.pair_sweep_plain(tables, o, d, T_MIN, meta, rb)}
        visits += stats["warp_visits"]
        got = {0: launch_emulated(lib, 0, tables, o, d),
               1: launch_emulated(lib, 1, tables, o, d, packed, counts,
                                  packed.shape[0] // nb, rb),
               2: launch_emulated(lib, 2, tables, o, d, meta, None, meta.shape[1] // nb,
                                  rb)}
        for mode in (0, 1, 2):
            _bits_equal(got[mode], want[mode])
        assert (want[0][1] >= 0).sum() > 100
    assert visits[1:8].sum() > 0 and visits[P.COOP_P:].sum() > 0
