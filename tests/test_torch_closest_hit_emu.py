"""K3's and K4's CUDA source on an emulated card, on the CPU, without JAX.

``ops/csrc/closest_hit.cu`` is built with g++ against ``tests/cuda_emu.h``
(one std::thread a CUDA thread, blocks of 256, ``__syncthreads``; a card of
2 SMs), its launches run by ``emu_launch``, as it is and in a copy whose
grid is one block an SM, so that 2 blocks walk 4 tiles.  Both
instantiations are held against ``closest_hit_plain`` /
``closest_hit_record_plain`` on lanes made from a numpy seed, the outputs
read through ``closest_hit.carve`` from the one buffer the launch fills.

Tolerances and why: hit, idx, mat, front, t, point and normal are EQUAL,
bit for bit (the same IEEE f32 expressions; g++ contracts no multiply-add
and the plain version's sqrt is correctly rounded).  A sphere's u and v
come from acosf / atan2f, whose last bit may differ between the C library
and PyTorch's CPU kernels: within CH_RTOL rel + CH_ATOL abs, the tolerance
chip_smoke.py holds the card to.
"""

import re

import numpy as np
import pytest
import torch

from rust_pathtracer_tpu_torch.integrator import T_MIN
from rust_pathtracer_tpu_torch.ops import closest_hit as ch
from rust_pathtracer_tpu_torch.ops._build import CSRC
from rust_pathtracer_tpu_torch.scene import SceneBuilder
from test_torch_cuda import _random_lanes, t_full_scene

torch.set_num_threads(2)

CH_RTOL, CH_ATOL = 1e-5, 1e-6  # sphere u, v only (chip_smoke.py's)
FILL = 0x7F  # every byte of the output buffer before a launch


@pytest.fixture(scope="module", params=["source", "one_block_an_sm"])
def emu_lib(request, tmp_path_factory):
    """``closest_hit.cu`` built by ``emu_build``: as it is (1,000 lanes
    are 4 blocks of one tile each), and in a copy with BLOCKS_PER_SM = 1,
    so that the emulated card's 2 blocks walk the 4 tiles (grid stride)."""
    from test_torch_projected_rows import emu_build

    src = (CSRC / "closest_hit.cu").read_text()
    if request.param == "one_block_an_sm":
        src, n = re.subn(r"constexpr int BLOCKS_PER_SM = \d+;",
                         "constexpr int BLOCKS_PER_SM = 1;", src)
        assert n == 1
    lib, n_launch = emu_build(tmp_path_factory.mktemp("closest_hit"), "closest_hit", src)
    assert n_launch == 2
    return lib


def edge_scene():
    """Every kind, with ties and edges: a sphere, a rect and a triangle
    each listed twice (the second copy with another material: the first
    must win), a hollow shell inside the sphere, rects on all three axes,
    a one-sided triangle that rays also meet from behind, and a small xy
    rect at z = 0 for the lanes that meet it at exactly t_min."""
    b = SceneBuilder()
    m = [b.lambertian((0.1 * k, 0.5, 0.5)) for k in range(1, 6)]
    b.add_sphere((0.0, 0.0, -3.0), 1.0, m[0])
    b.add_sphere((0.0, 0.0, -3.0), 1.0, m[1])  # tie with the one above
    b.add_sphere((0.0, 0.0, -3.0), -0.5, m[2])  # hollow shell
    b.add_rect("xy", (-3.0, -3.0, -6.0), (3.0, 3.0, -6.0), 1.0, m[0])
    b.add_rect("xy", (-3.0, -3.0, -6.0), (3.0, 3.0, -6.0), 1.0, m[3])  # tie
    b.add_rect("xz", (-3.0, -2.0, -6.0), (3.0, -2.0, 0.0), 1.0, m[1])
    b.add_rect("yz", (3.5, -3.0, -6.0), (3.5, 3.0, 0.0), -1.0, m[2])
    b.add_triangle((-2.5, -1.0, -5.0), (-0.5, -1.0, -5.0), (-1.5, 1.0, -5.0), m[0])
    b.add_triangle((-2.5, -1.0, -5.0), (-0.5, -1.0, -5.0), (-1.5, 1.0, -5.0), m[4])  # tie
    b.add_triangle((1.0, 2.0, -4.0), (2.0, 2.0, -4.0), (1.5, 2.8, -4.0), m[3])
    b.add_rect("xy", (2.0, 2.0, 0.0), (3.0, 3.0, 0.0), 1.0, m[4])  # the t_min rect
    return b.build(use_bvh=False)


def edge_lanes(n, seed):
    """(o, d) of n lanes: random rays through the scene box, rays aimed
    at the listed-twice primitives from either side, rays with zero
    direction components (one, two or all three), and rays that meet the
    z = 0 rect at t = t_min exactly (and a hair before and after)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3.0, 3.0, (n, 3))
    o[:, 2] += -2.0
    d = rng.normal(0.0, 1.0, (n, 3))
    aims = np.array([[0.0, 0.0, -3.0], [0.0, 0.0, -6.0], [-1.5, -0.3, -5.0],
                     [1.5, 2.3, -4.0]])
    k = n // 3
    tgt = aims[rng.integers(0, len(aims), k)] + rng.normal(0.0, 0.3, (k, 3))
    src = np.where(rng.random((k, 1)) < 0.7, [0.0, 0.5, 2.0], [0.0, 0.0, -8.0])
    o[:k] = src + rng.normal(0.0, 0.2, (k, 3))
    d[:k] = (tgt - o[:k]) * rng.uniform(0.2, 3.0, (k, 1))
    z = n // 6
    zero = rng.random((z, 3)) < 0.5
    zero[: max(1, z // 8)] = True  # all three
    d[k:k + z] = np.where(zero, 0.0, d[k:k + z])
    e = min(n - k - z, 16)
    t_min32 = float(np.float32(T_MIN))
    o[k + z:k + z + e] = np.stack([rng.uniform(2.1, 2.9, e), rng.uniform(2.1, 2.9, e),
                                   np.full(e, -t_min32)], 1)
    d[k + z:k + z + e] = np.array([0.0, 0.0, 1.0]) * np.resize(
        [1.0, 1.0, 2.0, 0.999999, 1.000001, -1.0], e)[:, None]
    return o.astype(np.float32), d.astype(np.float32)


def every_kind_lanes(n, seed):
    cols, _ = _random_lanes(n, seed=seed)
    return cols[0:3].T.copy(), cols[3:6].T.copy()


CASES = {  # name -> (scene, lanes, lane count)
    "every_kind_1000": (t_full_scene, every_kind_lanes, 1000),
    "every_kind_1": (t_full_scene, every_kind_lanes, 1),
    "edges_1000": (edge_scene, edge_lanes, 1000),
    "edges_257": (edge_scene, edge_lanes, 257),
}


def launch_emulated(lib, table, o, d, record):
    """``closest_hit._launch``'s call on CPU tensors; returns the planes
    by name (``carve``) of a buffer filled with FILL before the launch."""
    R = o.shape[0]
    n_bytes = ch.OUT_BYTES_A_LANE[record] * (-(-R // ch.PAD_LANES) * ch.PAD_LANES)
    buf = torch.full((n_bytes,), FILL, dtype=torch.uint8).view(torch.float32)
    err = lib.closest_hit_launch(table.data_ptr(), table.shape[1], o.data_ptr(),
                                 d.data_ptr(), T_MIN, int(record), buf.data_ptr(), R, None)
    assert err == 0
    return ch.carve(buf, R, record)


def _bits(x):
    return x.view(torch.uint8) if x.dtype == torch.bool else x.view(torch.int32)


@pytest.mark.parametrize("record", [False, True], ids=["K4", "K3"])
@pytest.mark.parametrize("case", list(CASES))
def test_emulated_kernel_source_matches_plain(case, record, emu_lib):
    """Both instantiations, ragged lane counts (1, 257, 1,000: 4 tiles,
    the last one part full), on
    the every-kind scene and on the edge scene (ties, zero direction
    components, hits at exactly t_min, a hollow shell, a back-facing
    triangle): every plane of the buffer equal to the plain version's,
    bit for bit, but a sphere's u and v (CH_RTOL / CH_ATOL)."""
    make_scene, make_lanes, n = CASES[case]
    scene = make_scene()
    o_np, d_np = make_lanes(n, seed=11)
    o, d = torch.from_numpy(o_np), torch.from_numpy(d_np)
    table = ch.pack_prims(scene.prims)
    kw = dict(kinds=scene.kinds_static, t_min=T_MIN)
    got = launch_emulated(emu_lib, table, o, d, record)
    if record:
        hit, t, idx, rec = ch.closest_hit_record_plain(table, o, d, **kw)
        want = dict(hit=hit, t=t, idx=idx, point=rec.point, normal=rec.normal,
                    front=rec.front_face, u=rec.u, v=rec.v, mat=rec.mat)
    else:
        want = dict(zip(("hit", "t", "idx"), ch.closest_hit_plain(table, o, d, **kw)))
    assert set(got) == set(want)
    kinds = scene.prims.kind.numpy()
    sphere = torch.from_numpy(kinds[want["idx"].numpy()] == 0) & want["hit"]
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape and g.dtype == w.dtype, name
        exact = ~sphere if name in ("u", "v") else torch.ones_like(sphere)
        assert torch.equal(_bits(g)[exact], _bits(w)[exact]), name
        if name in ("u", "v"):
            torch.testing.assert_close(g[sphere], w[sphere], rtol=CH_RTOL, atol=CH_ATOL)
    hit = want["hit"].numpy()
    if n >= 257:  # the lane sets reach what they are for
        won = set(want["idx"].numpy()[hit].tolist())
        assert len(won) >= scene.num_prims - 4 and 0.3 < hit.mean() < 0.9
    if case.startswith("edges") and n >= 257:
        assert {1, 4, 8}.isdisjoint(won)  # the second of each pair never wins
        at_min = hit & (want["t"].numpy() == np.float32(T_MIN))
        assert at_min.sum() >= 2 and (want["idx"].numpy()[at_min] == 10).all()
        assert (d_np == 0).any(axis=1).sum() > 20

