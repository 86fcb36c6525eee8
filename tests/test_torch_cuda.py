"""K1-K7, the draw, lanes, pass-set key and shade kernels on the card against
their plain PyTorch versions.

Imports no jax, so that it runs on the machine with the card, which has
none; there, skip this directory's conftest.py (it sets up JAX):

    python -m pytest --noconftest tests/test_torch_cuda.py -q

Tests marked ``cuda`` skip where there is no GPU.  The helpers here
also feed ``test_torch_fused_bounce.py`` and
``test_torch_fused_bounce_bwd.py``.
"""

import os

import numpy as np
import pytest
import torch

from rust_pathtracer_tpu_torch.integrator import T_MIN
from rust_pathtracer_tpu_torch.ops import closest_hit as ch
from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
from rust_pathtracer_tpu_torch.ops import fused_bounce_bwd as fbb
from rust_pathtracer_tpu_torch.scene import SceneBuilder


def t_full_scene():
    """tests/test_fused_bounce.py::_full_scene on the port's builder."""
    b = SceneBuilder()
    checker = b.checker_texture(
        b.solid_texture((0.2, 0.3, 0.1)), b.solid_texture((0.9, 0.9, 0.9))
    )
    perlin = b.perlin_texture(4.0)
    b.add_sphere((0, -100.5, -3), 100.0, b.lambertian(checker))
    b.add_sphere((0, 0.5, -3), 0.5, b.lambertian(perlin))
    b.add_sphere((1.2, 0.5, -3), 0.5, b.metal((0.8, 0.7, 0.6), fuzz=0.2))
    b.add_sphere((-1.2, 0.5, -3), 0.5, b.dielectric(1.5))
    b.add_sphere((-1.2, 0.5, -3), -0.4, b.dielectric(1.5))  # hollow shell
    b.add_rect("xz", (-2, 3.0, -5), (2, 3.0, -1), -1.0,
               b.diffuse_light((4, 4, 4)))
    b.add_triangle((2.2, 0.0, -4), (3.2, 0.0, -4), (2.7, 1.2, -4),
                   b.lambertian((0.6, 0.2, 0.2)))
    return b.build(use_bvh=False)


def _random_lanes(n, seed):
    """(13, n) state columns and (6, n) uniforms: rays from in front of
    the scene, from inside the glass shell and from under the light."""
    rng = np.random.default_rng(seed)
    o = np.array([0.0, 0.8, 1.5]) + rng.normal(0.0, 0.3, (n, 3))
    ang = rng.uniform(-0.6, 0.6, n)
    d = np.stack([np.sin(ang), rng.uniform(-0.9, 0.5, n), -np.cos(ang)], 1)
    d *= rng.uniform(0.5, 2.0, n)[:, None]
    k = n // 8
    o[:k] = np.array([-1.2, 0.5, -3.0]) + rng.uniform(-0.3, 0.3, (k, 3))
    d[:k] = rng.normal(0.0, 1.0, (k, 3))
    o[k:2 * k] = np.array([0.0, 1.5, -3.0]) + rng.uniform(-1.5, 1.5, (k, 3))
    d[k:2 * k] = np.array([0.0, 1.0, 0.0]) + rng.normal(0.0, 0.4, (k, 3))
    thr = rng.uniform(0.2, 1.0, (n, 3))
    rad = rng.uniform(0.0, 0.5, (n, 3))
    alive = (rng.random(n) < 0.9).astype(np.float64)
    cols = np.concatenate([o, d, thr, rad, alive[:, None]], 1).T
    return cols.astype(np.float32), rng.random((6, n)).astype(np.float32)


def _t_inputs(cols, uni, device="cpu"):
    c = torch.as_tensor(cols, device=device)
    u = torch.as_tensor(uni, device=device)
    return dict(zip(fb._COL_KEYS, c.unbind(0))), u.unbind(0)


def _bwd_inputs(res_np, cols, bg, seed, device="cpu"):
    """K2's arguments from numpy residuals (``fb._RES_KEYS``) and the
    bounce's (13, n) input columns, with normal cotangents from numpy.
    Returns (res, d, thr, cots, bg, the (12, n) numpy cotangents)."""
    n = cols.shape[1]
    cot = np.random.default_rng(seed).normal(size=(12, n)).astype(np.float32)

    def t(x):
        return torch.tensor(np.asarray(x), device=device)

    res = {k: t(v) for k, v in res_np.items()}
    d = tuple(t(cols[3 + c]) for c in range(3))
    thr = tuple(t(cols[6 + c]) for c in range(3))
    cots = dict(zip(fbb._COT_KEYS, (t(c) for c in cot)))
    return res, d, thr, cots, torch.tensor(bg, device=device), cot


def _run_plain(scene, cols, uni, bg):
    tcols, tuni = _t_inputs(cols, uni)
    win = torch.empty(cols.shape[1], dtype=torch.int32)
    out = fb.fused_bounce_cols_plain(
        fb.pack_prims_shaded(scene), torch.tensor(bg), scene.textures.perlin_seed,
        tcols, *tuni, kinds=scene.kinds_static, mat_types=scene.mat_types,
        tex_types=scene.tex_types, t_min=T_MIN, winner_out=win)
    return np.stack([out[k].numpy() for k in fb._COL_KEYS]), win.numpy()


def _keyed_inputs(cols, device, key_seed=13):
    """The keyed K1's (13, n) state and (2, n) key words on ``device``."""
    from rust_pathtracer_tpu_torch import sampling

    n = cols.shape[1]
    lk = sampling.lane_keys(sampling.prng_key(key_seed), torch.arange(n))
    return torch.as_tensor(cols, device=device), fb.key_words(lk).to(device)


@pytest.mark.cuda
def test_kernel_matches_plain_on_gpu():
    """K1 on the card against the plain version on the CPU: masks and
    winners exact, floats within 1e-5 rel + 1e-6 abs (sin/cos differ by
    an ulp between CUDA and the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene = t_full_scene()
    cols, _ = _random_lanes(4096, seed=21)
    bg = (0.2, 0.1, 0.05)
    kw = dict(with_roulette=False, kinds=scene.kinds_static, mat_types=scene.mat_types,
              tex_types=scene.tex_types, t_min=T_MIN)
    p_win = torch.empty(4096, dtype=torch.int32)
    p_out = fb.fused_bounce_keyed_plain(
        fb.pack_prims_shaded(scene), torch.tensor(bg), 0, *_keyed_inputs(cols, "cpu"), 0,
        winner_out=p_win, **kw).numpy()
    gscene = scene.to("cuda")
    win = torch.empty(4096, dtype=torch.int32, device="cuda")
    before = fb.launches
    out = fb.fused_bounce_keyed(
        fb.pack_prims_shaded(gscene), torch.tensor(bg, device="cuda"), 0,
        *_keyed_inputs(cols, "cuda"), 0, winner_out=win, **kw)
    torch.cuda.synchronize()
    assert fb.launches == before + 1
    k_out = out.cpu().numpy()
    np.testing.assert_array_equal(win.cpu().numpy(), p_win.numpy())
    np.testing.assert_array_equal(k_out[12], p_out[12])
    np.testing.assert_allclose(k_out, p_out, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_cornellbox_golden_on_gpu():
    """The CornellBox golden configuration rendered on the card, through
    K1, under the image contract; every bounce launched K1."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.image import image_agreement

    sd = get_scene("CornellBox")
    settings = RenderSettings(64, 64, 16, 12, (0.0, 0.0, 0.0), spp_chunk=16)
    before = fb.launches
    img, stats = render_radiance(sd.build(), sd.camera_at(0.0), settings,
                                 prng_key(1234), device="cuda")
    assert fb.launches - before == stats.bounces > 0
    want = np.load(os.path.join(os.path.dirname(__file__), "goldens",
                                "CornellBox.npy"))
    a = image_agreement(img.cpu().numpy(), want)
    assert a["ok"], a


@pytest.mark.cuda
def test_bwd_kernel_matches_plain_on_gpu():
    """K1 with residuals, then K2, on the card against the plain versions
    on the CPU.  Residual flags exact (no checker lane of this input lies
    near a sign change of its sin-product), floats within 1e-5 rel +
    1e-6 abs.  K2 and its plain version fed the same residuals: the 9
    outputs within 1e-5 rel + 1e-5 of the largest (the same IEEE
    expressions), the reductions within 1e-5 of the largest (another
    sum order) and bitwise equal on a second run."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene = t_full_scene()
    cols, _ = _random_lanes(4096, seed=21)
    bg = (0.2, 0.1, 0.05)
    kw = dict(with_roulette=False, kinds=scene.kinds_static, mat_types=scene.mat_types,
              tex_types=scene.tex_types, t_min=T_MIN, want_residuals=True)
    runs = {}
    for dev in ("cpu", "cuda"):
        table = fb.pack_prims_shaded(scene.to(dev))
        out, res = fb.fused_bounce_keyed(table, torch.tensor(bg, device=dev), 0,
                                         *_keyed_inputs(cols, dev), 0, **kw)
        runs[dev] = {k: v.cpu().numpy() for k, v in res.items()}
    np.testing.assert_array_equal(runs["cuda"]["flags"], runs["cpu"]["flags"])
    for k in fb._RES_KEYS[:-1]:
        np.testing.assert_allclose(runs["cuda"][k], runs["cpu"][k], rtol=1e-5,
                                   atol=1e-6, err_msg=k)

    kw = dict(mat_types=scene.mat_types, n_prims=scene.num_prims)
    p_g, p_tex, p_bg = fbb.fused_bounce_bwd(*_bwd_inputs(runs["cpu"], cols, bg, 3)[:5], **kw)
    args = _bwd_inputs(runs["cpu"], cols, bg, 3, device="cuda")[:5]
    before = fbb.launches
    k_g, k_tex, k_bg = fbb.fused_bounce_bwd(*args, **kw)
    _, k_tex2, k_bg2 = fbb.fused_bounce_bwd(*args, **kw)
    torch.cuda.synchronize()
    assert fbb.launches == before + 2
    got = np.stack([k_g[k].cpu().numpy() for k in fbb._GRAD_KEYS])
    want = np.stack([p_g[k].numpy() for k in fbb._GRAD_KEYS])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    red = np.concatenate([p_tex.numpy().ravel(), p_bg.numpy()])
    k_red = np.concatenate([k_tex.cpu().numpy().ravel(), k_bg.cpu().numpy()])
    np.testing.assert_allclose(k_red, red, rtol=1e-5, atol=1e-5 * np.abs(red).max())
    assert torch.equal(k_tex, k_tex2) and torch.equal(k_bg, k_bg2)


@pytest.mark.cuda
def test_diff_step_on_gpu_matches_cpu():
    """A small differentiable CornellBox step on the card (K1 with
    residuals and K2 launched once per bounce) against the same step on
    the CPU: loss within 2e-3 rel, every gradient leaf within rtol 0.05
    and 2e-3 of the largest gradient (an ulp of sin/cos on the card can
    reroute a lane's path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from rust_pathtracer_tpu_torch.grad import (
        CameraParams, DiffParams, render_loss_and_grad,
    )
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import RenderSettings
    from rust_pathtracer_tpu_torch.sampling import prng_key

    scene = get_scene("CornellBox").build()
    cam = CameraParams.create((278.0, 278.0, -800.0), (278.0, 278.0, 0.0),
                              (0.0, 1.0, 0.0), 40.0, 1.0, 0.0, 10.0)
    settings = RenderSettings(16, 16, 4, 8, (0.5, 0.5, 0.5), spp_chunk=4,
                              russian_roulette_start=4)
    params = DiffParams.from_scene(scene, cam, settings.background)
    target = torch.zeros(16, 16, 3)
    out = {}
    for dev in ("cpu", "cuda"):
        k1, k2 = fb.residual_launches, fbb.launches
        out[dev] = render_loss_and_grad(params, scene, settings, prng_key(7),
                                        target, device=dev)
        if dev == "cuda":
            assert fb.residual_launches - k1 == fbb.launches - k2 == 8
    (l0, g0), (l1, g1) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(float(l1), float(l0), rtol=2e-3)
    f0 = torch.cat([x.reshape(-1) for x in g0.leaves()]).numpy()
    f1 = torch.cat([x.cpu().reshape(-1) for x in g1.leaves()]).numpy()
    assert np.abs(f0).max() > 0 and np.isfinite(f1).all()
    np.testing.assert_allclose(f1, f0, rtol=0.05, atol=2e-3 * np.abs(f0).max())


@pytest.mark.cuda
def test_closest_hit_kernels_match_plain_on_gpu():
    """K4 and K3 on the card against their plain versions on the CPU,
    4096 random lanes of the every-kind scene: hit, idx, mat and front
    exact; t, point, normal, u, v within 1e-5 rel + 1e-6 abs (acosf /
    atan2f differ by an ulp from the CPU's)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene = t_full_scene()
    cols, _ = _random_lanes(4096, seed=23)
    o = torch.from_numpy(cols[0:3].T.copy())
    d = torch.from_numpy(cols[3:6].T.copy())
    kw = dict(kinds=scene.kinds_static, t_min=T_MIN)
    table = ch.pack_prims(scene.prims)
    before = (ch.hit_launches, ch.record_launches)
    gpu = [x.cuda() for x in (table, o, d)]
    k4 = ch.closest_hit(*gpu, **kw)
    k3 = ch.closest_hit_record(*gpu, **kw)
    torch.cuda.synchronize()
    assert (ch.hit_launches, ch.record_launches) == (before[0] + 1, before[1] + 1)
    p4 = ch.closest_hit_plain(table, o, d, **kw)
    p3 = ch.closest_hit_record_plain(table, o, d, **kw)
    for a, b in zip(k4[0:3:2], p4[0:3:2]):
        assert torch.equal(a.cpu(), b)
    torch.testing.assert_close(k4[1].cpu(), p4[1], rtol=1e-5, atol=1e-6)
    for f in ("valid", "prim", "mat", "front_face"):
        assert torch.equal(getattr(k3[3], f).cpu(), getattr(p3[3], f)), f
    for f in ("t", "point", "normal", "u", "v"):
        torch.testing.assert_close(getattr(k3[3], f).cpu(), getattr(p3[3], f),
                                   rtol=1e-5, atol=1e-6, msg=f)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 1000, 70001])
def test_closest_hit_kernels_bitwise_on_gpu(n):
    """K4 and K3 on the card against their plain versions on the same
    CUDA tensors, at lane counts that leave a ragged last tile: every
    output bit for bit, but a sphere's u and v (acosf / atan2f) within
    1e-5 rel + 1e-6 abs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene = t_full_scene()
    cols, _ = _random_lanes(n, seed=n)
    o = torch.from_numpy(cols[0:3].T.copy()).cuda()
    d = torch.from_numpy(cols[3:6].T.copy()).cuda()
    table = ch.pack_prims(scene.prims).cuda()
    kw = dict(kinds=scene.kinds_static, t_min=T_MIN)
    k4, p4 = ch.closest_hit(table, o, d, **kw), ch.closest_hit_plain(table, o, d, **kw)
    k3, p3 = (ch.closest_hit_record(table, o, d, **kw),
              ch.closest_hit_record_plain(table, o, d, **kw))
    torch.cuda.synchronize()
    for a, b in zip(k4, p4):
        assert torch.equal(a, b)
    sphere = p3[0] & (scene.prims.kind.cuda()[p3[2].long()] == 0)
    for f in ("valid", "prim", "mat", "front_face", "t", "point", "normal", "u", "v"):
        a, b = getattr(k3[3], f), getattr(p3[3], f)
        keep = ~sphere if f in ("u", "v") else torch.ones_like(sphere)
        assert torch.equal(a[keep], b[keep]), f
        if f in ("u", "v"):
            torch.testing.assert_close(a[sphere], b[sphere], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_generic_diff_step_on_gpu_matches_cpu():
    """A small differentiable TwoSphereCheckers step (generic route: K4
    once a bounce, never in the backward) on the card against the CPU:
    loss within 2e-3 rel, every gradient leaf within rtol 0.05 and 2e-3
    of the largest; bit for bit the same on a second run on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from rust_pathtracer_tpu_torch.grad import (
        CameraParams, DiffParams, render_loss_and_grad,
    )
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import RenderSettings
    from rust_pathtracer_tpu_torch.sampling import prng_key

    scene = get_scene("TwoSphereCheckers").build()
    cam = CameraParams.create((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                              20.0, 854.0 / 480.0, 0.0, 10.0)
    settings = RenderSettings(16, 9, 4, 6, (1.0, 1.0, 1.0))
    params = DiffParams.from_scene(scene, cam, settings.background)
    target = torch.zeros(9, 16, 3)
    out = {}
    for dev in ("cpu", "cuda", "cuda2"):
        before = ch.hit_launches
        out[dev] = render_loss_and_grad(params, scene, settings, prng_key(0), target,
                                        device=dev[:4])
        if dev != "cpu":
            assert ch.hit_launches - before == settings.max_bounces
    (l0, g0), (l1, g1), (l2, g2) = out["cpu"], out["cuda"], out["cuda2"]
    np.testing.assert_allclose(float(l1), float(l0), rtol=2e-3)
    f0 = torch.cat([x.reshape(-1) for x in g0.leaves()]).numpy()
    f1 = torch.cat([x.cpu().reshape(-1) for x in g1.leaves()]).numpy()
    assert np.abs(f0).max() > 0 and np.isfinite(f1).all()
    np.testing.assert_allclose(f1, f0, rtol=0.05, atol=2e-3 * np.abs(f0).max())
    assert torch.equal(l1, l2)
    assert all(torch.equal(a, b) for a, b in zip(g1.leaves(), g2.leaves()))


def _mixed_scene(n_spheres, n_rects, n_tris, seed):
    """tests/test_projected.py::_mixed_scene on the port's builder."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for _ in range(n_spheres):
        b.add_sphere(rng.uniform(-8, 8, 3), rng.uniform(0.3, 1.2), m)
    for _ in range(n_rects):
        plane = ["xy", "xz", "yz"][rng.integers(3)]
        fixed = {"xy": 2, "xz": 1, "yz": 0}[plane]
        st = rng.uniform(-8, 8, 3)
        e = st + rng.uniform(0.5, 3.0, 3)
        e[fixed] = st[fixed]
        b.add_rect(plane, st, e, 1.0 if rng.random() < 0.5 else -1.0, m)
    for _ in range(n_tris):
        p0 = rng.uniform(-8, 8, 3)
        b.add_triangle(p0, p0 + rng.uniform(-2, 2, 3), p0 + rng.uniform(-2, 2, 3), m)
    return b.build(use_bvh=False)


def _proj_rays(n, seed):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-10, 10, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    o[::7] = 3.0e33  # parked lanes
    return torch.from_numpy(o), torch.from_numpy(d)


def _warp_mixed_rays(n_warps, seed):
    """Warps of 32 lanes in turns: 32 near-parallel rays from one point
    into the scene (a cluster that one passes, most pass), then one such
    ray and 31 parked lanes (at most one lane passes a cluster), so that
    the kernels' visits take both the per-lane and the warp-cooperative
    sweep."""
    rng = np.random.default_rng(seed)
    o = np.empty((n_warps, 32, 3), np.float32)
    d = np.empty((n_warps, 32, 3), np.float32)
    for w in range(n_warps):
        src = rng.uniform(-10, 10, 3)
        aim = rng.uniform(-4, 4, 3) - src
        o[w] = src
        d[w] = aim + rng.normal(0.0, 0.02 * np.linalg.norm(aim), (32, 3))
        if w % 2:
            o[w, 1:] = 3.0e33
    return (torch.from_numpy(o.reshape(-1, 3)), torch.from_numpy(d.reshape(-1, 3)))


@pytest.mark.cuda
@pytest.mark.parametrize("streamed", [False, True])
def test_projected_kernels_match_plain_on_gpu(streamed):
    """K5, K6 and K7 on the card against their plain versions on the
    CPU, 4000 random lanes (every seventh parked) of a mixed scene, one
    p-block or streamed, then 4096 lanes whose warps pass a cluster with
    one lane or with up to 32 (``_warp_mixed_rays``; the plain sweep's
    warp-visit counts show both): t, column and payload bit for bit (IEEE
    f32 on both sides, one order of operations)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from rust_pathtracer_tpu_torch.ops import projected as P
    from rust_pathtracer_tpu_torch.ops import resident as RS
    from rust_pathtracer_tpu_torch.ops import worklist as WL

    scene = _mixed_scene(*((1700, 30, 600) if streamed else (300, 40, 260)), seed=5)
    pr = scene.prims
    tables = P.build_projected(pr.kind.numpy(), pr.aux.numpy(), pr.data.numpy(),
                               pr.mat.numpy(),
                               max_single_cols=P.COL_BLOCK if streamed else P.MAX_SINGLE_COLS)
    assert (tables.col_block < tables.num_cols) == streamed
    gt = tables.to("cuda")
    for o, d in (_proj_rays(4000, seed=11), _warp_mixed_rays(128, seed=12)):
        n = o.shape[0]
        rb = WL.WL_RB
        Rp = -(-n // rb) * rb
        pad = torch.zeros((Rp - n, 3))
        meta, _ = WL.build_pair_worklist(tables.cluster_bounds, tables.group_kinds,
                                         torch.cat([o, pad]), torch.cat([d, pad]), T_MIN,
                                         rb, tables.num_groups)
        go, gd = o.cuda(), d.cuda()
        runs = {
            "K5": (P, lambda t, a, b: P.projected_sweep(t, a, b, T_MIN), ()),
            "K6": (RS, lambda t, a, b: RS.resident_sweep(t, a, b, T_MIN), ()),
            "K7": (WL, lambda t, a, b, m: WL.pair_sweep(t, a, b, T_MIN, m, rb), (meta,)),
        }
        for name, (mod, fn, extra) in runs.items():
            before = mod.launches
            got = fn(gt, go, gd, *(x.cuda() for x in extra))
            torch.cuda.synchronize()
            assert mod.launches == before + 1, name
            want = fn(tables, o, d, *extra)
            for a, b in zip(got, want):
                assert torch.equal(a.cpu(), b), name
        assert (want[1] >= 0).sum() > n // 8
    stats = {}
    P.projected_sweep_plain(tables, o, d, T_MIN, stats=stats)
    visits = stats["warp_visits"]
    assert visits[1] > 0 and sum(visits[P.COOP_P:]) > 0, visits


@pytest.mark.cuda
def test_projected_wrappers_raise_on_gpu():
    """The wrappers refuse what the kernels do not take: tables and rays
    on two devices, f64 rays, a slot table of the wrong shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from rust_pathtracer_tpu_torch.ops import projected as P
    from rust_pathtracer_tpu_torch.ops import worklist as WL

    scene = _mixed_scene(200, 0, 0, seed=3)
    pr = scene.prims
    tables = P.build_projected(pr.kind.numpy(), pr.aux.numpy(), pr.data.numpy(),
                               pr.mat.numpy(), device="cuda")
    o, d = (x.cuda() for x in _proj_rays(64, seed=2))
    with pytest.raises(ValueError, match="devices|on cpu|cuda"):
        P.projected_sweep(tables, o.cpu(), d.cpu(), T_MIN)
    with pytest.raises(TypeError, match="float32"):
        P.projected_sweep(tables, o.double(), d.double(), T_MIN)
    with pytest.raises(ValueError, match="slot table"):
        WL.pair_sweep(tables, o, d, T_MIN, torch.zeros((2, 3), dtype=torch.int32,
                                                       device="cuda"), 32)


@pytest.mark.cuda
def test_big_scene_on_gpu_matches_cpu():
    """SphereField on the card against the CPU: the forward render (K6
    once a bounce) under the image contract, and a small differentiable
    step (K5 once a bounce) within test_diff_step_on_gpu_matches_cpu's
    tolerance."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from rust_pathtracer_tpu_torch.grad import (
        CameraParams, DiffParams, render_loss_and_grad,
    )
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops import projected as P
    from rust_pathtracer_tpu_torch.ops import resident as RS
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.image import image_agreement

    sd = get_scene("SphereField")
    scene = sd.build()
    settings = RenderSettings(32, 18, 2, 6, (1.0, 1.0, 1.0))
    before = RS.launches
    gimg, gst = render_radiance(scene, sd.camera_at(0.0), settings, prng_key(0),
                                device="cuda")
    assert RS.launches - before == gst.bounces > 0
    cimg, _ = render_radiance(scene, sd.camera_at(0.0), settings, prng_key(0),
                              device="cpu")
    a = image_agreement(gimg.cpu().numpy(), cimg.numpy())
    assert a["ok"], a
    cam = CameraParams.create((12.0, 1.0, 0.0), (0.0, 0.5, 0.0), (0.0, 1.0, 0.0), 20.0,
                              854.0 / 480.0, 0.1, 10.0)
    params = DiffParams.from_scene(scene, cam, settings.background)
    out = {}
    for dev in ("cpu", "cuda"):
        before = P.launches
        out[dev] = render_loss_and_grad(params, scene, RenderSettings(16, 9, 2, 4, (1.0,) * 3),
                                        prng_key(0), torch.zeros(9, 16, 3), device=dev)
        if dev == "cuda":
            assert P.launches - before == 4
    (l0, g0), (l1, g1) = out["cpu"], out["cuda"]
    np.testing.assert_allclose(float(l1), float(l0), rtol=2e-3)
    f0 = torch.cat([x.reshape(-1) for x in g0.leaves()]).numpy()
    f1 = torch.cat([x.cpu().reshape(-1) for x in g1.leaves()]).numpy()
    np.testing.assert_allclose(f1, f0, rtol=0.05, atol=2e-3 * np.abs(f0).max())


@pytest.mark.cuda
def test_keyed_kernel_matches_plain_on_gpu():
    """The keyed K1 and K1-res (in-kernel draws, roulette), at bounces 0
    and 7 with roulette off and on, against (a) the keyed plain version
    on the same CUDA tensors: every column, winner, residual plane and
    flag bit for bit (the draws are exact integer arithmetic, and on the
    card the kernel rounds as its plain version does); (b) the keyed
    plain version on the CPU: masks and winners exact, floats within
    1e-5 rel + 1e-6 abs (sin/cos)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from rust_pathtracer_tpu_torch import sampling

    scene = t_full_scene()
    n = 4096
    cols, _ = _random_lanes(n, seed=25)
    lk = sampling.lane_keys(sampling.prng_key(13), torch.arange(n))
    bg = (0.2, 0.1, 0.05)
    for bounce in (0, 7):
        for rr in (False, True):
            for want_res in (False, True):
                kw = dict(kinds=scene.kinds_static, mat_types=scene.mat_types,
                          tex_types=scene.tex_types, t_min=T_MIN,
                          want_residuals=want_res)
                runs = {}
                for where in ("kernel", "plain", "cpu"):
                    dev = "cpu" if where == "cpu" else "cuda"
                    state = torch.as_tensor(cols, device=dev)
                    table = fb.pack_prims_shaded(scene.to(dev))
                    bgt = torch.tensor(bg, device=dev)
                    win = torch.empty(n, dtype=torch.int32, device=dev)
                    args = (table, bgt, 0, state, fb.key_words(lk.to(dev)), bounce)
                    fn = (fb.fused_bounce_keyed if where == "kernel"
                          else fb.fused_bounce_keyed_plain)
                    before = fb.launches
                    out = fn(*args, with_roulette=rr, winner_out=win, **kw)
                    out, res = out if want_res else (out, {})
                    assert fb.launches == before + (where == "kernel")
                    runs[where] = (out.cpu().numpy(), win.cpu().numpy(),
                                   {k: v.cpu().numpy() for k, v in res.items()})
                torch.cuda.synchronize()
                k_out, k_win, k_res = runs["kernel"]
                p_out, p_win, p_res = runs["plain"]
                np.testing.assert_array_equal(k_out.view(np.int32), p_out.view(np.int32))
                np.testing.assert_array_equal(k_win, p_win)
                assert set(k_res) == set(p_res)
                for k in k_res:
                    np.testing.assert_array_equal(
                        k_res[k].view(np.int32), p_res[k].view(np.int32), err_msg=k)
                assert ("rr_p" in k_res) == (rr and want_res)
                c_out, c_win, _ = runs["cpu"]
                np.testing.assert_array_equal(k_win, c_win)
                np.testing.assert_array_equal(k_out[12], c_out[12])
                np.testing.assert_allclose(k_out, c_out, rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 257, 70001])
def test_keyed_kernel_per_lane_depth_on_gpu(n):
    """K1 at per-lane depth (the regen wavefront's: random depths 0-49,
    roulette from depth 3, and off) against the keyed plain version on the
    same CUDA tensors: every column and winner bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    scene = t_full_scene().to("cuda")
    cols, _ = _random_lanes(n, seed=27)
    state, keys = _keyed_inputs(cols, "cuda")
    depth = torch.as_tensor(np.random.default_rng(n).integers(0, 50, n).astype(np.int32),
                            device="cuda")
    table, bg = fb.pack_prims_shaded(scene), torch.tensor((0.2, 0.1, 0.05), device="cuda")
    for rr in (False, True):
        runs = []
        for fn in (fb.fused_bounce_keyed, fb.fused_bounce_keyed_plain):
            win = torch.empty(n, dtype=torch.int32, device="cuda")
            before = fb.launches
            out = fn(table, bg, scene.textures.perlin_seed, state, keys, depth,
                     with_roulette=rr, rr_start=3, kinds=scene.kinds_static,
                     mat_types=scene.mat_types, tex_types=scene.tex_types, t_min=T_MIN,
                     winner_out=win)
            torch.cuda.synchronize()
            assert fb.launches == before + (fn is fb.fused_bounce_keyed)
            runs.append((out.cpu().numpy(), win.cpu().numpy()))
        (k_out, k_win), (p_out, p_win) = runs
        np.testing.assert_array_equal(k_out.view(np.int32), p_out.view(np.int32))
        np.testing.assert_array_equal(k_win, p_win)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 70001])
def test_draw_kernel_matches_plain_on_gpu(n):
    """The draw kernel against ``sampling.bounce_draws`` on the same CUDA
    tensors and on the CPU, at scalar bounces (one whose ``bounce * 8 +
    purpose`` wraps past 2**32) and per-lane depths, roulette off and on:
    bit for bit (exact integer arithmetic)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from rust_pathtracer_tpu_torch import sampling
    from rust_pathtracer_tpu_torch.ops import draws

    lk = sampling.lane_keys(sampling.prng_key(21), torch.arange(n))
    keys = fb.key_words(lk).to("cuda")
    depth = torch.from_numpy(np.random.default_rng(n).integers(0, 64, n).astype(np.int32))
    for bounce in (0, 19, 2**29 + 5, depth):
        b_gpu = bounce.to("cuda") if isinstance(bounce, torch.Tensor) else bounce
        for rr in (False, True):
            before = draws.launches
            got = draws.bounce_draws(keys, b_gpu, rr)
            torch.cuda.synchronize()
            assert draws.launches == before + 1
            plain = draws.bounce_draws_plain(keys, b_gpu, rr)
            cpu = draws.bounce_draws(keys.cpu(), bounce, rr)
            for g, p, c in zip(got, plain, cpu):
                if c is None:
                    assert g is None and p is None
                    continue
                g = g.cpu().contiguous().numpy().view(np.int32)
                np.testing.assert_array_equal(g, p.cpu().numpy().view(np.int32))
                np.testing.assert_array_equal(g, c.numpy().view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 33, 3149, 1_000_000])
def test_lanes_kernel_matches_plain_on_gpu(n):
    """The lanes kernel against its plain twin on the same CUDA tensors,
    bit for bit in the key words, s_vp, t_vp and the disk (CUDA's sinf /
    cosf are what PyTorch's CUDA sin / cos run), at a 854x480 frame's
    pixels, at pixel ids past 2**32 and at counters that wrap past 2**32;
    the key words, s_vp and t_vp also equal the CPU's plain twin."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from rust_pathtracer_tpu_torch.ops import lanes
    from rust_pathtracer_tpu_torch.sampling import prng_key

    rng = np.random.default_rng(n)
    pixel = rng.integers(0, 854 * 480, n)
    sample = rng.integers(0, 2000, n)
    cases = ((pixel, 854, 480), (pixel + 2**33 + 5, 854, 2**28),
             (2**32 // 2000 + rng.integers(-n, n + 1, n), 4096, 2**20))
    for pix, w, h in cases:
        kw = dict(width=w, height=h, spp_total=2000)
        p_gpu, s_gpu = (torch.as_tensor(x, device="cuda") for x in (pix, sample))
        before = lanes.launches
        got = lanes.camera_lane_draws(prng_key(9, device="cuda"), p_gpu, s_gpu, **kw)
        torch.cuda.synchronize()
        assert lanes.launches == before + 1
        plain = lanes.camera_lane_draws_plain(prng_key(9, device="cuda"), p_gpu, s_gpu, **kw)
        cpu = lanes.camera_lane_draws(prng_key(9), torch.as_tensor(pix),
                                      torch.as_tensor(sample), **kw)
        for i, (g, p, c) in enumerate(zip(got, plain, cpu)):
            g = g.cpu().contiguous().numpy().view(np.int32)
            np.testing.assert_array_equal(g, p.cpu().contiguous().numpy().view(np.int32))
            if i < 3:  # the disk's sin / cos are the card's
                np.testing.assert_array_equal(g, c.contiguous().numpy().view(np.int32))


@pytest.mark.cuda
def test_regen_on_gpu_matches_cpu():
    """A 24x16 regen render of LightTest (K1 at per-lane depth) and of the
    image-textured scene (K3 and the draw kernel), 8 spp, 8 bounces,
    roulette from bounce 3, 256 lanes: on the card against the CPU under
    the image contract, and two renders on the card bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from rust_pathtracer_tpu_torch.camera import make_camera
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops import draws
    from rust_pathtracer_tpu_torch.render import RenderSettings
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.image import image_agreement
    from rust_pathtracer_tpu_torch.wavefront import render_radiance_regen

    b = SceneBuilder()
    b.add_sphere((0.0, 0.5, -3.0), 0.5, b.lambertian((0.4, 0.5, 0.6)))
    ramp = np.linspace(0.1, 0.9, 8 * 8 * 3).reshape(8, 8, 3).astype(np.float32)
    b.add_sphere((0.0, -100.0, -3.0), 100.0, b.lambertian(b.image_texture(ramp)))
    b.add_rect("xz", (-2.0, 4.0, -5.0), (2.0, 4.0, -1.0), -1.0,
               b.diffuse_light((5.0, 5.0, 5.0)))
    sd = get_scene("LightTest")
    cases = (("LightTest", sd.build(), sd.camera_at(0.0), (0.0, 0.0, 0.0)),
             ("image", b.build(use_bvh=False),
              make_camera((0.0, 1.0, 2.0), (0.0, 0.5, -3.0), (0.0, 1.0, 0.0), 50.0, 1.5,
                          0.0, 10.0), (0.1, 0.1, 0.1)))
    for name, scene, cam, bg in cases:
        s = RenderSettings(24, 16, 8, 8, bg, russian_roulette_start=3)
        imgs = {}
        for dev in ("cpu", "cuda", "cuda2"):
            before = (fb.launches, draws.launches)
            img, _ = render_radiance_regen(scene, cam, s, prng_key(5), lanes=256,
                                           device=dev[:4])
            imgs[dev] = img.cpu().numpy()
            if dev == "cuda":
                launched = (fb.launches - before[0], draws.launches - before[1])
                assert launched[0 if name == "LightTest" else 1] > 0, (name, launched)
        a = image_agreement(imgs["cuda"], imgs["cpu"])
        assert a["ok"], (name, a)
        np.testing.assert_array_equal(imgs["cuda"].view(np.int32),
                                      imgs["cuda2"].view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name,schedule", [
    (n, sched) for n, explicit in (("CornellBox", "6:2"), ("image", "3:2"),
                                   ("SphereField", "3:2,5:4"))
    for sched in (explicit, None, "auto")])
def test_cascade_on_gpu_matches_chunked(name, schedule):
    """The cascade on the card, explicit, dynamic (None) and "auto" (K1 on
    CornellBox, K3 and the draw kernel on the image-textured scene, K6
    and the draw kernel on SphereField; 48x32, 4 spp in 2 chunks, 10
    bounces) equals the chunked render on the card bit for bit, with the
    segments and the occupancy; and a checkpointed render stopped after
    one chunk resumes to the same image."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import dataclasses
    import tempfile

    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import (
        RenderSettings,
        _render_chunk_cascaded,
        render_radiance,
    )
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils import checkpoint as ck

    if name == "image":
        from rust_pathtracer_tpu_torch.camera import make_camera

        b = SceneBuilder()
        b.add_sphere((0.0, 0.5, -3.0), 0.5, b.lambertian((0.4, 0.5, 0.6)))
        ramp = np.linspace(0.1, 0.9, 8 * 8 * 3).reshape(8, 8, 3).astype(np.float32)
        b.add_sphere((0.0, -100.0, -3.0), 100.0, b.lambertian(b.image_texture(ramp)))
        b.add_rect("xz", (-2.0, 4.0, -5.0), (2.0, 4.0, -1.0), -1.0,
                   b.diffuse_light((5.0, 5.0, 5.0)))
        scene = b.build(use_bvh=False, device="cuda")
        cam = make_camera((0.0, 1.0, 2.0), (0.0, 0.5, -3.0), (0.0, 1.0, 0.0), 50.0, 1.5,
                          0.0, 10.0, device="cuda")
    else:
        sd = get_scene(name)
        scene, cam = sd.build(device="cuda"), sd.camera_at(0.0, device="cuda")
    key = prng_key(2, device="cuda")
    bg = {"CornellBox": (0.0, 0.0, 0.0), "image": (0.1, 0.1, 0.1)}.get(name, (1.0, 1.0, 1.0))
    s = RenderSettings(48, 32, 4, 10, bg, spp_chunk=2)
    ref, st0 = render_radiance(scene, cam, s, key, device="cuda")
    cs = dataclasses.replace(s, cascade=True, cascade_schedule=schedule)
    img, st = render_radiance(scene, cam, cs, key, device="cuda")
    assert torch.equal(img, ref) and torch.equal(st.segments, st0.segments)
    assert torch.equal(st.occupancy, st0.occupancy) and float(st.occupancy[-1]) == 0.0
    with tempfile.TemporaryDirectory() as tmp:
        path = f"{tmp}/part.npz"
        # the first chunk's sums (any cascade mode gives the chunked ones)
        acc, _ = _render_chunk_cascaded(scene, cam, key, 0, torch.tensor(bg, device="cuda"),
                                        width=48, height=32, spp_chunk=2, spp_total=4,
                                        max_bounces=10, rr_start=None,
                                        schedule=None if schedule == "auto" else schedule)
        ck.save_checkpoint(path, ck.RenderCheckpoint(
            acc=acc.cpu().numpy(), samples_done=2, width=48, height=32, spp_total=4,
            key_data=ck.key_data(key), segments=0.0))
        resumed, _ = ck.render_radiance_checkpointed(scene, cam, cs, key, path,
                                                     device="cuda")
    assert torch.equal(resumed, ref)


@pytest.mark.cuda
def test_sharded_render_on_gpu_matches_single_process(tmp_path):
    """Two gloo ranks on cuda:0 (one card, so gloo: NCCL refuses two
    ranks on one device), a (2, 1) mesh: every rank's image equals the
    single-process render on the card bit for bit (a samples axis of 1),
    with the segments."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from torch_spawn import run_ranks

    cfg = dict(width=48, height=32, samples_per_pixel=4, max_bounces=8,
               background=[0.0, 0.0, 0.0], spp_chunk=2)
    res = run_ranks("render", 2, tmp_path, timeout=300, device="cuda", jobs=[dict(
        mesh=[2, 1], scene="CornellBox", settings=cfg, key=5)])
    sd = get_scene("CornellBox")
    ref, st = render_radiance(sd.build(device="cuda"), sd.camera_at(0.0, device="cuda"),
                              RenderSettings(**dict(cfg, background=(0.0, 0.0, 0.0))),
                              prng_key(5, device="cuda"), device="cuda")
    for r in res:
        assert torch.equal(r["jobs"][0]["img"], ref.cpu())
        assert r["jobs"][0]["segments"] == float(st.segments)


@pytest.mark.cuda
def test_cli_animation_on_gpu_matches_cpu(tmp_path):
    """A 3-frame SphereField animation through the CLI (K6 and the draw
    kernel): each card frame's PNG is the card's ``render_radiance`` at
    the frame's camera, byte for byte, and the card's render of each
    frame holds the image contract against the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from rust_pathtracer_tpu_torch import cli
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.utils.image import (
        image_agreement,
        read_png,
        to_rgb8,
        write_png,
    )

    args = ["--scene", "SphereField", "--width", "48", "--height", "27", "--spp", "2",
            "--max-bounces", "6", "--frames", "3", "--quiet"]
    for dev in ("cuda", "cpu"):
        assert cli.main(args + ["--device", dev, "--output-dir", str(tmp_path / dev)]) == 0
    sd = get_scene("SphereField")
    s = RenderSettings(48, 27, 2, 6, (1.0, 1.0, 1.0))
    for f in range(3):
        name = f"image_{f:04d}.png"
        imgs = {}
        for dev in ("cuda", "cpu"):
            img, _ = render_radiance(sd.build(device=dev), sd.camera_at(f / 3, device=dev),
                                     s, prng_key(0, device=dev), device=dev)
            imgs[dev] = img.cpu().numpy()
            write_png(str(tmp_path / f"want_{dev}.png"), to_rgb8(imgs[dev]))
            got = open(str(tmp_path / dev / name), "rb").read()
            assert got == open(str(tmp_path / f"want_{dev}.png"), "rb").read(), (dev, f)
        agree = image_agreement(imgs["cuda"], imgs["cpu"])
        assert agree["ok"], (f, agree)
        assert read_png(str(tmp_path / "cuda" / name)).shape == (27, 48, 3)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 257, 70001])
def test_packed_kernels_match_plain_on_gpu(n):
    """The packed scheme (``rng_scheme="packed"``): K1 at a scalar bounce
    (residuals off and on) and at per-lane depths, and the draw kernel,
    against their packed plain versions on the same CUDA tensors, bit for
    bit; the draw kernel against the CPU's packed draws too."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from rust_pathtracer_tpu_torch.ops import draws

    scene = t_full_scene().to("cuda")
    cols, _ = _random_lanes(n, seed=38)
    state, keys = _keyed_inputs(cols, "cuda")
    depth = torch.as_tensor(np.random.default_rng(n).integers(0, 50, n).astype(np.int32),
                            device="cuda")
    table, bg = fb.pack_prims_shaded(scene), torch.tensor((0.2, 0.1, 0.05), device="cuda")
    kw = dict(with_roulette=True, rr_start=3, kinds=scene.kinds_static,
              mat_types=scene.mat_types, tex_types=scene.tex_types, t_min=T_MIN,
              rng_scheme="packed")
    for bounce, res in ((7, False), (7, True), (depth, False)):
        runs = []
        for fn in (fb.fused_bounce_keyed, fb.fused_bounce_keyed_plain):
            out = fn(table, bg, scene.textures.perlin_seed, state, keys, bounce, **kw,
                     want_residuals=res)
            out, r = out if res else (out, {})
            torch.cuda.synchronize()
            runs.append([out.cpu().numpy().view(np.int32)]
                        + [r[k].cpu().numpy().view(np.int32) for k in sorted(r)])
        for a, b in zip(*runs):
            np.testing.assert_array_equal(a, b)
    for bounce in (7, depth):
        got = draws.bounce_draws(keys, bounce, True, "packed")
        plain = draws.bounce_draws_plain(keys, bounce, True, "packed")
        b_cpu = bounce.cpu() if isinstance(bounce, torch.Tensor) else bounce
        cpu = draws.bounce_draws(keys.cpu(), b_cpu, True, "packed")
        for g, p, c in zip(got, plain, cpu):
            g = g.cpu().contiguous().numpy().view(np.int32)
            np.testing.assert_array_equal(g, p.cpu().contiguous().numpy().view(np.int32))
            np.testing.assert_array_equal(g, c.contiguous().numpy().view(np.int32))


@pytest.mark.cuda
def test_geometry_step_on_gpu_matches_cpu():
    """The geometry gradient (``diff_t="rederive"``, ``prims.data`` a
    leaf) of a small TwoSphereCheckers step on the card (K4 once a
    bounce) against the CPU: the loss within 2e-3 relative, the
    prims.data gradient within rtol 0.05 and 2e-3 of its largest, bit for
    bit the same on a second run on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import dataclasses

    from rust_pathtracer_tpu_torch.grad import CameraParams, DiffParams, render_loss_and_grad
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.render import RenderSettings
    from rust_pathtracer_tpu_torch.sampling import prng_key

    settings = RenderSettings(16, 9, 4, 6, (1.0, 1.0, 1.0), diff_t="rederive")
    out = {}
    for dev in ("cpu", "cuda", "cuda2"):
        scene = get_scene("TwoSphereCheckers").build(device=dev[:4])
        data = scene.prims.data.clone().requires_grad_(True)
        scene = dataclasses.replace(scene, prims=dataclasses.replace(scene.prims, data=data))
        cam = CameraParams.create((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0),
                                  20.0, 854.0 / 480.0, 0.0, 10.0, device=dev[:4])
        params = DiffParams.from_scene(scene, cam, settings.background)
        before = ch.hit_launches
        loss, _ = render_loss_and_grad(params, scene, settings, prng_key(0, device=dev[:4]),
                                       torch.zeros(9, 16, 3), device=dev[:4])
        if dev != "cpu":
            assert ch.hit_launches - before == settings.max_bounces
        out[dev] = (loss.cpu(), data.grad.cpu())
    (l0, g0), (l1, g1), (l2, g2) = out["cpu"], out["cuda"], out["cuda2"]
    np.testing.assert_allclose(float(l1), float(l0), rtol=2e-3)
    assert np.abs(g0.numpy()).max() > 0 and torch.isfinite(g1).all()
    np.testing.assert_allclose(g1.numpy(), g0.numpy(), rtol=0.05,
                               atol=2e-3 * np.abs(g0.numpy()).max())
    assert torch.equal(l1, l2) and torch.equal(g1, g2)


def _sphere_cloud(n, seed):
    """n random spheres, no BVH: projected tables of ceil(n / 128) clusters."""
    rng = np.random.default_rng(seed)
    b = SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for _ in range(n):
        b.add_sphere(rng.uniform(-12, 12, 3), rng.uniform(0.3, 0.9), m)
    return b.build(use_bvh=False)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 255, 257, 70001])
def test_passset_kernel_matches_plain_on_gpu(n):
    """The pass-set key kernel against ``passset_sort_keys_plain`` on the
    same CUDA tensors and on the CPU, on tables of 5 and 40 clusters and
    on two flawed copies of the 40 (cluster 3's x faces swapped, an
    inverted box; +inf, NaN and -inf bounds), with dead lanes, parked
    origins, zero, NaN and infinite direction components and infinite
    and NaN origins: bit for bit, and ``passset_perm`` the permutation of
    the plain keys."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import dataclasses

    from rust_pathtracer_tpu_torch.ops import passset
    from rust_pathtracer_tpu_torch.ops import projected as P

    rng = np.random.default_rng(n)
    o = rng.uniform(-14, 14, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[::11, 1] = 0.0
    d[7::97, 0] = np.nan
    d[9::41, 2] = np.inf
    o[3::13] = 3.0e33
    o[4::43, 1] = -np.inf
    o[6::47, 0] = np.nan
    alive = rng.random(n) > 1.0 / 3.0
    words2 = _sphere_cloud(40 * 128, 3).proj
    unordered, nonfinite = words2.cluster_bounds.clone(), words2.cluster_bounds.clone()
    unordered[[0, 3], 3] = unordered[[3, 0], 3]
    nonfinite[4, 5], nonfinite[2, 7], nonfinite[0, 9] = np.inf, np.nan, -np.inf
    for proj in (_sphere_cloud(600, 44).proj, words2,
                 dataclasses.replace(words2, cluster_bounds=unordered),
                 dataclasses.replace(words2, cluster_bounds=nonfinite)):
        cpu = [torch.from_numpy(x) for x in (o, d, alive)]
        gpu = [x.to("cuda") for x in cpu]
        tables = proj.to("cuda")
        before = passset.launches
        got = passset.passset_keys(tables, *gpu, T_MIN)
        torch.cuda.synchronize()
        assert passset.launches == before + 1
        plain = P.passset_sort_keys_plain(tables, *gpu, T_MIN)
        assert torch.equal(got, plain)
        assert torch.equal(got.cpu(), P.passset_sort_keys_plain(proj, *cpu, T_MIN))
        assert torch.equal(P.passset_perm(tables, *gpu, T_MIN), P.sort_by_words(plain))


@pytest.mark.cuda
def test_reorder_on_gpu_bit_identical():
    """SphereField on the card, 48x32, 4 spp, 10 bounces: the chunked
    render and a static cascade whose "1:1" boundary regroups by pass-set
    with the reorder equal them without it bit for bit (image, segments,
    occupancy), the key kernel launched; regen with and without within
    2e-7 (SphereField's pixels stay at most 1), equal segments."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import dataclasses

    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops import passset
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.wavefront import render_radiance_regen

    sd = get_scene("SphereField")
    scene, cam = sd.build(device="cuda"), sd.camera_at(0.0, device="cuda")
    key = prng_key(2, device="cuda")
    s = RenderSettings(48, 32, 4, 10, (1.0, 1.0, 1.0))
    for kw in ({}, {"cascade_schedule": "1:1,3:2"}):
        runs = []
        for reorder in (False, None):
            before = passset.launches
            img, st = render_radiance(scene, cam, dataclasses.replace(s, reorder=reorder,
                                                                      **kw),
                                      key, device="cuda")
            runs.append((img, st, passset.launches - before))
        (a, sa, na), (b, sb, nb) = runs
        assert na == 0 < nb, kw
        assert torch.equal(a, b) and torch.equal(sa.segments, sb.segments), kw
        assert torch.equal(sa.occupancy, sb.occupancy), kw
    regen = [render_radiance_regen(scene, cam, dataclasses.replace(s, reorder=r), key,
                                   lanes=1024, device="cuda") for r in (False, True)]
    (a, sa), (b, sb) = regen
    assert float((a - b).abs().max()) <= 2e-7 and float(b.max()) <= 1.0
    assert torch.equal(sa.segments, sb.segments) and torch.equal(sa.occupancy, sb.occupancy)


@pytest.mark.cuda
def test_bf16_and_diff_cascade_on_gpu():
    """The image-textured scene's step on the card, 64x64, 8 spp, 4
    bounces: under remat "bf16" the loss is remat "none"'s bit for bit and
    the gradient within (1e-7, 1e-2) normalised; through the
    differentiable cascade "2:2,3:4" no lane is dropped, the loss within
    1e-6 and every gradient within rtol 1e-3 / atol 1e-7."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from rust_pathtracer_tpu_torch.grad import CameraParams, DiffParams, render_loss_and_grad
    from rust_pathtracer_tpu_torch.render import RenderSettings
    from rust_pathtracer_tpu_torch.sampling import prng_key

    b = SceneBuilder()
    b.add_sphere((0.0, 0.5, -3.0), 0.5, b.lambertian((0.4, 0.5, 0.6)))
    ramp = np.linspace(0.1, 0.9, 8 * 8 * 3).reshape(8, 8, 3).astype(np.float32)
    b.add_sphere((0.0, -100.0, -3.0), 100.0, b.lambertian(b.image_texture(ramp)))
    b.add_rect("xz", (-2.0, 4.0, -5.0), (2.0, 4.0, -1.0), -1.0,
               b.diffuse_light((5.0, 5.0, 5.0)))
    scene = b.build(use_bvh=False, device="cuda")
    bg = (0.1, 0.1, 0.1)
    params = DiffParams.from_scene(scene, CameraParams.create(
        (0.0, 1.0, 2.0), (0.0, 0.5, -3.0), (0.0, 1.0, 0.0), 50.0, 1.0, device="cuda"), bg)
    out = {}
    for label, kw in (("none", {}), ("bf16", {"remat": "bf16"}),
                      ("cascade", {"diff_cascade": "2:2,3:4"})):
        loss, g = render_loss_and_grad(params, scene, RenderSettings(64, 64, 8, 4, bg, **kw),
                                       prng_key(0, device="cuda"),
                                       torch.zeros(64, 64, 3, device="cuda"), device="cuda")
        out[label] = (float(loss), [x.cpu().numpy() for x in g.leaves()])
    l0, g0 = out["none"]
    f0 = np.concatenate([x.ravel() for x in g0]).astype(np.float64)
    l1, g1 = out["bf16"]
    f1 = np.concatenate([x.ravel() for x in g1]).astype(np.float64)
    assert l1 == l0
    assert 1e-7 < np.linalg.norm(f1 - f0) / np.linalg.norm(f0) < 1e-2
    l2, g2 = out["cascade"]
    np.testing.assert_allclose(l2, l0, rtol=1e-6)
    for a, b_ in zip(g2, g0):
        np.testing.assert_allclose(a, b_, rtol=1e-3, atol=1e-7)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["spherefield", "mixed"])
def test_shade_kernel_matches_plain_on_gpu(name):
    """The shade kernel against its plain twin (the tensor ops) on the same
    CUDA tensors, bit for bit on every lane: ``test_torch_shade_emu.py``'s
    lanes (SphereField's table, and the mixed table with a light), the
    search K6 on the card; roulette off, on, and on a lane mask."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from test_torch_shade_emu import BG, _inputs, _scene

    from rust_pathtracer_tpu_torch import integrator
    from rust_pathtracer_tpu_torch.integrator import PARKED_ORIGIN
    from rust_pathtracer_tpu_torch.ops import projected as P
    from rust_pathtracer_tpu_torch.ops import shade

    scene = _scene(name).to("cuda")
    state, _, draws, rr_u, rr_sel = _inputs(scene.to("cpu"), name, seed=7)
    state = tuple(x.cuda() for x in state)
    draws = {k: v.cuda() for k, v in draws.items()}
    o_live = torch.where(state[4][:, None], state[0], torch.full_like(state[0], PARKED_ORIGIN))
    search = P.closest_hit_routed(scene.proj, o_live, state[1], T_MIN)
    bg = torch.tensor(BG, device="cuda")
    for rr, sel in ((None, None), (rr_u.cuda(), None), (rr_u.cuda(), rr_sel.cuda())):
        before = shade.launches
        got = shade.shade_bounce(scene, search, state, draws, bg, rr, sel)
        assert shade.launches - before == 1
        want = integrator.shade_bounce_plain(scene, search, state, draws, bg, rr, sel)
        for what, g, w in zip(("o", "d", "thr", "rad", "alive"), got, want):
            assert torch.equal(g.view(torch.int32) if g.is_floating_point() else g,
                               w.view(torch.int32) if w.is_floating_point() else w), what


@pytest.mark.cuda
def test_shade_kernel_frames_on_gpu_match_tensor_ops(monkeypatch):
    """SphereField frames on the card through the shade kernel (one launch
    a bounce) against the same frames on the tensor ops (the predicate
    turned off), bit for bit: image, segments and occupancy of the chunked
    render with the reorder, with roulette from bounce 3, and the regen
    wavefront."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import dataclasses

    from rust_pathtracer_tpu_torch import integrator
    from rust_pathtracer_tpu_torch.models import get_scene
    from rust_pathtracer_tpu_torch.ops import shade
    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
    from rust_pathtracer_tpu_torch.sampling import prng_key
    from rust_pathtracer_tpu_torch.wavefront import render_radiance_regen

    sd = get_scene("SphereField")
    scene, cam = sd.build(device="cuda"), sd.camera_at(0.0, device="cuda")
    key = prng_key(3, device="cuda")
    s = RenderSettings(96, 54, 4, 12, (0.8, 0.9, 1.0))
    for label, kw in (("chunked", {}), ("roulette", {"russian_roulette_start": 3}),
                      ("regen", {"russian_roulette_start": 3})):
        st = dataclasses.replace(s, **kw)
        runs = []
        for ok in (True, False):
            if not ok:
                monkeypatch.setattr(integrator, "shade_kernel_ok", lambda *a, **k: False)
            before = shade.launches
            if label == "regen":
                img, stats = render_radiance_regen(scene, cam, st, key, lanes=4096,
                                                   device="cuda")
            else:
                img, stats = render_radiance(scene, cam, st, key, device="cuda")
            n = shade.launches - before
            if ok and label != "regen":
                assert n == stats.bounces > 0, (label, n, stats.bounces)
            assert (n > 0) == ok, label
            runs.append((img, stats))
        monkeypatch.undo()
        (a, sa), (b, sb) = runs
        assert torch.equal(a, b), label
        assert torch.equal(sa.segments, sb.segments), label
        assert torch.equal(sa.occupancy, sb.occupancy), label
