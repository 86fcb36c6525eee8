"""K1's in-kernel draws: the keyed bounce against the hoisted uniforms.

The keyed K1 (``fused_bounce_keyed``) takes each lane's threefry key and
the bounce index and draws the bounce's uniforms itself, then applies
russian roulette; the fused route no longer hoists the draws
(``integrator._precompute_draws``).  Threefry is exact integer
arithmetic, so every comparison here is BIT FOR BIT:

* the keyed plain bounce against ``_precompute_draws`` followed by the
  uniforms-in plain bounce and ``roulette`` (the fused route's parent
  form), at bounces 0, 7 and 19, roulette and residuals on and off;
* the keyed plain bounce at per-lane depth (the regen wavefront's)
  against ``sampling.bounce_draws`` at those depths, the uniforms-in
  plain bounce and roulette on the lanes at depth ``rr_start`` or more,
  and against the scalar keyed bounce at each depth, lane by lane;
* ``trace`` and ``render_loss_and_grad`` on CornellBox against the same
  run with the bounce swapped for that hoisted form;
* ``ops/csrc/threefry.cuh`` (the kernel's draws), compiled for the host
  with g++, against ``sampling``'s stream.

The kernel itself is held against the keyed plain version by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the card.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from rust_pathtracer_tpu_torch import integrator, sampling
from rust_pathtracer_tpu_torch.grad import CameraParams, DiffParams, render_loss_and_grad
from rust_pathtracer_tpu_torch.integrator import T_MIN, _precompute_draws, trace
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
from rust_pathtracer_tpu_torch.ops._build import CSRC
from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
from test_torch_cuda import _random_lanes, t_full_scene

torch.set_num_threads(2)

CORNELL_CAM = ((278.0, 278.0, -800.0), (278.0, 278.0, 0.0), (0.0, 1.0, 0.0),
               40.0, 1.0, 0.0, 10.0)


def _bits(x):
    return x.numpy().view(np.int32)


def _assert_bits_equal(a, b, what):
    assert set(a) == set(b), what
    for k in a:
        np.testing.assert_array_equal(_bits(a[k]), _bits(b[k]), err_msg=f"{what}: {k}")


def hoisted_bounce(table, bg, seed, state, keys, bounce, *, with_roulette, kinds,
                   mat_types, tex_types, t_min, winner_out=None, want_residuals=False):
    """The fused route's bounce as it was before the keyed K1: the hoisted
    draws of ``_precompute_draws`` into the uniforms-in bounce, then
    ``roulette``, with the roulette's residuals as the keyed bounce
    returns them."""
    lk = fb._lane_keys(keys)
    rr_start = bounce if with_roulette else bounce + 1
    dr = _precompute_draws(lk, bounce + 1, rr_start, start_bounce=bounce)
    su, bu = dr["sphere_u"][0], dr["ball_u"][0]
    out = fb.fused_bounce_cols_plain(
        table, bg, seed, fb.state_cols(state), su[:, 0], su[:, 1], bu[:, 0],
        bu[:, 1], bu[:, 2], dr["coin"][0], kinds=kinds, mat_types=mat_types,
        tex_types=tex_types, t_min=t_min, winner_out=winner_out,
        want_residuals=want_residuals)
    out, res = out if want_residuals else (out, None)
    if with_roulette:
        out, p, act = fb.roulette(out, dr["roulette"][0])
        if want_residuals:
            res = dict(res, rr_p=p,
                       flags=res["flags"] | act.to(torch.int32) * fb.FLG_RR_ACT)
    out = torch.stack([out[k] for k in fb._COL_KEYS])
    return (out, res) if want_residuals else out


@pytest.mark.parametrize("want_residuals", [False, True])
@pytest.mark.parametrize("with_roulette", [False, True])
@pytest.mark.parametrize("bounce", [0, 7, 19])
def test_keyed_plain_equals_hoisted_draws(bounce, with_roulette, want_residuals):
    """1024 lanes of the every-kind scene: the 13 columns, the winners and
    every residual plane and flag bit for bit; roulette kills and boosts
    some lanes."""
    scene = t_full_scene()
    cols, _ = _random_lanes(1024, seed=31 + bounce)
    keys = fb.key_words(sampling.lane_keys(sampling.prng_key(11), torch.arange(1024)))
    args = (fb.pack_prims_shaded(scene), torch.tensor((0.2, 0.1, 0.05)),
            scene.textures.perlin_seed, torch.from_numpy(cols), keys, bounce)
    kw = dict(with_roulette=with_roulette, kinds=scene.kinds_static,
              mat_types=scene.mat_types, tex_types=scene.tex_types, t_min=T_MIN,
              want_residuals=want_residuals)
    wins = [torch.empty(1024, dtype=torch.int32) for _ in range(2)]
    got = fb.fused_bounce_keyed_plain(*args, **kw, winner_out=wins[0])
    want = hoisted_bounce(*args, **kw, winner_out=wins[1])
    if want_residuals:
        (got, got_res), (want, want_res) = got, want
        _assert_bits_equal(got_res, want_res, "residuals")
        assert ("rr_p" in got_res) == with_roulette
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert torch.equal(wins[0], wins[1])
    alive_in = cols[12] > 0.5
    cont = alive_in & (wins[0].numpy() >= 0)
    if with_roulette:  # roulette ran: some continuing lanes died
        assert (got[12].numpy() > 0.5).sum() < cont.sum()


@pytest.mark.parametrize("with_roulette", [False, True])
def test_keyed_plain_per_lane_depth(with_roulette):
    """1024 lanes of the every-kind scene at random depths 0-49, roulette
    from depth 3: the 13 columns and the winners bit for bit against (a)
    ``sampling.bounce_draws`` at the lanes' depths, the uniforms-in plain
    bounce and per-lane roulette, and (b) for each depth, the scalar keyed
    bounce of that depth (roulette where the depth is 3 or more) on the
    same lanes."""
    scene = t_full_scene()
    n, rr_start = 1024, 3
    cols, _ = _random_lanes(n, seed=41)
    state = torch.from_numpy(cols)
    lk = sampling.lane_keys(sampling.prng_key(12), torch.arange(n))
    keys = fb.key_words(lk)
    depth = torch.from_numpy(np.random.default_rng(4).integers(0, 50, n).astype(np.int32))
    table, bg = fb.pack_prims_shaded(scene), torch.tensor((0.2, 0.1, 0.05))
    kw = dict(kinds=scene.kinds_static, mat_types=scene.mat_types,
              tex_types=scene.tex_types, t_min=T_MIN)
    win = torch.empty(n, dtype=torch.int32)
    got = fb.fused_bounce_keyed(table, bg, scene.textures.perlin_seed, state, keys, depth,
                                with_roulette=with_roulette, rr_start=rr_start,
                                winner_out=win, **kw)

    su, bu, coin, rl = sampling.bounce_draws(lk, depth.long(), with_roulette)
    want = fb.fused_bounce_cols_plain(
        table, bg, scene.textures.perlin_seed, fb.state_cols(state), su[:, 0], su[:, 1],
        bu[:, 0], bu[:, 1], bu[:, 2], coin, **kw)
    if with_roulette:
        want, _, act = fb.roulette(want, rl, depth >= rr_start)
        assert act.any() and (act & (depth < rr_start)).sum() == 0
    want = torch.stack([want[k] for k in fb._COL_KEYS])
    np.testing.assert_array_equal(_bits(got), _bits(want))

    for b in torch.unique(depth).tolist():
        sel = depth == b
        w = torch.empty(int(sel.sum()), dtype=torch.int32)
        one = fb.fused_bounce_keyed_plain(
            table, bg, scene.textures.perlin_seed, state[:, sel].contiguous(),
            keys[:, sel].contiguous(), b, with_roulette=with_roulette and b >= rr_start,
            winner_out=w, **kw)
        np.testing.assert_array_equal(_bits(got[:, sel]), _bits(one), err_msg=f"depth {b}")
        assert torch.equal(win[sel], w)
    with pytest.raises(ValueError, match="forward only"):
        fb.fused_bounce_keyed(table, bg, 0, state, keys, depth, with_roulette=False,
                              want_residuals=True, **kw)
    with pytest.raises(ValueError, match="per-lane"):
        fb.fused_bounce_keyed(table, bg, 0, state, keys, depth.long(),
                              with_roulette=False, **kw)


def test_keyed_wrapper_dispatch(monkeypatch):
    """CPU tensors take the keyed plain version (no launch is counted);
    the meta device, mixed devices and malformed keys raise; the key
    words round-trip."""
    scene = t_full_scene()
    cols, _ = _random_lanes(64, seed=3)
    state = torch.from_numpy(cols)
    lk = sampling.lane_keys(sampling.prng_key(2**32 - 1), torch.arange(64))
    keys = fb.key_words(lk)
    assert keys.shape == (2, 64) and keys.dtype == torch.int32 and keys.is_contiguous()
    assert torch.equal(fb._lane_keys(keys), lk) and (lk >= 2**31).any()
    table, bg = fb.pack_prims_shaded(scene), torch.tensor((0.1, 0.1, 0.1))
    kw = dict(with_roulette=True, kinds=scene.kinds_static, mat_types=scene.mat_types,
              tex_types=scene.tex_types, t_min=T_MIN)
    monkeypatch.setattr(fb, "launches", 0)
    out = fb.fused_bounce_keyed(table, bg, 0, state, keys, 3, **kw)
    ref = fb.fused_bounce_keyed_plain(table, bg, 0, state, keys, 3, **kw)
    np.testing.assert_array_equal(_bits(out), _bits(ref))
    assert fb.launches == 0
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fb.fused_bounce_keyed(table.to("meta"), bg.to("meta"), 0, state.to("meta"),
                              keys.to("meta"), 3, **kw)
    with pytest.raises(ValueError, match="state"):
        fb.fused_bounce_keyed(table, bg, 0, state.to("meta"), keys, 3, **kw)
    with pytest.raises(ValueError, match="state"):
        fb.fused_bounce_keyed(table, bg, 0, state[:12], keys, 3, **kw)
    with pytest.raises(ValueError, match="int32"):
        fb.fused_bounce_keyed(table, bg, 0, state, keys.long(), 3, **kw)
    with pytest.raises(ValueError, match="int32"):
        fb.fused_bounce_keyed(table, bg, 0, state, keys[:, :5], 3, **kw)
    with pytest.raises(ValueError, match="bounce"):
        fb.fused_bounce_keyed(table, bg, 0, state, keys, -1, **kw)


@pytest.fixture
def hoisted_route(monkeypatch):
    """The fused route with its bounce swapped for ``hoisted_bounce``, in
    the forward loop and in the whole-scan autograd.Function."""
    def use():
        monkeypatch.setattr(integrator, "fused_bounce_keyed", hoisted_bounce)
        monkeypatch.setattr(fb, "fused_bounce_keyed", hoisted_bounce)
    return use


@pytest.mark.parametrize("rr", [None, 3])
def test_trace_bit_identical_to_hoisted_draws(rr, hoisted_route):
    """``trace`` on CornellBox's lanes: radiance and statistics."""
    sd = get_scene("CornellBox")
    scene = sd.build()
    lanes = 12 * 12 * 2
    o = torch.tensor([[278.0, 278.0, -800.0]]).expand(lanes, 3).contiguous()
    ang = torch.linspace(-0.3, 0.3, lanes)
    d = torch.stack([torch.sin(ang), 0.2 * torch.cos(3 * ang), torch.cos(ang)], 1)
    lk = sampling.lane_keys(sampling.prng_key(3), torch.arange(lanes))
    runs = []
    for _ in range(2):
        rad, st = trace(scene, o, d, lk, (0.1, 0.2, 0.3), 12, russian_roulette_start=rr)
        runs.append((rad, st))
        hoisted_route()
    (r0, s0), (r1, s1) = runs
    np.testing.assert_array_equal(_bits(r0), _bits(r1))
    assert s0.bounces == s1.bounces and torch.equal(s0.occupancy, s1.occupancy)
    assert float(s0.segments) == float(s1.segments) > lanes


@pytest.mark.parametrize("rr", [None, 4])
def test_loss_and_grad_bit_identical_to_hoisted_draws(rr, hoisted_route):
    """``render_loss_and_grad`` on CornellBox 12x12, 2 spp, 8 bounces:
    the loss and every gradient leaf."""
    scene = get_scene("CornellBox").build()
    settings = RenderSettings(12, 12, 2, 8, (0.5, 0.5, 0.5), spp_chunk=2,
                              russian_roulette_start=rr)
    params = DiffParams.from_scene(scene, CameraParams.create(*CORNELL_CAM),
                                   settings.background)
    target = torch.full((12, 12, 3), 0.2)
    runs = []
    for _ in range(2):
        runs.append(render_loss_and_grad(params, scene, settings, sampling.prng_key(7),
                                         target, device="cpu"))
        hoisted_route()
    (l0, g0), (l1, g1) = runs
    assert float(l0) == float(l1)
    for a, b in zip(g0.leaves(), g1.leaves()):
        np.testing.assert_array_equal(_bits(a.detach()), _bits(b.detach()))
    assert torch.cat([x.reshape(-1) for x in g0.leaves()]).abs().max() > 0


def test_fused_route_draws_nothing_hoisted(monkeypatch):
    """No route calls ``_precompute_draws``: the fused route, forward and
    differentiable, draws inside K1; the generic route (TwoSphereCheckers'
    perlin marble, differentiable) draws with ``bounce_draws`` once a
    bounce."""
    calls = []

    def spy(name, fn):
        def counted(*a, **k):
            calls.append(name)
            return fn(*a, **k)
        return counted

    monkeypatch.setattr(integrator, "_precompute_draws",
                        spy("hoisted", integrator._precompute_draws))
    monkeypatch.setattr(integrator, "bounce_draws", spy("kernel", integrator.bounce_draws))
    for name, diff, want in (("CornellBox", False, 0), ("CornellBox", True, 0),
                             ("TwoSphereCheckers", False, 0),
                             ("TwoSphereCheckers", True, 3)):
        calls.clear()
        sd = get_scene(name)
        settings = RenderSettings(6, 4, 1, 3, (0.3, 0.3, 0.3), differentiable=diff,
                                  russian_roulette_start=1)
        img, _ = render_radiance(sd.build(), sd.camera_at(0.0), settings,
                                 sampling.prng_key(1), device="cpu")
        assert torch.isfinite(img).all() and calls == ["kernel"] * want, (name, diff, calls)


_HOST_DRAWS = r"""
#include "threefry.cuh"
extern "C" void draws(const uint32_t* keys, long n, uint32_t bounce,
                      uint32_t purpose, int count, float* out) {
  for (long j = 0; j < n; ++j) {
    uint32_t p0, p1;
    rpt::bounce_key(keys[2 * j], keys[2 * j + 1], bounce, purpose, p0, p1);
    for (int i = 0; i < count; ++i) out[j * count + i] = rpt::uniform_at(p0, p1, i);
  }
}
"""


def test_threefry_header_matches_sampling(tmp_path):
    """The kernel's draws (``ops/csrc/threefry.cuh``, compiled for the
    host with g++) against ``sampling``: every purpose K1 draws, at
    bounces 0, 7, 19 and one whose ``bounce * 8 + purpose`` wraps past
    2**32, bit for bit."""
    cxx = shutil.which("g++")
    if cxx is None:
        pytest.skip("needs g++ to compile the header for the host")
    src, lib_path = tmp_path / "draws.cpp", tmp_path / "draws.so"
    src.write_text(_HOST_DRAWS)
    subprocess.run([cxx, "-O2", "-std=c++17", "-Wall", "-shared", "-fPIC",
                    f"-I{CSRC}", "-o", str(lib_path), str(src)], check=True)
    lib = ctypes.CDLL(str(lib_path))
    n = 4096
    lk = sampling.lane_keys(sampling.prng_key(9), torch.arange(n))
    words = np.ascontiguousarray(lk.numpy().astype(np.uint32))
    purposes = ((sampling.P_LAMBERT, 2), (sampling.P_FUZZ, 3), (sampling.P_SCHLICK, 1),
                (sampling.P_ROULETTE, 1))
    for bounce in (0, 7, 19, 2**29 + 5):
        for purpose, count in purposes:
            out = np.empty((n, count), np.float32)
            lib.draws(words.ctypes.data_as(ctypes.c_void_p), ctypes.c_long(n),
                      ctypes.c_uint32(bounce), ctypes.c_uint32(purpose), count,
                      out.ctypes.data_as(ctypes.c_void_p))
            want = sampling._uniforms(sampling.bounce_keys(lk, bounce, purpose), count)
            np.testing.assert_array_equal(out.view(np.int32), _bits(want),
                                          err_msg=f"bounce {bounce} purpose {purpose}")
