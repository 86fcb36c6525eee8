"""The camera lanes' kernel (``ops/lanes.py``, ``ops/csrc/lanes.cu``) on the CPU.

* ``render.camera_lanes`` on the wrapper (its plain twin on CPU tensors)
  against the lanes as the port made them before the kernel (the
  sampling module's threefry, then ``camera_rays``), bit for bit: keys,
  origins and directions, for chunks and for the regen spawn's ids in
  both orders;
* against JAX's ``render._make_lanes`` and the regen ``spawn`` formulas
  (``rust_pathtracer_tpu/wavefront.py:148-171``) on the same seed, as
  ``test_torch_scene.py::test_make_lanes_close`` holds them: keys bit for
  bit, rays within rtol 1e-6 / atol 1e-6;
* ``camera.camera_rays_from_disk`` after the plain disk against
  ``camera_rays``, and the camera-parameter gradients of small
  differentiable CornellBox steps, bit for bit;
* ``ops/csrc/lanes.cu`` built with g++ against ``tests/cuda_emu.h``
  (one std::thread a CUDA thread, a card of 2 SMs), as it is and with one
  block an SM so that 2 blocks walk up to 13 tiles, against the plain
  twin: the key words, s_vp and t_vp bit for bit, the disk within
  DISK_ULPS (the host's libm cosf / sinf against PyTorch's CPU cos /
  sin), and in a copy with the cosine and sine taken out, r = sqrt(l0)
  and theta = 2 pi l1 bit for bit; at 0, 1, 31, 33 and 3,149 lanes, at
  counters that wrap past 2**32, at pixel ids past 2**32 (the kernel's
  64-bit division), and at the regen spawn's ids in both orders.

The kernel itself is held against its plain twin on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` (phase 46).
"""

import dataclasses
import re
import shutil
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_pathtracer_tpu import render as jrender
from rust_pathtracer_tpu import sampling as jsampling
from rust_pathtracer_tpu.camera import camera_rays as j_camera_rays
from rust_pathtracer_tpu.models import get_scene as j_get_scene
from rust_pathtracer_tpu_torch import render as trender
from rust_pathtracer_tpu_torch import sampling, wavefront
from rust_pathtracer_tpu_torch.camera import camera_rays, camera_rays_from_disk
from rust_pathtracer_tpu_torch.grad import CameraParams, DiffParams, render_loss_and_grad
from rust_pathtracer_tpu_torch.models import get_scene as t_get_scene
from rust_pathtracer_tpu_torch.ops import lanes
from rust_pathtracer_tpu_torch.ops._build import CSRC
from rust_pathtracer_tpu_torch.ops.fused_bounce import key_words
from rust_pathtracer_tpu_torch.render import RenderSettings
from rust_pathtracer_tpu_torch.sampling import prng_key
from rust_pathtracer_tpu_torch.vecmath import sqrt

torch.set_num_threads(2)

# the host's cosf / sinf against PyTorch's CPU cos / sin, times r: at most
# this many f32 ulps of the plain twin's disk coordinate apart
DISK_ULPS = 2
SEED = 1234


def _bits(x):
    return np.ascontiguousarray(x.detach().numpy()).view(np.int32)


def lanes_before(cam, base_key, pixel, sample, *, width, height, spp_total):
    """``render.camera_lanes`` as the port made the lanes before the kernel:
    the sampling module's threefry in tensor ops, then ``camera_rays``."""
    lkeys = sampling.lane_keys(base_key, (pixel * spp_total + sample) & 0xFFFFFFFF)
    jit_u = sampling.uniform2(sampling.bounce_keys(lkeys, 0, sampling.P_PIXEL_JITTER))
    col = (pixel % width).to(torch.float32)
    y = (height - 1 - pixel // width).to(torch.float32)
    u = (col + jit_u[:, 0]) / torch.tensor(width - 1.0, dtype=torch.float32)
    v = (y + jit_u[:, 1]) / torch.tensor(height - 1.0, dtype=torch.float32)
    o, d = camera_rays(cam, u, v, sampling.bounce_keys(lkeys, 0, sampling.P_LENS))
    return lkeys, o, d


def _assert_lanes_equal(got, want, what, names=("keys", "origins", "directions")):
    for g, w, name in zip(got, want, names):
        np.testing.assert_array_equal(np.ascontiguousarray(g.numpy()).view(np.uint8),
                                      np.ascontiguousarray(w.numpy()).view(np.uint8),
                                      err_msg=f"{what}: {name}")


def _frame(cam, width, height, spp, stripe, seed=SEED):
    """The fields of ``wavefront._Frame`` that ``_spawn`` reads."""
    return types.SimpleNamespace(cam=cam, key=prng_key(seed), width=width, height=height,
                                 spp=spp, npix=width * height, stripe=stripe)


def _spawn_ids(n, width, height, spp, stripe):
    """Work ids as the regen queue hands them out: the first fill, then a
    scattered refill near the end of the queue."""
    total = width * height * spp
    rng = np.random.default_rng(n)
    ids = np.concatenate([np.arange(min(n, total)), rng.integers(0, total, n)])
    if stripe:  # a stripe's first id: a multiple of the stripe length
        ids = ids - ids % 2
    return torch.from_numpy(ids.astype(np.int64))


# ---------------------------------------------------------------------------
# the wrapper and the lanes the port made before it
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,offset", [("CornellBox", 0), ("SphereField", 8)])
def test_make_lanes_bit_identical_to_before(name, offset):
    """A chunk's lanes, a padded final chunk too (samples 8-11 of 10):
    the wrapper's keys, origins and directions are the tensor-op lanes'
    bit for bit (SphereField's camera has a lens)."""
    w, h, spp_chunk, spp_total = 64, 36, 4, 10
    cam = t_get_scene(name).camera_at(0.0)
    pix = torch.arange(w * h, dtype=torch.int64)
    lk, o, d, in_range = trender._make_lanes(cam, prng_key(SEED), pix, offset, width=w,
                                             height=h, spp_chunk=spp_chunk,
                                             spp_total=spp_total)
    sample = (offset + torch.arange(spp_chunk)).repeat(w * h)
    want = lanes_before(cam, prng_key(SEED), torch.repeat_interleave(pix, spp_chunk), sample,
                        width=w, height=h, spp_total=spp_total)
    _assert_lanes_equal((lk, o, d), want, name)
    assert lk.dtype == torch.int64 and lk.shape == (w * h * spp_chunk, 2)
    assert int(in_range.sum()) == w * h * (2 if offset else 4)


@pytest.mark.parametrize("stripe", [False, True])
def test_spawn_bit_identical_to_before(stripe):
    """The regen spawn's lanes (``wavefront._spawn``, its ids decoded both
    ways before the kernel) are the tensor-op lanes' bit for bit; its key
    words are ``key_words`` of them, with no round trip."""
    w, h, spp = 64, 36, 4
    cam = t_get_scene("SphereField").camera_at(0.0)
    fr = _frame(cam, w, h, spp, stripe)
    wid = _spawn_ids(3149, w, h, spp, stripe)
    pixel, keys, state = wavefront._spawn(fr, wid)
    if stripe:
        want_pixel, sample = wid // spp, wid % spp
    else:
        want_pixel, sample = wid % (w * h), wid // (w * h)
    lk, o, d = lanes_before(cam, prng_key(SEED), want_pixel, sample, width=w, height=h,
                            spp_total=spp)
    assert torch.equal(pixel, want_pixel)
    assert keys.dtype == torch.int32 and keys.shape == (2, wid.shape[0])
    np.testing.assert_array_equal(_bits(keys), _bits(key_words(lk)))
    _assert_lanes_equal((state[0:3].T, state[3:6].T), (o, d), "spawn",
                        ("origins", "directions"))
    assert torch.equal(state[6:9], torch.ones(3, wid.shape[0]))
    assert torch.equal(state[9:12], torch.zeros(3, wid.shape[0]))
    assert torch.equal(state[12], torch.ones(wid.shape[0]))


def test_words_are_key_words():
    cam = t_get_scene("CornellBox").camera_at(0.0)
    pixel = torch.arange(500, dtype=torch.int64) * 7
    sample = torch.arange(500, dtype=torch.int64) % 3
    kw = dict(width=40, height=90, spp_total=3)
    lk, o, d = trender.camera_lanes(cam, prng_key(3), pixel, sample, **kw)
    words, o2, d2 = trender.camera_lanes(cam, prng_key(3), pixel, sample, words=True, **kw)
    np.testing.assert_array_equal(_bits(words), _bits(key_words(lk)))
    assert torch.equal(o, o2) and torch.equal(d, d2)


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,offset", [("CornellBox", 0), ("TwoSphereCheckers", 8),
                                         ("SphereField", 4)])
def test_make_lanes_matches_jax(name, offset):
    """JAX's ``render._make_lanes`` on the same seed: keys and in_range
    equal, rays within rtol 1e-6 / atol 1e-6."""
    w, h, spp_chunk, spp_total = 64, 36, 4, 10
    pix = np.arange(w * h, dtype=np.uint32)
    jl = jrender._make_lanes(j_get_scene(name).camera_at(0.0),
                             jnp.asarray([0, SEED], jnp.uint32), jnp.asarray(pix),
                             jnp.uint32(offset), width=w, height=h, spp_chunk=spp_chunk,
                             spp_total=spp_total)
    tl = trender._make_lanes(t_get_scene(name).camera_at(0.0), prng_key(SEED),
                             torch.from_numpy(pix.astype(np.int64)), offset, width=w,
                             height=h, spp_chunk=spp_chunk, spp_total=spp_total)
    np.testing.assert_array_equal(tl[0].numpy(), np.asarray(jl[0]).astype(np.int64))
    np.testing.assert_allclose(tl[1].numpy(), np.asarray(jl[1]), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tl[2].numpy(), np.asarray(jl[2]), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(tl[3].numpy(), np.asarray(jl[3]))


def j_spawn(cam, key, work_id, *, width, height, spp, stripe):
    """JAX's regen ``spawn`` (rust_pathtracer_tpu/wavefront.py:148-171)
    on its own: the closure there is not reachable from outside."""
    wid = jnp.maximum(work_id, 0).astype(jnp.uint32)
    if stripe:
        pixel, sample = wid // np.uint32(spp), wid % np.uint32(spp)
    else:
        npix = width * height
        pixel, sample = wid % np.uint32(npix), wid // np.uint32(npix)
    counter = pixel * np.uint32(spp) + sample
    lkeys = jsampling.lane_keys(key, counter)
    jit_u = jsampling.uniform2(jsampling.bounce_keys(lkeys, 0, jsampling.P_PIXEL_JITTER))
    col = (pixel % np.uint32(width)).astype(jnp.float32)
    y = (height - 1 - pixel // np.uint32(width)).astype(jnp.float32)
    u = (col + jit_u[:, 0]) / (width - 1.0)
    v = (y + jit_u[:, 1]) / (height - 1.0)
    o, d = j_camera_rays(cam, u, v, jsampling.bounce_keys(lkeys, 0, jsampling.P_LENS))
    return pixel.astype(jnp.int32), lkeys, o, d


@pytest.mark.parametrize("stripe", [False, True])
def test_spawn_matches_jax(stripe):
    w, h, spp = 64, 36, 4
    wid = _spawn_ids(3149, w, h, spp, stripe)
    jp, jk, jo, jd = j_spawn(j_get_scene("SphereField").camera_at(0.0),
                             jnp.asarray([0, SEED], jnp.uint32), jnp.asarray(wid.numpy()),
                             width=w, height=h, spp=spp, stripe=stripe)
    pixel, keys, state = wavefront._spawn(
        _frame(t_get_scene("SphereField").camera_at(0.0), w, h, spp, stripe), wid)
    np.testing.assert_array_equal(pixel.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(_bits(keys.T.contiguous()),
                                  np.asarray(jk).view(np.int32))
    np.testing.assert_allclose(state[0:3].T.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(state[3:6].T.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the camera's affine part and its gradients
# ---------------------------------------------------------------------------


def test_camera_rays_from_disk_matches_camera_rays():
    rng = np.random.default_rng(5)
    s, t = (torch.from_numpy(x) for x in rng.random((2, 4000)).astype(np.float32))
    keys = torch.from_numpy(rng.integers(0, 2**32, (4000, 2), dtype=np.int64))
    cam = t_get_scene("SphereField").camera_at(0.3)  # a lens of aperture 0.1
    assert float(cam.lens_radius) > 0
    disk = sampling.in_unit_disk_xy(keys)
    got = camera_rays_from_disk(cam, s, t, disk[:, :2])
    for g, w in zip(got, camera_rays(cam, s, t, keys)):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("name,aperture", [("CornellBox", None), ("CornellBox", 20.0),
                                           ("TwoSphereCheckers", 0.1)])
def test_camera_gradients_bit_identical_to_before(name, aperture, monkeypatch):
    """A differentiable step, 16x12, 2 spp, 4 bounces, with the scene's
    own camera and with a lens so that the disk moves the rays: the loss
    and every gradient leaf, the seven camera parameters' among them,
    equal the step on the tensor-op lanes bit for bit.  CornellBox takes
    the fused route, whose camera gradients are zero on its solid colours;
    TwoSphereCheckers the generic one, where they are not."""
    sd = t_get_scene(name)
    scene, bg = sd.build(), sd.output.image.background
    cam = sd.camera_at(0.0, make=CameraParams.create)
    if aperture is not None:
        cam = dataclasses.replace(cam, aperture=torch.tensor(aperture))
    s = RenderSettings(16, 12, 2, 4, bg, spp_chunk=2, differentiable=True)
    params = DiffParams.from_scene(scene, cam, bg)
    target = torch.full((12, 16, 3), 0.2)
    runs = []
    for _ in range(2):
        runs.append(render_loss_and_grad(params, scene, s, prng_key(7), target, device="cpu"))
        monkeypatch.setattr(trender, "camera_lanes", lanes_before)
    (l0, g0), (l1, g1) = runs
    assert float(l0) == float(l1)
    for a, b in zip(g0.leaves(), g1.leaves()):
        np.testing.assert_array_equal(_bits(a), _bits(b))
    cam_grads = torch.cat([x.reshape(-1) for x in g0.leaves()[3:]])  # the camera's 7
    assert torch.isfinite(cam_grads).all()
    if name == "TwoSphereCheckers":
        assert (g0.camera.aperture != 0).all() and cam_grads.abs().max() > 0


# ---------------------------------------------------------------------------
# the wrapper's dispatch
# ---------------------------------------------------------------------------


def test_wrapper_dispatch(monkeypatch):
    """CPU tensors take the plain twin (no launch is counted); no lanes give
    empty rows; the meta device and malformed arguments raise."""
    monkeypatch.setattr(lanes, "launches", 0)
    pixel = torch.arange(64, dtype=torch.int64)
    kw = dict(width=8, height=8, spp_total=1)
    keys, s, t, disk = lanes.camera_lane_draws(prng_key(1), pixel, torch.zeros_like(pixel), **kw)
    assert keys.shape == (2, 64) and keys.dtype == torch.int32
    assert s.shape == t.shape == (64,) and disk.shape == (64, 2) and lanes.launches == 0
    empty = torch.zeros(0, dtype=torch.int64)
    keys, s, t, disk = lanes.camera_lane_draws(prng_key(1), empty, empty, **kw)
    assert keys.shape == (2, 0) and s.shape == t.shape == (0,) and disk.shape == (0, 2)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        lanes.camera_lane_draws(prng_key(1), pixel.to("meta"), pixel.to("meta"), **kw)
    with pytest.raises(ValueError, match="int64"):
        lanes.camera_lane_draws(prng_key(1), pixel.int(), pixel.int(), **kw)
    with pytest.raises(ValueError, match="int64"):
        lanes.camera_lane_draws(prng_key(1), pixel, pixel[:63], **kw)
    with pytest.raises(ValueError, match="base_key"):
        lanes.camera_lane_draws(prng_key(1)[None], pixel, pixel, **kw)
    with pytest.raises(ValueError, match="positive"):
        lanes.camera_lane_draws(prng_key(1), pixel, pixel, width=8, height=8, spp_total=0)


# ---------------------------------------------------------------------------
# the kernel's source on the emulated card
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["source", "one_block_an_sm", "no_trig"])
def emu_lib(request, tmp_path_factory):
    """``lanes.cu`` built by ``emu_build`` with ``threefry.cuh`` beside it:
    as it is; with BLOCKS_PER_SM = 1 (2 blocks walk the tiles); and with
    cosf(theta) and sinf(theta) replaced by 1 and theta, so that the disk
    rows are r and r * theta (bit for bit)."""
    from test_torch_projected_rows import emu_build

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    src = (CSRC / "lanes.cu").read_text()
    if request.param == "one_block_an_sm":
        src, n = re.subn(r"constexpr int BLOCKS_PER_SM = \d+;",
                         "constexpr int BLOCKS_PER_SM = 1;", src)
        assert n == 1
    elif request.param == "no_trig":
        src, n = re.subn(r"r \* cosf\(theta\)", "r * 1.0f", src)
        src, m = re.subn(r"r \* sinf\(theta\)", "r * theta", src)
        assert n == m == 1
    tmp = tmp_path_factory.mktemp("lanes")
    shutil.copy(CSRC / "threefry.cuh", tmp / "threefry.cuh")
    lib, n_launch = emu_build(tmp, "lanes", src)
    assert n_launch == 1
    return request.param, lib


def launch_emulated(lib, base_key, pixel, sample, *, width, height, spp_total):
    """``lanes._launch``'s call, on CPU tensors; the rows start filled with
    NaN bits, so a lane the launch skips shows."""
    R = pixel.shape[0]
    out = torch.full((lanes.N_ROWS, R), 0x7FC00001, dtype=torch.int32)
    err = lib.camera_lanes_launch(base_key.data_ptr(), pixel.data_ptr(), sample.data_ptr(),
                                  width, height, spp_total, out.data_ptr(), R, None)
    assert err == 0
    return lanes._split(out)


def _lens_uniforms(base_key, pixel, sample, spp_total):
    lk = sampling.lane_keys(base_key, (pixel * spp_total + sample) & 0xFFFFFFFF)
    return sampling.uniform2(sampling.bounce_keys(lk, 0, sampling.P_LENS))


def _check_emulated(variant, lib, base_key, pixel, sample, **kw):
    got = launch_emulated(lib, base_key, pixel, sample, **kw)
    want = lanes.camera_lane_draws_plain(base_key, pixel, sample, **kw)
    for g, w, name in zip(got[:3], want[:3], ("keys", "s_vp", "t_vp")):
        np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f"{variant}: {name}")
    if variant == "no_trig":
        u = _lens_uniforms(base_key, pixel, sample, kw["spp_total"])
        r = sqrt(u[:, 0])
        theta = (2.0 * np.pi) * u[:, 1]
        np.testing.assert_array_equal(_bits(got[3][:, 0]), _bits(r), err_msg="r")
        np.testing.assert_array_equal(_bits(got[3][:, 1]), _bits(r * theta), err_msg="theta")
        return
    g, w = got[3].numpy(), want[3].numpy()
    if not w.size:
        return
    ulps = np.abs(g.astype(np.float64) - w) / np.spacing(np.abs(w))
    assert np.isfinite(g).all() and ulps.max() <= DISK_ULPS, (variant, ulps.max())


@pytest.mark.parametrize("n", [0, 1, 31, 33, 3149])
def test_emulated_kernel_matches_plain(n, emu_lib):
    """Pixel ids of a 64x36 frame at 10 spp; past 2**32 (the 64-bit
    division); and, at 3,149 lanes, counters p * S + s that wrap past
    2**32, one of them to exactly 0."""
    variant, lib = emu_lib
    rng = np.random.default_rng(n)
    w, h, spp = 64, 36, 10
    pixel = rng.integers(0, w * h, n)
    sample = rng.integers(0, spp, n)
    _check_emulated(variant, lib, prng_key(SEED), torch.from_numpy(pixel),
                    torch.from_numpy(sample), width=w, height=h, spp_total=spp)
    big = pixel + 2**33 + 5  # past 2**32: the kernel's 64-bit column and row
    _check_emulated(variant, lib, prng_key(SEED + 1), torch.from_numpy(big),
                    torch.from_numpy(sample), width=854, height=2**28, spp_total=spp)
    if n > 1000:
        spp_total = 2000
        wrap = (2**32 // spp_total) + rng.integers(-n // 2, n // 2, n)  # p * S near 2**32
        s = rng.integers(0, spp_total, n)
        wrap[0], s[0] = 2**32 // spp_total, 2**32 % spp_total  # the counter wraps to 0
        assert (wrap * spp_total + s > 2**32).sum() > n // 4
        _check_emulated(variant, lib, prng_key(7), torch.from_numpy(wrap),
                        torch.from_numpy(s), width=4096, height=2**20, spp_total=spp_total)


@pytest.mark.parametrize("stripe", [False, True])
def test_emulated_kernel_on_spawn_ids(stripe, emu_lib):
    """The regen spawn's ids decoded both ways, as ``wavefront._spawn``
    decodes them before the kernel."""
    variant, lib = emu_lib
    w, h, spp = 64, 36, 4
    wid = _spawn_ids(1000, w, h, spp, stripe)
    if stripe:
        pixel, sample = wid // spp, wid % spp
    else:
        pixel, sample = wid % (w * h), wid // (w * h)
    _check_emulated(variant, lib, prng_key(SEED), pixel, sample, width=w, height=h,
                    spp_total=spp)
