"""The draw kernel (``ops/draws.py``, ``ops/csrc/draws.cu``) on the CPU.

Threefry is exact integer arithmetic, so every comparison here is BIT
FOR BIT:

* ``bounce_draws`` (its plain version on CPU tensors) against
  ``sampling.bounce_draws`` on the lane keys, at a scalar bounce, at one
  whose ``bounce * 8 + purpose`` wraps past 2**32, and at per-lane
  depths;
* ``ops/csrc/draws.cu`` built with g++ against ``tests/cuda_emu.h``
  (one std::thread a CUDA thread, a card of 2 SMs), as it is and with
  one block an SM so that 2 blocks walk 4 tiles, on ragged lane counts,
  against ``sampling.bounce_draws``;
* the chunked generic routes, which now draw each bounce with
  ``bounce_draws``, against the same renders with the draws hoisted for
  every bounce at once (``integrator._precompute_draws``, the JAX
  package's form): the image-textured scene forward and differentiable
  (loss and every gradient leaf), TwoSphereCheckers differentiable and
  SphereField forward.

The kernel itself is held against its plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""

import ctypes
import re
import shutil

import numpy as np
import pytest
import torch

from rust_pathtracer_tpu_torch import integrator, sampling
from rust_pathtracer_tpu_torch.camera import make_camera
from rust_pathtracer_tpu_torch.grad import CameraParams, DiffParams, render_loss_and_grad
from rust_pathtracer_tpu_torch.integrator import _precompute_draws
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.ops import draws
from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
from rust_pathtracer_tpu_torch.ops._build import CSRC
from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
from rust_pathtracer_tpu_torch.scene import SceneBuilder
from test_torch_materials_textures import _scene_simple

torch.set_num_threads(2)

IMAGE_CAM = ((0.0, 1.0, 2.0), (0.0, 0.5, -3.0), (0.0, 1.0, 0.0), 50.0, 1.0, 0.0, 10.0)


def _bits(x):
    return np.ascontiguousarray(x.numpy()).view(np.int32)


def _keys(n, seed):
    """(2, n) key words of n lane keys, some with words >= 2**31."""
    lk = sampling.lane_keys(sampling.prng_key(seed), torch.arange(n))
    return fb.key_words(lk), lk


def _assert_draws_equal(got, want, what):
    assert (got[3] is None) == (want[3] is None), what
    for g, w in zip(got, want):
        if w is not None:
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=what)


@pytest.mark.parametrize("with_roulette", [False, True])
def test_plain_matches_sampling(with_roulette):
    n = 3000
    keys, lk = _keys(n, 5)
    depth = torch.from_numpy(np.random.default_rng(1).integers(0, 50, n).astype(np.int32))
    for bounce in (0, 7, 2**29 + 5, depth):
        at = bounce.long() if isinstance(bounce, torch.Tensor) else bounce
        _assert_draws_equal(draws.bounce_draws(keys, bounce, with_roulette),
                            sampling.bounce_draws(lk, at, with_roulette), str(bounce))
    # a per-lane depth draws, lane by lane, what that lane's scalar bounce draws
    got = draws.bounce_draws(keys, depth, with_roulette)
    for b in (0, 13, 49):
        sel = depth == b
        want = sampling.bounce_draws(lk[sel], b, with_roulette)
        _assert_draws_equal([None if g is None else g[sel] for g in got], want, f"depth {b}")


def test_wrapper_dispatch(monkeypatch):
    """CPU tensors take the plain version (no launch is counted); the meta
    device, malformed keys and a malformed bounce raise."""
    keys, _ = _keys(64, 2)
    monkeypatch.setattr(draws, "launches", 0)
    su, bu, coin, rl = draws.bounce_draws(keys, 3, True)
    assert su.shape == (64, 2) and bu.shape == (64, 3) and coin.shape == (64,)
    assert rl.shape == (64,) and draws.launches == 0
    assert draws.bounce_draws(keys, 3, False)[3] is None
    with pytest.raises(ValueError, match="no kernel for device meta"):
        draws.bounce_draws(keys.to("meta"), 3, False)
    with pytest.raises(ValueError, match="int32"):
        draws.bounce_draws(keys.long(), 3, False)
    with pytest.raises(ValueError, match="int32"):
        draws.bounce_draws(keys.T.contiguous(), 3, False)
    with pytest.raises(ValueError, match="per-lane"):
        draws.bounce_draws(keys, torch.zeros(63, dtype=torch.int32), False)
    with pytest.raises(ValueError, match="per-lane"):
        draws.bounce_draws(keys, torch.zeros(64, dtype=torch.int64), False)
    with pytest.raises(ValueError, match="bounce"):
        draws.bounce_draws(keys, -1, False)


@pytest.fixture(scope="module", params=["source", "one_block_an_sm"])
def emu_lib(request, tmp_path_factory):
    """``draws.cu`` built by ``emu_build`` with ``threefry.cuh`` beside it:
    as it is, and with BLOCKS_PER_SM = 1 (2 blocks walk 4 tiles)."""
    from test_torch_projected_rows import emu_build

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    src = (CSRC / "draws.cu").read_text()
    if request.param == "one_block_an_sm":
        src, n = re.subn(r"constexpr int BLOCKS_PER_SM = \d+;",
                         "constexpr int BLOCKS_PER_SM = 1;", src)
        assert n == 1
    tmp = tmp_path_factory.mktemp("draws")
    shutil.copy(CSRC / "threefry.cuh", tmp / "threefry.cuh")
    lib, n_launch = emu_build(tmp, "draws", src)
    assert n_launch == 1
    return lib


def launch_emulated(lib, keys, bounce, with_roulette):
    """``draws._launch``'s call, on CPU tensors; the output rows start
    filled with NaN, so a lane the launch skips shows."""
    R = keys.shape[1]
    out = torch.full((draws.N_ROWS + int(with_roulette), R), float("nan"))
    per_lane = isinstance(bounce, torch.Tensor)
    err = lib.bounce_draws_launch(keys.data_ptr(), bounce.data_ptr() if per_lane else None,
                                  0 if per_lane else bounce, int(with_roulette),
                                  out.data_ptr(), R, None)
    assert err == 0
    return draws._split(out, with_roulette)


@pytest.mark.parametrize("n", [1, 255, 257, 1000])
def test_emulated_kernel_source_matches_sampling(n, emu_lib):
    keys, lk = _keys(n, 100 + n)
    depth = torch.from_numpy(np.random.default_rng(n).integers(0, 64, n).astype(np.int32))
    for bounce in (0, 19, 2**29 + 5, depth):
        at = bounce.long() if isinstance(bounce, torch.Tensor) else bounce
        for rr in (False, True):
            _assert_draws_equal(launch_emulated(emu_lib, keys, bounce, rr),
                                sampling.bounce_draws(lk, at, rr), f"{bounce} {rr}")


@pytest.fixture
def hoisted_draws(monkeypatch):
    """The generic route's draws as the parent hoisted them: every
    bounce's uniforms at once (``_precompute_draws``) on a trace's first
    bounce, then bounce ``b``'s slices."""
    def use(max_bounces, rr_start):
        table = {}

        def hoisted(keys, bounce, with_roulette):
            if bounce == 0:
                table.update(_precompute_draws(fb._lane_keys(keys), max_bounces,
                                               max_bounces + 1 if rr_start is None
                                               else rr_start))
            return (table["sphere_u"][bounce], table["ball_u"][bounce],
                    table["coin"][bounce],
                    table["roulette"][bounce] if with_roulette else None)

        monkeypatch.setattr(integrator, "bounce_draws", hoisted)
    return use


def _image_scene():
    return _scene_simple(SceneBuilder), make_camera(*IMAGE_CAM), (0.1, 0.1, 0.1)


@pytest.mark.parametrize("name,rr", [("image", None), ("image", 2), ("SphereField", 3)])
def test_generic_forward_bit_identical_to_hoisted(name, rr, hoisted_draws):
    if name == "image":
        scene, cam, bg = _image_scene()
    else:
        sd = get_scene(name)
        scene, cam, bg = sd.build(), sd.camera_at(0.0), sd.output.image.background
    s = RenderSettings(12, 8, 3, 6, bg, russian_roulette_start=rr)
    runs = []
    for _ in range(2):
        img, st = render_radiance(scene, cam, s, sampling.prng_key(4), device="cpu")
        runs.append((img, st))
        hoisted_draws(6, rr)
    (a, sa), (b, sb) = runs
    np.testing.assert_array_equal(_bits(a), _bits(b))
    assert float(sa.segments) == float(sb.segments) and torch.equal(sa.occupancy,
                                                                    sb.occupancy)


@pytest.mark.parametrize("name,rr", [("image", None), ("TwoSphereCheckers", 2)])
def test_generic_loss_and_grad_bit_identical_to_hoisted(name, rr, hoisted_draws):
    """``render_loss_and_grad`` on the generic differentiable route,
    10x8, 2 spp, 5 bounces: the loss and every gradient leaf."""
    if name == "image":
        scene, _, bg = _image_scene()
        cam = CameraParams.create(*IMAGE_CAM)
    else:
        sd = get_scene(name)
        scene, bg = sd.build(), sd.output.image.background
        cam = sd.camera_at(0.0, make=CameraParams.create)
    s = RenderSettings(10, 8, 2, 5, bg, spp_chunk=2, differentiable=True,
                       russian_roulette_start=rr)
    params = DiffParams.from_scene(scene, cam, bg)
    target = torch.full((8, 10, 3), 0.2)
    runs = []
    for _ in range(2):
        runs.append(render_loss_and_grad(params, scene, s, sampling.prng_key(7), target,
                                         device="cpu"))
        hoisted_draws(5, rr)
    (l0, g0), (l1, g1) = runs
    assert float(l0) == float(l1)
    for a, b in zip(g0.leaves(), g1.leaves()):
        np.testing.assert_array_equal(_bits(a.detach()), _bits(b.detach()))
    assert torch.cat([x.reshape(-1) for x in g0.leaves()]).abs().max() > 0
