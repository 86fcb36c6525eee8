"""K1's CUDA source on the CPU: ``ops/csrc/fused_bounce.cu`` built with
g++ against ``tests/cuda_emu.h`` (one std::thread a CUDA thread, an
emulated card of 2 SMs holding one block each, so two blocks stride over
the lanes) and held against ``fused_bounce_keyed_plain`` on the same
CPU tensors.

The lanes are chip_smoke.py's ``random_lanes`` of its ``full_scene``
(every primitive kind, material and texture; a tenth of the lanes dead,
a tenth inside the glass shell, a tenth under the light), 3,001 of them,
with random key words.  Cases: the four instantiations (residuals off /
on, the legacy / packed draws), at one bounce and, without residuals, at
per-lane depths with roulette from depth 3; roulette on and off.

Two builds of the source:

* as it is.  Winners, alive-out and the residual flags are held bit for
  bit on every lane, and every f32 output on every lane whose value
  does not pass through a sine, a cosine or the metal's cube root.  The
  rest (a hit on a lambertian or a metal: the scatter's sine and
  cosine, the cube root; a checker or marble texture: its sines) within
  1e-5 rel + 1e-6 abs, chip_smoke.py's tolerance: the host's libm and
  torch's CPU sin / cos differ by an ulp or two.
* with ``sinf(x)`` as ``x``, ``cosf(x)`` as ``1 - x`` and the cube root
  as its argument, against the plain version with ``torch.sin``,
  ``torch.cos`` and ``vecmath.cbrt`` replaced the same way: every output
  of every lane bit for bit; so too with ``COOP_MARBLE`` at 0 and at 32,
  so that every warp sums each marble lane's turbulence alone, or the
  whole warp together (the lanes alone pick each form only for some
  warps).

On the card ``tests/test_torch_cuda.py`` and chip_smoke.py (phases 3, 6,
18, 19, 38) hold the kernel to its plain version on the same CUDA
tensors, bit for bit.
"""

import ctypes
import importlib.util
import re
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from rust_pathtracer_tpu_torch.integrator import T_MIN
from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
from rust_pathtracer_tpu_torch.ops._build import CSRC
from rust_pathtracer_tpu_torch.scene.types import (
    MAT_LAMBERTIAN,
    MAT_METAL,
    TEX_CHECKER,
    TEX_PERLIN,
)

N_LANES = 3001
BOUNCE = 7
REGEN_DEPTHS, RR_START = 50, 3
RTOL, ATOL = 1e-5, 1e-6  # trigonometry's lanes, in the source as it is
BG = (0.2, 0.1, 0.05)
NAN_BITS = 0x7FC00001  # outputs start as NaN: a lane the launch skips shows

# the launch, as the kernel source writes it, and as the emulation runs it
LAUNCH = re.compile(r"fused_bounce_kernel<RES, PACKED><<<grid, THREADS, smem, s>>>\((.*?)\);",
                    re.S)
EMU_LAUNCH = r"emu_launch(grid, THREADS, [&] { fused_bounce_kernel<RES, PACKED>(\1); });"
SHARED = "extern __shared__ float tab[];"


def _smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _smoke()


# the builds: name -> COOP_MARBLE (None: the source's), trigonometry kept
BUILDS = {"source": (None, True), "no_trig": (None, False),
          "no_trig_marble_alone": (0, False), "no_trig_marble_together": (32, False)}
COOP_LINE = re.compile(r"constexpr int COOP_MARBLE = \d+;")


@pytest.fixture(scope="module", params=list(BUILDS))
def emu_lib(request, tmp_path_factory):
    """``fused_bounce.cu`` built by ``emu_build`` with ``threefry.cuh``
    beside it, as it is or with its trigonometry and cube root replaced,
    and its COOP_MARBLE moved."""
    from test_torch_projected_rows import emu_build

    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the kernel source for the host")
    coop, trig = BUILDS[request.param]
    src = (CSRC / "fused_bounce.cu").read_text()
    src, n_launch = LAUNCH.subn(EMU_LAUNCH, src)
    assert n_launch == 1
    assert src.count(SHARED) == 1
    src = src.replace(SHARED, "static float tab[PAY_W * MAX_PRIMS];")
    if coop is not None:
        src, n = COOP_LINE.subn(f"constexpr int COOP_MARBLE = {coop};", src)
        assert n == 1
    if not trig:
        n_trig = len(re.findall(r"\b(?:sinf|cosf)\(", src))
        src = re.sub(r"\bsinf\(", "emu_sin(", src)
        src = re.sub(r"\bcosf\(", "emu_cos(", src)
        src, n_pow = re.subn(r"\(float\)pow\(\(double\)u\.u2, 1\.0 / 3\.0\)", "u.u2", src)
        assert n_pow == 1 and n_trig == 6, (n_pow, n_trig)
        src = src.replace('#include "threefry.cuh"', '#include "threefry.cuh"\n'
                          "inline float emu_sin(float x) { return x; }\n"
                          "inline float emu_cos(float x) { return 1.0f - x; }")
    tmp = tmp_path_factory.mktemp("fused_bounce")
    shutil.copy(CSRC / "threefry.cuh", tmp / "threefry.cuh")
    lib, _ = emu_build(tmp, "fused_bounce", src)
    return request.param, lib


@pytest.fixture
def no_trig_plain(emu_lib, monkeypatch):
    """The plain version with the no_trig builds' replacements."""
    if not BUILDS[emu_lib[0]][1]:
        monkeypatch.setattr(torch, "sin", lambda x: x)
        monkeypatch.setattr(torch, "cos", lambda x: 1.0 - x)
        monkeypatch.setattr(fb, "cbrt", lambda x: x)
    return emu_lib


def launch_emulated(lib, table, bg, seed, state, keys, bounce, *, with_roulette, kinds,
                    mat_types, tex_types, t_min, rr_start=0, winner_out=None,
                    want_residuals=False, rng_scheme="legacy"):
    """``fused_bounce._launch``'s call, on CPU tensors."""
    table, bg = table.contiguous(), bg.contiguous()
    state, keys = state.contiguous(), keys.contiguous()
    R = state.shape[1]
    depth = bounce.contiguous() if isinstance(bounce, torch.Tensor) else None
    out = torch.full((len(fb._COL_KEYS), R), NAN_BITS, dtype=torch.int32).view(torch.float32)
    res_f = flags = None
    if want_residuals:
        res_f = torch.full((len(fb._RES_KEYS) - 1 + int(with_roulette), R), NAN_BITS,
                           dtype=torch.int32).view(torch.float32)
        flags = torch.full((R,), -7, dtype=torch.int32)
    err = lib.fused_bounce_launch(
        table.data_ptr(), table.shape[1], bg.data_ptr(), int(seed) & 0xFFFFFFFF, float(t_min),
        fb._type_flags(mat_types, fb._MAT_BITS, "material"),
        fb._type_flags(tex_types, fb._TEX_BITS, "texture"), state.data_ptr(),
        keys.data_ptr(), 0 if depth is not None else int(bounce), int(with_roulette),
        int(rng_scheme == "packed"), None if depth is None else depth.data_ptr(),
        int(rr_start), out.data_ptr(), None if res_f is None else res_f.data_ptr(),
        None if flags is None else flags.data_ptr(),
        None if winner_out is None else winner_out.data_ptr(), R, None)
    assert err == 0
    if not want_residuals:
        return out
    planes = res_f.unbind(0)
    res = dict(zip(fb._RES_KEYS, (*planes[:len(fb._RES_KEYS) - 1], flags)))
    if with_roulette:
        res["rr_p"] = planes[-1]
    return out, res


def _inputs(seed):
    scene = SMOKE.full_scene("cpu")
    cols, lane_keys = SMOKE.random_lanes(N_LANES, seed=seed)
    depth = torch.from_numpy(np.random.default_rng(seed).integers(
        0, REGEN_DEPTHS, N_LANES).astype(np.int32))
    args = (fb.pack_prims_shaded(scene), torch.tensor(BG), scene.textures.perlin_seed,
            torch.from_numpy(cols), fb.key_words(torch.from_numpy(lane_keys)))
    kw = dict(kinds=scene.kinds_static, mat_types=scene.mat_types,
              tex_types=scene.tex_types, t_min=T_MIN)
    return args, kw, depth


def _trig_lanes(args, kw):
    """Lanes whose winner (alive or not) is a lambertian or a metal, or
    has a checker or marble texture: their floats pass through sin, cos
    or the cube root."""
    table, _, _, state = args[:4]
    every = state.clone()
    every[12] = 1.0
    win = torch.empty(state.shape[1], dtype=torch.int32)
    fb.fused_bounce_keyed_plain(*args[:3], every, args[4], 0, with_roulette=False,
                                winner_out=win, **kw)
    row = table[:, win.clamp(min=0).long()]
    mk, tk = row[fb.PAY_MKIND], row[fb.PAY_TKIND]
    trig = ((mk == MAT_LAMBERTIAN) | (mk == MAT_METAL) | (tk == TEX_CHECKER)
            | (tk == TEX_PERLIN))
    return ((win >= 0) & trig).numpy()


def _bits(x):
    return x.contiguous().view(torch.int32).numpy()


def _hold(name, got, want, trig, exact):
    """``got`` against ``want``: bit for bit on every lane where ``exact``,
    else outside ``trig`` and within RTOL / ATOL on it."""
    g, w = _bits(got), _bits(want)
    same = g == w
    if exact:
        bad = ~same
    else:
        gf = got.numpy().astype(np.float64)
        wf = want.numpy().astype(np.float64)
        close = np.abs(gf - wf) <= ATOL + RTOL * np.abs(wf)
        bad = ~same & (~trig | ~close)
    lanes = np.nonzero(bad.reshape(-1, g.shape[-1]).any(axis=0))[0]
    assert lanes.size == 0, (
        f"{name}: {lanes.size} lanes differ, first {lanes[:5].tolist()}; kernel "
        f"{got[..., lanes[0]].tolist()}, plain {want[..., lanes[0]].tolist()}")
    return int((~same).any(axis=0).sum()) if g.ndim == 2 else int((~same).sum())


# (residuals, packed, per-lane depth): every instantiation at one bounce,
# and the two without residuals at per-lane depths (the regen pool's form)
CASES = [(res, packed, False) for res in (False, True) for packed in (False, True)]
CASES += [(False, packed, True) for packed in (False, True)]


@pytest.mark.parametrize("roulette", [False, True])
@pytest.mark.parametrize("res,packed,per_lane", CASES)
def test_emulated_kernel_matches_plain(res, packed, per_lane, roulette, no_trig_plain):
    variant, lib = no_trig_plain
    args, kw, depth = _inputs(seed=18 + 2 * packed + per_lane)
    bounce = depth if per_lane else BOUNCE
    kw = dict(kw, with_roulette=roulette, want_residuals=res,
              rng_scheme="packed" if packed else "legacy",
              **({"rr_start": RR_START} if per_lane else {}))
    k_win = torch.full((N_LANES,), -9, dtype=torch.int32)
    p_win = torch.empty(N_LANES, dtype=torch.int32)
    got = launch_emulated(lib, *args, bounce, winner_out=k_win, **kw)
    want = fb.fused_bounce_keyed_plain(*args, bounce, winner_out=p_win, **kw)
    (got, k_res), (want, p_res) = (got, want) if res else ((got, {}), (want, {}))
    exact = not BUILDS[variant][1]
    trig = _trig_lanes(args, {k: kw[k] for k in ("kinds", "mat_types", "tex_types",
                                                 "t_min")})
    np.testing.assert_array_equal(k_win.numpy(), p_win.numpy(), err_msg="winners")
    np.testing.assert_array_equal(_bits(got[12]), _bits(want[12]), err_msg="alive-out")
    assert set(k_res) == set(p_res)
    if res:
        np.testing.assert_array_equal(k_res["flags"].numpy(), p_res["flags"].numpy(),
                                      err_msg="residual flags")
    differ = _hold("state", got, want, trig, exact)
    for k in sorted(set(k_res) - {"flags"}):
        differ += _hold(k, k_res[k], p_res[k], trig, exact)
    # the cases reach what they are meant to: hits, misses and dead lanes,
    # continuing lanes, roulette's kills
    alive_in = args[3][12].numpy() > 0.5
    alive_out = want[12].numpy() > 0.5
    assert (p_win.numpy() >= 0).sum() > N_LANES // 2 and (alive_in & (p_win.numpy() < 0)).any()
    assert (~alive_in).any() and alive_out.any()
    assert trig.any() and (~trig & (p_win.numpy() >= 0)).any()
    marble = args[0][fb.PAY_TKIND][p_win.clamp(min=0).long()].numpy() == TEX_PERLIN
    assert (marble & (p_win.numpy() >= 0)).sum() > 32  # more than a warp's worth
    if exact:
        assert differ == 0
