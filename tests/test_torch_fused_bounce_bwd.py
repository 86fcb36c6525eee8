"""K1's residual outputs and K2's plain version against the JAX package.

The same numpy inputs go through the port's plain versions and through
the JAX package's Pallas kernels, run by the Pallas interpreter
(``interpret=True``, as the JAX package's own tests run them on the
CPU), and through ``_bwd_xla``, the JAX package's jnp twin of the
backward kernel.  The CUDA kernels are held against the plain versions
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the card, and
K2's source, built with g++ on an emulated card, here.
"""

import dataclasses
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_pathtracer_tpu.integrator import T_MIN
from rust_pathtracer_tpu.models import get_scene as j_get_scene
from rust_pathtracer_tpu.ops import fused_bounce as jfb
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.ops import fused_bounce as fb
from rust_pathtracer_tpu_torch.ops import fused_bounce_bwd as fbb
from rust_pathtracer_tpu_torch.ops._build import CSRC
from test_fused_bounce import _full_scene as j_full_scene
from test_torch_cuda import _bwd_inputs, _random_lanes, _t_inputs, t_full_scene

torch.set_num_threads(2)

R = 512
BG = (0.2, 0.1, 0.05)


@pytest.fixture(scope="module")
def bounce():
    """One bounce of 512 lanes through every primitive kind, material
    and texture, with residuals, on both sides."""
    jscene, tscene = j_full_scene(), t_full_scene()
    cols, uni = _random_lanes(R, seed=11)
    jcols = {k: jnp.asarray(cols[i]) for i, k in enumerate(fb._COL_KEYS)}
    jpack = jfb.pack_prims_shaded(jscene)
    jout, jres = jfb._fused_bounce_cols(
        jpack, jnp.asarray(BG, jnp.float32),
        jnp.asarray(jscene.textures.perlin_seed, jnp.uint32), jcols,
        *[jnp.asarray(u) for u in uni], kinds=jscene.kinds_static,
        mat_types=jscene.mat_types, tex_types=jscene.tex_types,
        t_min=float(T_MIN), interpret=True, want_residuals=True)
    tcols, tuni = _t_inputs(cols, uni)
    kw = dict(kinds=tscene.kinds_static, mat_types=tscene.mat_types,
              tex_types=tscene.tex_types, t_min=T_MIN)
    args = (fb.pack_prims_shaded(tscene), torch.tensor(BG),
            tscene.textures.perlin_seed, tcols, *tuni)
    return dict(jscene=jscene, tscene=tscene, cols=cols, jpack=jpack,
                jout=jout, jres=jres, args=args, kw=kw)


def test_residuals_match_pallas_interpret(bounce):
    """``fused_bounce_cols_plain(want_residuals=True)`` vs the Pallas
    kernel's residual outputs.  Flags exactly equal on every lane (dead
    and missed ones included), apart from a checker pick whose
    sin-product lies within 1e-6 of 0.  Floats at the single-bounce
    contract of ``test_plain_bounce_matches_pallas_interpret``: within
    1e-5 rel / 1e-6 abs on at least 95% of lanes, all within 2e-3 /
    1e-4 (XLA:CPU fuses multiply-adds; the port rounds every op).  The
    13 columns are bit-equal to a run without residuals."""
    out0 = fb.fused_bounce_cols_plain(*bounce["args"], **bounce["kw"])
    out, res = fb.fused_bounce_cols_plain(*bounce["args"], **bounce["kw"],
                                          want_residuals=True)
    for k in fb._COL_KEYS:
        assert torch.equal(out[k], out0[k]), k
    assert set(res) == set(fb._RES_KEYS)
    assert res["flags"].dtype == torch.int32
    jres = {k: np.asarray(v).reshape(-1)[:R] for k, v in bounce["jres"].items()}

    flags, jflags = res["flags"].numpy(), jres["flags"]
    table = bounce["args"][0].numpy()
    w = flags >> fb.FLG_BESTI_SHIFT
    hp = (bounce["cols"][0:3] + res["t"].numpy() * bounce["cols"][3:6]).astype(np.float64)
    ts = table[fb.PAY_TSCALE, w].astype(np.float64)
    sines = np.sin(ts * hp[0]) * np.sin(ts * hp[1]) * np.sin(ts * hp[2])
    flip_ok = ((flags & fb.FLG_IS_CK) != 0) & (np.abs(sines) < 1e-6)
    assert (flags[~flip_ok] == jflags[~flip_ok]).all()
    # the residuals cover dead lanes and misses as the Pallas kernel does
    alive = bounce["cols"][12] > 0.5
    assert (~alive).sum() > 20 and ((flags & fb.FLG_HIT) == 0).sum() > 50
    assert ((flags & fb.FLG_HIT) != 0).sum() > 200
    for bit in (fb.FLG_REFLECT, fb.FLG_SINES_NEG, fb.FLG_SEL_M, fb.FLG_SEL_D,
                fb.FLG_LIGHT_ON, fb.FLG_L_NEG, fb.FLG_IS_CK):
        assert ((flags & bit) != 0).any(), bit

    for k in fb._RES_KEYS[:-1]:
        got, want = res[k].numpy(), jres[k]
        close = np.isclose(got, want, rtol=1e-5, atol=1e-6)
        assert close.mean() >= 0.95, (k, close.mean())
        np.testing.assert_allclose(got, want, rtol=2e-3, atol=1e-4, err_msg=k)


def _jax_bwd_inputs(bounce, cot):
    cols = bounce["cols"]
    d = tuple(jnp.asarray(cols[3 + c]) for c in range(3))
    thr = tuple(jnp.asarray(cols[6 + c]) for c in range(3))
    g = [tuple(jnp.asarray(cot[3 * j + c]) for c in range(3)) for j in range(4)]
    return d, thr, g, jnp.asarray(BG, jnp.float32)


def test_bwd_plain_matches_jax(bounce):
    """``fused_bounce_bwd_plain`` fed the Pallas kernel's residuals and
    numpy cotangents, against ``_bwd_xla`` (the same expressions in the
    same order: equal to 1e-6 relative, XLA:CPU may fuse a multiply-add)
    and the Pallas ``_bwd_call`` in the interpreter (rsqrt and other
    rounding: 1e-4 relative of the largest gradient).  The texture and
    background reductions against ``_bounce_grads`` (one-hot product
    and sums: 1e-5 relative)."""
    jscene, tscene = bounce["jscene"], bounce["tscene"]
    res, d, thr, cots, bg, cot = _bwd_inputs(
        {k: np.asarray(v).reshape(-1)[:R] for k, v in bounce["jres"].items()},
        bounce["cols"], BG, seed=5)
    grads, g_tex, g_bg = fbb.fused_bounce_bwd_plain(
        res, d, thr, cots, bg, mat_types=tscene.mat_types,
        n_prims=tscene.num_prims)
    got = np.stack([grads[k].numpy() for k in fbb._GRAD_KEYS])

    jd, jthr, g, jbg = _jax_bwd_inputs(bounce, cot)
    jres = bounce["jres"]
    xla = np.stack([np.asarray(x) for x in
                    sum(jfb._bwd_xla(jres, jd, jbg, *g, jscene.mat_types), ())])
    pal = np.stack([np.asarray(x) for x in sum(jfb._bwd_call(
        jres, jd, jbg, *g, mat_types=jscene.mat_types, interpret=True), ())])
    scale = np.abs(xla).max()
    assert scale > 1.0
    np.testing.assert_allclose(got, xla, rtol=1e-6, atol=1e-6 * scale)
    np.testing.assert_allclose(got, pal, rtol=1e-4, atol=1e-4 * scale)

    *_, gp, gbg = jfb._bounce_grads(jres, jd, jthr, jbg, *g, bounce["jpack"],
                                    jscene.num_prims, jscene.mat_types, True)
    gp = np.asarray(gp)
    assert not np.delete(gp, range(fb.PAY_COLOR, fb.PAY_EVEN + 3), 0).any()
    want_tex = gp[fb.PAY_COLOR:fb.PAY_EVEN + 3]
    assert g_tex.shape == (9, tscene.num_prims) and np.abs(want_tex).max() > 1.0
    np.testing.assert_allclose(g_tex.numpy(), want_tex, rtol=1e-5,
                               atol=1e-5 * np.abs(want_tex).max())
    np.testing.assert_allclose(g_bg.numpy(), np.asarray(gbg), rtol=1e-5, atol=1e-6)


def test_bwd_dispatch_by_device(bounce, monkeypatch):
    """CPU tensors take the plain version (no launch is counted); other
    devices, mixed devices and malformed inputs raise."""
    tscene = bounce["tscene"]
    out, res = fb.fused_bounce_cols_plain(*bounce["args"], **bounce["kw"],
                                          want_residuals=True)
    res, d, thr, cots, bg, _ = _bwd_inputs(
        {k: v.numpy() for k, v in res.items()}, bounce["cols"], BG, seed=2)
    kw = dict(mat_types=tscene.mat_types, n_prims=tscene.num_prims)
    monkeypatch.setattr(fbb, "launches", 0)
    got = fbb.fused_bounce_bwd(res, d, thr, cots, bg, **kw)
    ref = fbb.fused_bounce_bwd_plain(res, d, thr, cots, bg, **kw)
    for k in fbb._GRAD_KEYS:
        assert torch.equal(got[0][k], ref[0][k]), k
    assert torch.equal(got[1], ref[1]) and torch.equal(got[2], ref[2])
    assert fbb.launches == 0

    meta = {k: v.to("meta") for k, v in res.items()}
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fbb.fused_bounce_bwd(meta, [x.to("meta") for x in d],
                             [x.to("meta") for x in thr],
                             {k: v.to("meta") for k, v in cots.items()},
                             bg.to("meta"), **kw)
    with pytest.raises(ValueError, match="tensors on"):
        fbb.fused_bounce_bwd(meta, d, thr, cots, bg, **kw)
    with pytest.raises(TypeError, match="int32"):
        fbb.fused_bounce_bwd(dict(res, flags=res["flags"].long()), d, thr,
                             cots, bg, **kw)
    with pytest.raises(ValueError, match="shape"):
        fbb.fused_bounce_bwd(dict(res, t=res["t"][:5]), d, thr, cots, bg, **kw)
    with pytest.raises(ValueError, match="cotangents"):
        fbb.fused_bounce_bwd(res, d, thr, {"o0": cots["o0"]}, bg, **kw)
    with pytest.raises(ValueError, match="primitives"):
        fbb.fused_bounce_bwd(res, d, thr, cots, bg, mat_types=tscene.mat_types,
                             n_prims=0)


def test_fused_bounce_diff_ok():
    """Perlin has no backward: the differentiable bounce takes solid and
    checker textures only, as the JAX package's gate does."""
    for name in ("CornellBox", "TriangleTest", "TwoSphereCheckers", "LightTest"):
        want = jfb.fused_bounce_diff_ok(j_get_scene(name).build())
        assert fb.fused_bounce_diff_ok(get_scene(name).build()) == want, name
    assert fb.fused_bounce_ok(t_full_scene())
    assert not fb.fused_bounce_diff_ok(t_full_scene())
    assert not fb.fused_bounce_diff_ok(
        dataclasses.replace(get_scene("CornellBox").build(), shade_static=False))


# ---------------------------------------------------------------------------
# the kernel source, built with g++ on an emulated card
# ---------------------------------------------------------------------------

# chip_smoke.py's tolerance of K2's reductions against the plain version:
# the same values summed in another order (1e-5 rel + 1e-5 of the largest)
K2_RTOL, K2_ATOL_REL = 1e-5, 1e-5
EMU_PRIMS = 20  # CornellBox's width: up to 60 keys, so a warp can hold 32
EMU_LANES = 256 * 6 + 17  # seven tiles, the last warp ragged


def _emu_bwd_inputs():
    """K2's arguments on EMU_LANES lanes: one bounce's residuals of the
    full scene, whose flags each warp of 32 lanes rewrites by its index w:
    w % 4 == 0, one key (hit, emission on) on every lane; 1, 32 distinct
    keys; 2, all misses (alive, no hit); 3, the bounce's own flags."""
    scene = t_full_scene()
    cols, uni = _random_lanes(EMU_LANES, seed=17)
    tcols, tuni = _t_inputs(cols, uni)
    _, res = fb.fused_bounce_cols_plain(
        fb.pack_prims_shaded(scene), torch.tensor(BG), scene.textures.perlin_seed,
        tcols, *tuni, kinds=scene.kinds_static, mat_types=scene.mat_types,
        tex_types=scene.tex_types, t_min=T_MIN, want_residuals=True)
    flags = res["flags"].numpy().copy()
    low = ((1 << fb.FLG_BESTI_SHIFT) - 1) & ~(fb.FLG_IS_CK | fb.FLG_SINES_NEG)
    group_bits = (0, fb.FLG_IS_CK | fb.FLG_SINES_NEG, fb.FLG_IS_CK)
    lanes = np.arange(EMU_LANES)
    w = lanes // 32
    key = np.where(w % 4 == 0, (w * 7) % (3 * EMU_PRIMS), lanes % 32)
    hit_bits = np.asarray(group_bits)[key // EMU_PRIMS] | fb.FLG_HIT | fb.FLG_LIGHT_ON
    forced = (flags & low) | hit_bits | ((key % EMU_PRIMS) << fb.FLG_BESTI_SHIFT)
    flags = np.where(w % 4 < 2, forced, flags)
    flags = np.where(w % 4 == 2, fb.FLG_ALIVE, flags).astype(np.int32)
    res_np = {k: v.numpy() for k, v in res.items()}
    res_np["flags"] = flags
    return _bwd_inputs(res_np, cols, BG, seed=4)[:5], scene.mat_types


def _launch_emulated_bwd(lib, args, mat_types):
    """``fused_bounce_bwd._launch``'s call, on CPU tensors."""
    import ctypes

    res, d, thr, cots, bg = args
    ins = ([res[k] for k in fb._RES_KEYS] + list(d) + list(thr)
           + [cots[k] for k in fbb._COT_KEYS])
    R, n_slots = EMU_LANES, 9 * EMU_PRIMS + 3
    outs = torch.empty((len(fbb._GRAD_KEYS), R))
    n_blocks = lib.fused_bounce_bwd_blocks(R, EMU_PRIMS)
    buf = torch.full((n_slots * (n_blocks + 1),), float("nan"))
    err = lib.fused_bounce_bwd_launch(
        (ctypes.c_void_p * len(ins))(*[x.contiguous().data_ptr() for x in ins]),
        (ctypes.c_void_p * len(outs))(*[x.data_ptr() for x in outs]), bg.data_ptr(),
        fb._type_flags(mat_types, fb._MAT_BITS, "material"), EMU_PRIMS,
        buf[n_slots:].data_ptr(), buf.data_ptr(), R, None)
    assert err == 0
    return outs, buf[:n_slots].clone(), n_blocks


def test_emulated_kernel_source_matches_plain(tmp_path):
    """``ops/csrc/fused_bounce_bwd.cu`` built with g++ against
    tests/cuda_emu.h (blocks of 256 threads, __syncthreads,
    __match_any_sync), its grid of 2 blocks walking 7 tiles, against
    ``fused_bounce_bwd_plain`` on lanes whose warps hold one key, 32
    distinct keys, only misses or the bounce's own mix, the last warp
    ragged: the 9 cotangent columns bit for bit (the same IEEE
    expressions; g++ contracts no multiply-add), the (9P + 3) reductions
    within K2_RTOL / K2_ATOL_REL (the same values summed in another
    order) and bit-equal across two runs."""
    from test_torch_projected_rows import emu_build

    src = (CSRC / "fused_bounce_bwd.cu").read_text()
    src, n_smem = re.subn(r"extern __shared__ float s_rows\[\];",
                          "static float s_rows[WARPS * (9 * MAX_PRIMS + 3)];", src)
    lib, n_launch = emu_build(tmp_path, "fused_bounce_bwd", src)
    assert n_launch == 2 and n_smem == 1
    args, mat_types = _emu_bwd_inputs()
    outs, red, n_blocks = _launch_emulated_bwd(lib, args, mat_types)
    outs2, red2, _ = _launch_emulated_bwd(lib, args, mat_types)
    assert n_blocks == 2
    grads, g_tex, g_bg = fbb.fused_bounce_bwd_plain(*args, mat_types=mat_types,
                                                    n_prims=EMU_PRIMS)
    want = torch.stack([grads[k] for k in fbb._GRAD_KEYS])
    assert torch.equal(outs.view(torch.int32), want.view(torch.int32))
    assert torch.equal(outs2.view(torch.int32), outs.view(torch.int32))
    assert torch.equal(red.view(torch.int32), red2.view(torch.int32))
    plain = torch.cat([g_tex.reshape(-1), g_bg]).double()
    scale = float(plain.abs().max())
    assert scale > 1.0 and int((plain != 0).sum()) > 3 * EMU_PRIMS
    assert ((red.double() - plain).abs()
            <= K2_RTOL * plain.abs() + K2_ATOL_REL * scale).all()
