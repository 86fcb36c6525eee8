"""K1's residual outputs and K2's plain version against the JAX package.

The same numpy inputs go through the port's plain versions and through
the JAX package's Pallas kernels, run by the Pallas interpreter
(``interpret=True``, as the JAX package's own tests run them on the
CPU), and through ``_bwd_xla``, the JAX package's jnp twin of the
backward kernel.  The CUDA kernels are held against the plain versions
by ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` on the card.
"""

import dataclasses

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
