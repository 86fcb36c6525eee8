"""SphereField and ModelTest, the scenes of more than 128 primitives, on
the port against the JAX package, on the CPU.

Both builders take their native C++ BVH (the same source, built with g++
at first use) by default, and so put the primitives in the same order:
``test_default_render_matches_jax_default`` holds the two default
renders together.  The other parity tests pin both builders to
``build_bvh_numpy`` (the ``numpy_bvh`` fixture), the oracle the JAX
package's own tests hold its native builder to.  Tolerances and why:

* scene tables, the BVH arrays and the projected tables are EQUAL: the
  same numpy code on the same inputs;
* forward renders hold the image contract (``utils.image.image_agreement``:
  mean within 1% relative, >= 90% of pixels within 1e-4 relative, no
  NaN), as the ported goldens do: one random stream on both sides, and a
  pixel differs only where a last-bits t difference (the projections'
  summation order, see test_torch_projected.py) flips a discrete choice;
* the differentiable step is the port's K5 search (Woop triangles,
  projected spheres) against JAX's CPU search, the BVH walk of
  Moller-Trumbore and the brute quadratic: hit distances differ by
  ~1e-6 relative, so the loss is held within 2e-3 relative and each
  gradient leaf within rtol 0.05 + 2e-3 of the largest
  (tests/test_torch_grad.py's tolerance); central finite differences of
  the port's own loss check its texture and background gradients, on
  which no discrete decision depends, to rtol 1e-2.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rust_pathtracer_tpu.scene.builder as j_builder
import rust_pathtracer_tpu_torch.scene.builder as t_builder
from rust_pathtracer_tpu.bvh import build_bvh_numpy as j_build_bvh_numpy
from rust_pathtracer_tpu.grad import CameraParams as JCameraParams
from rust_pathtracer_tpu.grad import DiffParams as JDiffParams
from rust_pathtracer_tpu.grad import render_loss_and_grad as j_render_loss_and_grad
from rust_pathtracer_tpu.models import get_scene as j_get_scene
from rust_pathtracer_tpu.render import RenderSettings as JRenderSettings
from rust_pathtracer_tpu.render import render_radiance as j_render_radiance
from rust_pathtracer_tpu_torch import cli, integrator, sampling
from rust_pathtracer_tpu_torch.bvh import build_bvh_numpy as t_build_bvh_numpy
from rust_pathtracer_tpu_torch.grad import (
    CameraParams,
    DiffParams,
    diff_params_from_numpy,
    l2_loss,
    render_loss_and_grad,
)
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.ops import projected
from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
from rust_pathtracer_tpu_torch.scene import scene_from_numpy
from rust_pathtracer_tpu_torch.scene.obj_loader import write_benchmark_obj
from rust_pathtracer_tpu_torch.utils.image import image_agreement
from test_torch_projected import PROJ_ARRAYS, PROJ_STATIC

torch.set_num_threads(2)

GROUPS = ("prims", "materials", "textures")
STATIC = ("prim_types", "tex_types", "mat_types", "kinds_static", "shade_static",
          "checker_depth", "leaf_size")
SF_CAM = ((12.0, 1.0, 0.0), (0.0, 0.5, 0.0), (0.0, 1.0, 0.0), 20.0, 854.0 / 480.0,
          0.1, 10.0)
CAMERA_FIELDS = ("lookfrom", "lookat", "up", "vfov_deg", "aspect", "aperture",
                 "focus_dist")


@pytest.fixture
def numpy_bvh(monkeypatch):
    """Both builders on their numpy BVH."""
    monkeypatch.setattr(j_builder, "build_bvh", j_build_bvh_numpy)
    monkeypatch.setattr(t_builder, "build_bvh", t_build_bvh_numpy)


@pytest.fixture(scope="module")
def obj_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("model") / "model.obj"
    write_benchmark_obj(str(path))
    return str(path)


def _scene_kwargs(name, obj_path):
    return {"obj_path": obj_path} if name == "ModelTest" else {}


def _jax_arrays(jscene):
    """A JAX SceneData as (numpy leaves by path, static fields)."""
    arrays = {f"{g}.{k}": np.asarray(v) for g in GROUPS
              for k, v in getattr(jscene, g)._asdict().items()}
    static = {k: getattr(jscene, k) for k in STATIC}
    if jscene.bvh is not None:
        arrays.update({f"bvh.{k}": np.asarray(v) for k, v in jscene.bvh._asdict().items()})
    if jscene.proj is not None:
        arrays.update({f"proj.{k}": np.asarray(getattr(jscene.proj, k))
                       for k in PROJ_ARRAYS})
        static.update({f"proj.{k}": getattr(jscene.proj, k) for k in PROJ_STATIC})
    return arrays, static


def _assert_scene_equal(tscene, jscene):
    arrays, static = _jax_arrays(jscene)
    for path, want in arrays.items():
        group, name = path.split(".")
        got = getattr(getattr(tscene, group), name)
        if name == "perlin_seed":
            assert got == int(want)
            continue
        got = got.numpy()
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=path)
    for k in STATIC:
        assert getattr(tscene, k) == static[k], k
    for k in PROJ_STATIC:
        assert getattr(tscene.proj, k) == static[f"proj.{k}"], k


@pytest.mark.parametrize("name", ["SphereField", "ModelTest"])
def test_scene_tables_match_jax(name, numpy_bvh, obj_path):
    """Every array and static field of the two builders equal, the BVH
    and the projected tables included; kinds_static is None."""
    kw = _scene_kwargs(name, obj_path)
    jscene = j_get_scene(name, **kw).build()
    tscene = get_scene(name, **kw).build()
    assert tscene.kinds_static is None and tscene.leaf_size == 4
    assert tscene.proj.shade_ready
    _assert_scene_equal(tscene, jscene)
    assert projected.default_route(tscene.proj) == "resident"


def test_scene_from_numpy_round_trip(numpy_bvh):
    """A JAX SphereField carried across equals the port's own build, and
    renders the same image; a partial set of bvh.* leaves raises."""
    jscene = j_get_scene("SphereField").build()
    arrays, static = _jax_arrays(jscene)
    carried = scene_from_numpy(arrays, static)
    own = get_scene("SphereField").build()
    _assert_scene_equal(carried, jscene)
    _assert_scene_equal(own, jscene)
    settings = RenderSettings(12, 8, 2, 4, (1.0, 1.0, 1.0))
    cam = get_scene("SphereField").camera_at(0.0)
    a, _ = render_radiance(carried, cam, settings, sampling.prng_key(4), device="cpu")
    b, _ = render_radiance(own, cam, settings, sampling.prng_key(4), device="cpu")
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="missing"):
        scene_from_numpy({k: v for k, v in arrays.items() if k != "bvh.miss"}, static)
    with pytest.raises(ValueError, match="missing"):
        scene_from_numpy({k: v for k, v in arrays.items() if k != "proj.const"}, static)


@pytest.mark.parametrize("name,w,h,spp,nb", [("SphereField", 32, 18, 4, 10),
                                             ("ModelTest", 16, 16, 2, 6)])
def test_forward_matches_jax_projected_route(name, w, h, spp, nb, numpy_bvh,
                                             monkeypatch, obj_path):
    """The forward render against JAX's with RPT_PROJ_INTERPRET=1 (its
    TPU route: K6 in the Pallas interpreter, payload shading, the
    wavefront reorder), at tests/test_render_scenes.py's SphereField size,
    under the image contract; ray segments within 1%."""
    monkeypatch.setenv("RPT_PROJ_INTERPRET", "1")
    kw = _scene_kwargs(name, obj_path)
    jsd, sd = j_get_scene(name, **kw), get_scene(name, **kw)
    bg = sd.output.image.background
    jimg, jst = j_render_radiance(jsd.build(), jsd.camera_at(0.0),
                                  JRenderSettings(w, h, spp, nb, bg, spp_chunk=spp),
                                  jax.random.PRNGKey(0))
    img, st = render_radiance(sd.build(), sd.camera_at(0.0),
                              RenderSettings(w, h, spp, nb, bg, spp_chunk=spp),
                              sampling.prng_key(0), device="cpu")
    a = image_agreement(img.numpy(), np.asarray(jimg))
    assert a["ok"], a
    assert abs(float(st.segments) - float(jst.segments)) <= 0.01 * float(jst.segments)
    assert st.bounces <= nb


@pytest.mark.parametrize("name,w,h,spp,nb", [("SphereField", 32, 18, 4, 10),
                                             ("ModelTest", 16, 16, 2, 6)])
def test_default_render_matches_jax_default(name, w, h, spp, nb, monkeypatch, obj_path):
    """Neither builder pinned: both take their native BVH, and the
    port's default tables (the primitive order, the BVH, the projected
    tables) equal JAX's default ones; the forward render against JAX's
    (RPT_PROJ_INTERPRET=1, as test_forward_matches_jax_projected_route)
    under the image contract, ray segments within 1%."""
    monkeypatch.setenv("RPT_PROJ_INTERPRET", "1")
    kw = _scene_kwargs(name, obj_path)
    jsd, sd = j_get_scene(name, **kw), get_scene(name, **kw)
    jscene, tscene = jsd.build(), sd.build()
    _assert_scene_equal(tscene, jscene)
    bg = sd.output.image.background
    jimg, jst = j_render_radiance(jscene, jsd.camera_at(0.0),
                                  JRenderSettings(w, h, spp, nb, bg, spp_chunk=spp),
                                  jax.random.PRNGKey(0))
    img, st = render_radiance(tscene, sd.camera_at(0.0),
                              RenderSettings(w, h, spp, nb, bg, spp_chunk=spp),
                              sampling.prng_key(0), device="cpu")
    a = image_agreement(img.numpy(), np.asarray(jimg))
    assert a["ok"], a
    assert abs(float(st.segments) - float(jst.segments)) <= 0.01 * float(jst.segments)


def test_cli_bvh_off_applies_to_builtin_scenes(tmp_path, monkeypatch):
    """The port's ``--bvh`` and ``--leaf-size`` reach the built-in
    scenes: ``--bvh off`` builds SphereField without a BVH (its
    primitives in declaration order, leaf size 0), ``--leaf-size`` sets
    the leaves.
    This differs from the reference CLI, which passes ``use_bvh`` only
    to ``--scene-json`` scenes and never reads ``--leaf-size``
    (rust_pathtracer_tpu/cli.py:41, :179-183), a defect the port does
    not copy."""
    from rust_pathtracer_tpu_torch import models

    built = []
    get = models.get_scene

    def spy(*a, **k):
        sd = get(*a, **k)
        built.append(sd.build())
        return sd

    monkeypatch.setattr(models, "get_scene", spy)
    for flags, want_bvh, leaf in ((["--bvh", "off"], False, 0),
                                  (["--bvh", "on", "--leaf-size", "2"], True, 2)):
        built.clear()
        rc = cli.main(["--scene", "SphereField", *flags, "--width", "6", "--height", "4",
                       "--spp", "1", "--max-bounces", "2", "--device", "cpu",
                       "--output-dir", str(tmp_path)])
        assert rc == 0 and len(built) == 1
        assert (built[0].bvh is not None) == want_bvh and built[0].leaf_size == leaf
    off, on = built[0], get_scene("SphereField").build()
    assert not torch.equal(off.prims.data, on.prims.data)  # BVH order vs declaration


def _leaves(p):
    out = {"tex_color": p.tex_color, "tex_images": p.tex_images,
           "background": p.background}
    out.update({f"camera.{f}": getattr(p.camera, f) for f in CAMERA_FIELDS})
    return {k: np.asarray(v.detach() if isinstance(v, torch.Tensor) else v)
            for k, v in out.items()}


W, H, SPP, BOUNCES, BG = 16, 9, 2, 4, (1.0, 1.0, 1.0)


@pytest.fixture(scope="module")
def jax_step():
    """JAX's SphereField loss and gradients, 16x9, 2 spp, 4 bounces, on
    the numpy BVH."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(j_builder, "build_bvh", j_build_bvh_numpy)
        jscene = j_get_scene("SphereField").build()
    settings = JRenderSettings(W, H, SPP, BOUNCES, BG, differentiable=True)
    params = JDiffParams.from_scene(jscene, JCameraParams.create(*SF_CAM), BG)
    loss, grads = j_render_loss_and_grad(params, jscene, settings, jax.random.PRNGKey(0),
                                         jnp.zeros((H, W, 3)))
    return _leaves(params), float(loss), _leaves(grads)


def test_spherefield_step_matches_jax(jax_step, numpy_bvh, monkeypatch):
    """render_loss_and_grad through K5's plain version: the loss and
    every gradient leaf against JAX's; K5 searches, K4 does not."""
    jparams, jloss, jg = jax_step
    calls = []
    search = projected.projected_sweep

    def spy(*a, **k):
        calls.append(1)
        return search(*a, **k)

    monkeypatch.setattr(projected, "projected_sweep", spy)
    scene = get_scene("SphereField").build()
    loss, g = render_loss_and_grad(diff_params_from_numpy(jparams), scene,
                                   RenderSettings(W, H, SPP, BOUNCES, BG),
                                   sampling.prng_key(0), torch.zeros(H, W, 3),
                                   device="cpu")
    assert len(calls) == BOUNCES
    np.testing.assert_allclose(float(loss), jloss, rtol=2e-3)
    got = _leaves(g)
    scale = max(np.abs(v).max() for v in jg.values())
    assert np.abs(jg["background"]).min() > 0.01
    # solid colours and a checker (piecewise constant): the camera's
    # gradient is zero on both sides
    assert np.abs(jg["tex_color"]).max() > 0.01
    for k in jg:
        np.testing.assert_allclose(got[k], jg[k], rtol=0.05, atol=2e-3 * scale,
                                   err_msg=k)


def test_spherefield_step_finite_differences():
    """The gradients of the background and of the three texture colours
    with the largest gradient against central differences of the port's
    own loss (f64 steps of 1e-2 on an f32 loss; no discrete decision
    depends on them, so the loss is smooth there)."""
    scene = get_scene("SphereField").build()
    settings = RenderSettings(W, H, SPP, BOUNCES, BG)
    target = torch.full((H, W, 3), 0.3)
    params = DiffParams.from_scene(scene, CameraParams.create(*SF_CAM), BG)
    key = sampling.prng_key(2)
    _, g = render_loss_and_grad(params, scene, settings, key, target, device="cpu")

    def loss_at(leaf, idx, delta):
        x = getattr(params, leaf).clone()
        x.view(-1)[idx] += delta
        p = dataclasses.replace(params, **{leaf: x})
        with torch.no_grad():
            return float(l2_loss(p, scene, dataclasses.replace(settings, differentiable=True),
                                 key, target, device="cpu"))

    top = torch.topk(g.tex_color.abs().view(-1), 3).indices.tolist()
    checks = [("background", i) for i in range(3)] + [("tex_color", i) for i in top]
    for leaf, idx in checks:
        eps = 1e-2
        fd = (loss_at(leaf, idx, eps) - loss_at(leaf, idx, -eps)) / (2 * eps)
        got = float(getattr(g, leaf).view(-1)[idx])
        assert abs(got) > 1e-4, (leaf, idx)
        np.testing.assert_allclose(got, fd, rtol=1e-2, err_msg=f"{leaf}[{idx}]")


@pytest.mark.parametrize("name", ["SphereField", "ModelTest"])
def test_big_scene_routes(name, monkeypatch, obj_path):
    """Forward: the projected record route with the payload shading;
    differentiable: K5 and the table shading; neither takes K3, K4 or
    the fused route."""
    from rust_pathtracer_tpu_torch.ops import closest_hit

    calls = []
    for mod, fn in ((projected, "closest_hit_record_projected"),
                    (projected, "closest_hit_projected"),
                    (closest_hit, "closest_hit"), (closest_hit, "closest_hit_record"),
                    (integrator, "_trace_fused")):
        orig = getattr(mod, fn)

        def spy(*a, _orig=orig, _fn=fn, **k):
            calls.append(_fn)
            return _orig(*a, **k)

        monkeypatch.setattr(mod, fn, spy)
        if hasattr(integrator, fn):
            monkeypatch.setattr(integrator, fn, spy)
    sd = get_scene(name, **_scene_kwargs(name, obj_path))
    scene = sd.build()
    for diff, want in ((False, "closest_hit_record_projected"),
                       (True, "closest_hit_projected")):
        calls.clear()
        settings = RenderSettings(6, 4, 1, 3, (1.0, 1.0, 1.0), differentiable=diff)
        img, st = render_radiance(scene, sd.camera_at(0.0), settings,
                                  sampling.prng_key(5), device="cpu")
        assert torch.isfinite(img).all() and set(calls) == {want}, calls


def test_streamed_model_renders_on_pairs_route(tmp_path, monkeypatch):
    """A 20,000-triangle mesh (20,480 columns, streamed tables) takes the
    pair route: K7 where no block overflows, K5 where one does.  Its
    image against the dense route's (K5 on every bounce) under the image
    contract: on a streamed table K5 compares the ground sphere in t and
    K7 in q, which may differ in the last bits."""
    path = tmp_path / "m20k.obj"
    write_benchmark_obj(str(path), rows=101, cols=100)
    sd = get_scene("ModelTest", obj_path=str(path))
    scene = sd.build()
    assert scene.proj.num_cols == 20480 and scene.proj.col_block == projected.COL_BLOCK
    assert projected.default_route(scene.proj) == "pairs"
    settings = RenderSettings(8, 8, 1, 6, (1.0, 1.0, 1.0))
    img, _ = render_radiance(scene, sd.camera_at(0.0), settings, sampling.prng_key(6),
                             device="cpu")
    monkeypatch.setattr(projected, "default_route", lambda tables: "dense")
    img_dense, _ = render_radiance(scene, sd.camera_at(0.0), settings,
                                   sampling.prng_key(6), device="cpu")
    a = image_agreement(img.numpy(), img_dense.numpy())
    assert a["ok"], a


def test_cli_renders_big_scenes(tmp_path, capsys, obj_path):
    for argv in (["--scene", "SphereField"],
                 ["--scene", "ModelTest", "--obj-path", obj_path, "--leaf-size", "2"]):
        out = tmp_path / argv[1]
        rc = cli.main(argv + ["--width", "8", "--height", "6", "--spp", "1",
                              "--max-bounces", "3", "--device", "cpu",
                              "--output-dir", str(out)])
        assert rc == 0 and (out / "image_0000.png").exists()
        assert "segments/s=" in capsys.readouterr().out
