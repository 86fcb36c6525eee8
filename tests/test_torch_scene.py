"""The port's scene tables, camera and camera lanes against the JAX package.

Tables are host-built from the same Python values, so they must be
EQUAL (builder arrays, static routing fields, the packed shading
table).  Camera frames and rays go through f32 tan / normalize and
agree within 4 ulp (rtol 1e-6); lane keys are bit-equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_pathtracer_tpu import render as jrender
from rust_pathtracer_tpu.camera import camera_rays as j_camera_rays
from rust_pathtracer_tpu.camera import make_camera as j_make_camera
from rust_pathtracer_tpu.models import get_scene as j_get_scene
from rust_pathtracer_tpu.ops.fused_bounce import pack_prims_shaded as j_pack
from rust_pathtracer_tpu_torch import render as trender
from rust_pathtracer_tpu_torch.camera import camera_rays as t_camera_rays
from rust_pathtracer_tpu_torch.camera import make_camera as t_make_camera
from rust_pathtracer_tpu_torch.models import get_scene as t_get_scene
from rust_pathtracer_tpu_torch.ops.fused_bounce import fused_bounce_ok
from rust_pathtracer_tpu_torch.ops.fused_bounce import pack_prims_shaded as t_pack
from rust_pathtracer_tpu_torch.sampling import prng_key
from rust_pathtracer_tpu_torch.scene import SceneBuilder, scene_from_numpy

torch.set_num_threads(2)

SCENES = ("CornellBox", "TriangleTest", "TwoSphereCheckers", "LightTest")
STATIC = ("prim_types", "tex_types", "mat_types", "kinds_static", "shade_static",
          "checker_depth")
GROUPS = ("prims", "materials", "textures")


def _jax_leaves(scene):
    """A JAX SceneData as (numpy leaves by field path, static fields)."""
    arrays = {
        f"{g}.{name}": np.asarray(val)
        for g in GROUPS
        for name, val in getattr(scene, g)._asdict().items()
    }
    return arrays, {k: getattr(scene, k) for k in STATIC}


def _assert_tables_equal(jscene, tscene):
    arrays, static = _jax_leaves(jscene)
    for g in GROUPS:
        tgroup = getattr(tscene, g)
        for name in ("kind", "mat", "aux", "data", "tex", "fuzz", "ir",
                     "color", "child", "scale", "image_id", "images", "image_hw"):
            path = f"{g}.{name}"
            if not hasattr(tgroup, name):
                continue
            got = getattr(tgroup, name).numpy()
            assert got.dtype == arrays[path].dtype, path
            np.testing.assert_array_equal(got, arrays[path], err_msg=path)
    assert tscene.textures.perlin_seed == int(arrays["textures.perlin_seed"])
    for k in STATIC:
        assert getattr(tscene, k) == static[k], k


@pytest.mark.parametrize("name", SCENES)
def test_builder_tables_equal(name):
    jscene = j_get_scene(name).build()
    tscene = t_get_scene(name).build()
    _assert_tables_equal(jscene, tscene)
    assert fused_bounce_ok(tscene)
    np.testing.assert_array_equal(t_pack(tscene).numpy(),
                                  np.asarray(j_pack(jscene)))


@pytest.mark.parametrize("name", SCENES)
def test_scene_from_numpy_carries_jax_scene(name):
    jscene = j_get_scene(name).build()
    arrays, static = _jax_leaves(jscene)
    carried = scene_from_numpy(arrays, static)
    _assert_tables_equal(jscene, carried)
    own = t_get_scene(name).build()
    np.testing.assert_array_equal(t_pack(carried).numpy(), t_pack(own).numpy())


def test_image_scene_carries_jax_scene():
    """An image-textured scene with a nested checker: the builders'
    tables equal, and scene_from_numpy carries the JAX scene's image
    leaves; an unknown or a missing leaf raises."""
    from rust_pathtracer_tpu.scene.builder import SceneBuilder as JSceneBuilder

    def build(builder):
        b = builder()
        ramp = np.linspace(0.1, 0.9, 4 * 6 * 3).reshape(4, 6, 3).astype(np.float32)
        img = b.image_texture(ramp)
        ck = b.checker_texture(b.solid_texture((0.1, 0.2, 0.3)), img, 4.0)
        b.add_sphere((0, 0, -1), 0.5, b.lambertian(b.checker_texture(ck, img)))
        b.add_sphere((0, -100.5, -1), 100.0, b.lambertian(img))
        return b.build(use_bvh=False)

    jscene, tscene = build(JSceneBuilder), build(SceneBuilder)
    _assert_tables_equal(jscene, tscene)
    assert tscene.checker_depth == 2 and not tscene.shade_static
    arrays, static = _jax_leaves(jscene)
    _assert_tables_equal(jscene, scene_from_numpy(arrays, static))
    with pytest.raises(ValueError, match="unknown"):
        scene_from_numpy({**arrays, "textures.extra": np.zeros(1)}, static)
    with pytest.raises(ValueError, match="missing"):
        scene_from_numpy({k: v for k, v in arrays.items() if k != "textures.images"},
                         static)


def test_not_ported_yet_raises():
    """SphereField and ModelTest build now, with a BVH past 64 primitives
    and the projected tables past 128; a geometry gradient under the
    default hit distance ("analytic", linearised in the ray) raises on
    such a scene, naming ``diff_t="rederive"``, which takes it.  The
    cascade renderer, which raised before it was ported, renders the
    chunked image bit for bit."""
    import dataclasses

    from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance

    sd = t_get_scene("SphereField")
    scene = sd.build()
    assert scene.kinds_static is None and scene.proj is not None
    assert scene.bvh is not None and scene.leaf_size == 4
    b = SceneBuilder()
    m = b.lambertian((0.5, 0.5, 0.5))
    for i in range(65):
        b.add_sphere((i, 0, -1), 0.5, m)
    mid = b.build()
    assert mid.bvh is not None and mid.kinds_static is not None and mid.proj is None
    assert b.build(use_bvh=False).bvh is None
    settings = RenderSettings(4, 3, 1, 2, (1.0, 1.0, 1.0))
    want, st = render_radiance(scene, sd.camera_at(0.0), settings, prng_key(0),
                               device="cpu")
    img, st2 = render_radiance(scene, sd.camera_at(0.0),
                               dataclasses.replace(settings, cascade=True), prng_key(0),
                               device="cpu")
    assert torch.equal(img, want) and torch.equal(st2.occupancy, st.occupancy)
    prims = dataclasses.replace(scene.prims,
                                data=scene.prims.data.clone().requires_grad_(True))
    with pytest.raises(NotImplementedError, match='diff_t="rederive"'):
        render_radiance(dataclasses.replace(scene, prims=prims), sd.camera_at(0.0),
                        dataclasses.replace(settings, differentiable=True),
                        prng_key(0), device="cpu")


CAMERAS = [
    ((278.0, 278.0, -800.0), (278.0, 278.0, 0.0), (0.0, 1.0, 0.0), 40.0, 1.0, 0.0, 10.0),
    ((13.0, 2.0, 3.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 20.0, 854.0 / 480.0, 0.0, 10.0),
    ((12.0, 1.0, 0.0), (0.0, 0.5, 0.0), (0.0, 1.0, 0.0), 20.0, 854.0 / 480.0, 0.1, 10.0),
]


@pytest.mark.parametrize("args", CAMERAS)
def test_camera_and_rays_close(args):
    """Camera frame and rays within 4 ulp; the third camera has a lens
    (aperture 0.1), so the disk sample and blur are exercised too."""
    jcam = j_make_camera(*args)
    tcam = t_make_camera(*args)
    for f in ("origin", "lower_left_corner", "horizontal", "vertical", "u",
              "v", "lens_radius"):
        np.testing.assert_allclose(getattr(tcam, f).numpy(),
                                   np.asarray(getattr(jcam, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    rng = np.random.default_rng(5)
    s, t = rng.random((2, 400)).astype(np.float32)
    keys = rng.integers(0, 2**32, (400, 2), dtype=np.uint64).astype(np.uint32)
    jo, jd = j_camera_rays(jcam, jnp.asarray(s), jnp.asarray(t), jnp.asarray(keys))
    to, td = t_camera_rays(tcam, torch.from_numpy(s), torch.from_numpy(t),
                           torch.from_numpy(keys.astype(np.int64)))
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-6, atol=1e-5)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("name,offset", [("CornellBox", 0), ("TwoSphereCheckers", 8)])
def test_make_lanes_close(name, offset):
    """Camera lanes of a chunk, including a padded final chunk (samples
    8-11 of 10): keys bit-equal, in_range equal, rays within 4 ulp."""
    w, h, spp_chunk, spp_total = 12, 8, 4, 10
    jcam = j_get_scene(name).camera_at(0.0)
    tcam = t_get_scene(name).camera_at(0.0)
    pix = np.arange(w * h, dtype=np.uint32)
    jl = jrender._make_lanes(jcam, jnp.asarray([0, 1234], jnp.uint32),
                             jnp.asarray(pix), jnp.uint32(offset), width=w,
                             height=h, spp_chunk=spp_chunk, spp_total=spp_total)
    tl = trender._make_lanes(tcam, prng_key(1234),
                             torch.from_numpy(pix.astype(np.int64)), offset,
                             width=w, height=h, spp_chunk=spp_chunk,
                             spp_total=spp_total)
    np.testing.assert_array_equal(tl[0].numpy(), np.asarray(jl[0]).astype(np.int64))
    np.testing.assert_allclose(tl[1].numpy(), np.asarray(jl[1]), rtol=1e-6)
    np.testing.assert_allclose(tl[2].numpy(), np.asarray(jl[2]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(tl[3].numpy(), np.asarray(jl[3]))
    assert tl[3].sum().item() == w * h * (2 if offset else 4)


@pytest.mark.parametrize("w,h,spp,chunk", [(400, 400, 1000, None), (512, 512, 4, None),
                                           (64, 64, 16, 16), (33, 7, 5, 9)])
def test_resolve_chunk_matches(w, h, spp, chunk):
    args = (w, h, spp, 20, (0.0, 0.0, 0.0), chunk)
    assert (trender.RenderSettings(*args).resolve_chunk()
            == jrender.RenderSettings(*args).resolve_chunk())
