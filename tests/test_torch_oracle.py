"""The f64 oracle gate on the port's renders, on the CPU.

``tests/oracle.py`` is the reference semantics in plain numpy f64, with
true rejection sampling and its own RNG: it shares no code with either
package.  The three cases of ``tests/test_oracle_parity.py`` run here
under the JAX package's own bounds, untouched, on each of the port's
renderers: the chunked render, the regeneration wavefront (a pool of
4,096 lanes, so that lanes refill) and the cascade ("auto").

* CornellBox 20x20, 192 spp, 12 bounces: the image mean within 6% of the
  mean of three 48-spp oracle seeds, the mean absolute pixel difference
  to the seed-1 image below 0.12;
* the light scene (a LightTest-shaped scene with solid ground), 20x20,
  256 spp, 10 bounces: 8% of the seed-2 oracle image's mean, MAD < 0.1;
* the triangle / metal / checker scene, 20x20, 384 spp, 8 bounces: 4%,
  MAD < 0.06.

Each oracle image is computed once a module.  ``test_key7_lane_follows_f64``
pins the one path on which the port and the JAX package parted on
CornellBox, key 7 (ROADMAP queue 3), with the f64 verdict.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from oracle import cornell_camera, cornell_prims, render_oracle
from rust_pathtracer_tpu import integrator as j_integrator
from rust_pathtracer_tpu import render as j_render
from rust_pathtracer_tpu.models import get_scene as j_get_scene
from rust_pathtracer_tpu_torch import integrator, sampling
from rust_pathtracer_tpu_torch.camera import make_camera
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.ops.closest_hit import closest_hit_record_plain, pack_prims
from rust_pathtracer_tpu_torch.render import RenderSettings, _make_lanes, render_radiance
from rust_pathtracer_tpu_torch.scene import SceneBuilder
from rust_pathtracer_tpu_torch.wavefront import render_radiance_regen

torch.set_num_threads(2)

RENDERERS = ("chunked", "regen", "cascade")
REGEN_LANES = 4096

LIGHT_PRIMS = [
    {"type": "sphere", "center": (0.0, -1000.0, 0.0), "radius": 1000.0,
     "mat": {"type": "lam", "color": (0.5, 0.5, 0.5)}},
    {"type": "sphere", "center": (0.0, 2.0, 0.0), "radius": 2.0,
     "mat": {"type": "lam", "color": (0.5, 0.5, 0.5)}},
    {"type": "rect", "axis": 2, "k": -2.0, "a0": 3.0, "a1": 5.0,
     "b0": 1.0, "b1": 3.0, "dir": 1.0,
     "mat": {"type": "light", "color": (4.0, 4.0, 4.0)}},
    {"type": "rect", "axis": 1, "k": 6.0, "a0": -1.0, "a1": 1.0,
     "b0": -1.0, "b1": 1.0, "dir": -1.0,
     "mat": {"type": "light", "color": (4.0, 4.0, 4.0)}},
    {"type": "rect", "axis": 0, "k": -6.0, "a0": 1.0, "a1": 3.0,
     "b0": -2.0, "b1": 2.0, "dir": 1.0,
     "mat": {"type": "light", "color": (4.0, 4.0, 4.0)}},
]
LIGHT_CAM = {"lookfrom": (26.0, 3.0, 6.0), "lookat": (0.0, 2.0, 0.0),
             "up": (0.0, 1.0, 0.0), "vfov": 20.0, "aspect": 1.0,
             "aperture": 0.0, "focus": 10.0}


def _triangles():
    tri = [
        dict(p1=(-2.0, 0.0, -1.5), p2=(2.0, 0.0, -1.5), p3=(0.0, 3.0, -0.5)),
        dict(p1=(2.5, 0.0, 1.0), p2=(4.5, 0.0, 0.0), p3=(3.5, 2.0, 0.5)),
    ]
    for t in tri:
        p1, p2, p3 = (np.asarray(t[k], float) for k in ("p1", "p2", "p3"))
        n = np.cross(p2 - p1, p3 - p1)
        t["normal"] = n / np.linalg.norm(n)
    return tri


TRI = _triangles()
TRI_PRIMS = [
    # ground off the sine-lattice node, as in test_oracle_parity.py
    {"type": "rect", "axis": 1, "k": 0.25, "a0": -20.0, "a1": 20.0,
     "b0": -20.0, "b1": 20.0, "dir": 1.0,
     "mat": {"type": "lam", "color": {"checker": ((0.9, 0.1, 0.1), (0.1, 0.1, 0.9), 2.0)}}},
    {"type": "sphere", "center": (-3.0, 1.0, 1.0), "radius": 1.0,
     "mat": {"type": "metal", "color": (0.8, 0.7, 0.6), "fuzz": 0.35}},
    {"type": "tri", **TRI[0], "mat": {"type": "lam", "color": (0.2, 0.7, 0.3)}},
    {"type": "tri", **TRI[1], "mat": {"type": "metal", "color": (0.9, 0.9, 0.9), "fuzz": 0.05}},
]
TRI_CAM = {"lookfrom": (0.0, 3.0, 9.0), "lookat": (0.0, 1.0, 0.0),
           "up": (0.0, 1.0, 0.0), "vfov": 45.0, "aspect": 1.0,
           "aperture": 0.0, "focus": 10.0}


def _cam(c):
    return make_camera(c["lookfrom"], c["lookat"], c["up"], c["vfov"], c["aspect"],
                       c["aperture"], c["focus"])


def _light_scene():
    b = SceneBuilder()
    gray = b.lambertian((0.5, 0.5, 0.5))
    b.add_sphere((0.0, -1000.0, 0.0), 1000.0, gray)
    b.add_sphere((0.0, 2.0, 0.0), 2.0, gray)
    light = b.diffuse_light((4.0, 4.0, 4.0))
    b.add_rect("xy", (3.0, 1.0, -2.0), (5.0, 3.0, -2.0), 1.0, light)
    b.add_rect("xz", (-1.0, 6.0, -1.0), (1.0, 6.0, 1.0), -1.0, light)
    b.add_rect("yz", (-6.0, 1.0, -2.0), (-6.0, 3.0, 2.0), 1.0, light)
    return b.build(use_bvh=False)


def _tri_scene():
    b = SceneBuilder()
    odd = b.solid_texture((0.9, 0.1, 0.1))
    even = b.solid_texture((0.1, 0.1, 0.9))
    ground = b.lambertian(b.checker_texture(odd, even, frequency=2.0))
    b.add_rect("xz", (-20.0, 0.25, -20.0), (20.0, 0.25, 20.0), 1.0, ground)
    b.add_sphere((-3.0, 1.0, 1.0), 1.0, b.metal((0.8, 0.7, 0.6), 0.35))
    b.add_triangle(TRI[0]["p1"], TRI[0]["p2"], TRI[0]["p3"], b.lambertian((0.2, 0.7, 0.3)))
    b.add_triangle(TRI[1]["p1"], TRI[1]["p2"], TRI[1]["p3"], b.metal((0.9, 0.9, 0.9), 0.05))
    return b.build(use_bvh=False)


# name -> (port scene, port camera, settings, oracle mean, oracle image, mean
# bound, MAD bound); the oracle parts at test_oracle_parity.py's settings
@functools.lru_cache(maxsize=None)
def _case(name):
    res = 20
    if name == "CornellBox":
        spp = 48
        imgs = {k: render_oracle(cornell_prims(), cornell_camera(), res, res, spp, 12,
                                 (0, 0, 0), seed=k) for k in (1, 2, 3)}
        sd = get_scene("CornellBox")
        return (sd.build(), sd.camera_at(0.0),
                RenderSettings(res, res, 4 * spp, 12, (0.0, 0.0, 0.0)),
                np.mean([im.mean() for im in imgs.values()]), imgs[1], 0.06, 0.12)
    if name == "light":
        spp = 64
        img = render_oracle(LIGHT_PRIMS, LIGHT_CAM, res, res, spp, 10, (0, 0, 0), seed=2)
        return (_light_scene(), _cam(LIGHT_CAM),
                RenderSettings(res, res, 4 * spp, 10, (0.0, 0.0, 0.0)),
                max(img.mean(), 1e-9), img, 0.08, 0.1)
    spp = 192
    img = render_oracle(TRI_PRIMS, TRI_CAM, res, res, spp, 8, (0.7, 0.8, 1.0), seed=5)
    return (_tri_scene(), _cam(TRI_CAM),
            RenderSettings(res, res, 2 * spp, 8, (0.7, 0.8, 1.0)),
            img.mean(), img, 0.04, 0.06)


def _render(renderer, scene, cam, settings):
    key = sampling.prng_key(0)
    if renderer == "regen":
        return render_radiance_regen(scene, cam, settings, key, lanes=REGEN_LANES,
                                     device="cpu")
    if renderer == "cascade":
        import dataclasses

        settings = dataclasses.replace(settings, cascade_schedule="auto")
    return render_radiance(scene, cam, settings, key, device="cpu")


@pytest.mark.parametrize("renderer", RENDERERS)
@pytest.mark.parametrize("name", ["CornellBox", "light", "triangle_metal_checker"])
def test_render_matches_oracle(name, renderer):
    """The port's render within the JAX package's oracle bounds."""
    scene, cam, settings, oracle_mean, oracle_img, mean_rtol, mad = _case(name)
    img, stats = _render(renderer, scene, cam, settings)
    ours = img.numpy().astype(np.float64)
    assert np.isfinite(ours).all() and float(stats.occupancy[-1]) == 0.0
    assert abs(ours.mean() - oracle_mean) / oracle_mean < mean_rtol, (ours.mean(), oracle_mean)
    assert np.abs(ours - oracle_img).mean() < mad


# CornellBox 20x20, 12 spp, 10 bounces, key 7 (tests/test_torch_wavefront.py):
# the lane of pixel 190, sample 4 (counter 2284), the only one on which the
# port's image and JAX's parted before the port took a sphere's roots in f64
K7_PIXEL, K7_SAMPLE, K7_SPP = 190, 4, 12
K7_SPHERE, K7_LIGHT = 18, 4  # CornellBox primitive indices: glass sphere 1, the light


def test_key7_lane_follows_f64():
    """The key-7 path in f64, from the camera ray both sides agree on bit
    for bit.  Bounce 0 meets glass sphere 1 near its rim (|d| = 10.02,
    cos 0.497 to the normal): half_b^2 - a c = 201,179.3 in f64, 201,168
    in plain f32 (450x cancellation), so the f32 root t = 90.01378 lands
    6.2e-4 inside the sphere, against 90.013659 in f64 (JAX's FMAs:
    90.013748, 4.4e-4 inside).  The Schlick coin (0.0515 < 0.0708)
    reflects; from 6.2e-4 inside the reflected ray meets the sphere again
    at t = 1.25e-3 > t_min, from 4.4e-4 at 8.8e-4 < t_min.  In f64 the
    reflected ray leaves the sphere and meets the light at t = 275.73:
    the f64 path follows JAX's, radiance 15.  The port now takes the
    roots in f64: its bounce-0 point is the f64 one to f32 rounding, and
    the lane reaches the light after two bounces, as JAX's does."""
    sd = get_scene("CornellBox")
    scene, cam = sd.build(), sd.camera_at(0.0)
    key = sampling.prng_key(7)
    lk, o, d, _ = _make_lanes(cam, key, torch.tensor([K7_PIXEL]), K7_SAMPLE, width=20,
                              height=20, spp_chunk=1, spp_total=K7_SPP)

    # f64: the port's plain closest hit on f64 tensors, and the scatter
    table64 = pack_prims(scene.prims).double()
    hit, t, idx, rec = closest_hit_record_plain(table64, o.double(), d.double(),
                                                kinds=scene.kinds_static,
                                                t_min=integrator.T_MIN)
    assert bool(hit[0]) and int(idx[0]) == K7_SPHERE and bool(rec.front_face[0])
    assert abs(float(t[0]) - 90.01365904434128) < 1e-9
    p64, n64 = rec.point[0].numpy(), rec.normal[0].numpy()
    ud = d[0].double().numpy() / np.linalg.norm(d[0].double().numpy())
    cos_t = min(float(-ud @ n64), 1.0)
    ratio = 1.0 / 1.5
    r0 = ((1.0 - ratio) / (1.0 + ratio)) ** 2
    coin = float(sampling.bounce_draws(lk, 0, False)[2][0])
    assert r0 + (1.0 - r0) * (1.0 - cos_t) ** 5 > coin  # reflect
    d1 = ud - 2.0 * (ud @ n64) * n64
    hit1, t1, idx1, rec1 = closest_hit_record_plain(
        table64, torch.from_numpy(p64[None]), torch.from_numpy(d1[None]),
        kinds=scene.kinds_static, t_min=integrator.T_MIN)
    assert bool(hit1[0]) and int(idx1[0]) == K7_LIGHT and bool(rec1.front_face[0])
    assert abs(float(t1[0]) - 275.7338) < 1e-3

    # the port in f32: bounce 0 lands on the f64 point, bounce 1 on the light
    ones, zeros = torch.ones((1, 3)), torch.zeros((1, 3))
    alive = torch.ones(1, dtype=torch.bool)
    st, _ = integrator.trace_resume(scene, o, d, ones, zeros, alive, lk, torch.zeros(3),
                                    0, 1)
    assert np.abs(st["o"][0].numpy() - p64).max() <= 5e-7 * np.abs(p64).max()
    st, n = integrator.trace_resume(scene, o, d, ones, zeros, alive, lk, torch.zeros(3),
                                    0, 2)
    assert n == 2 and not bool(st["alive"][0])
    assert st["rad"][0].tolist() == [15.0, 15.0, 15.0]

    # the JAX package's lane, from the same camera ray: radiance 15 too
    jsd = j_get_scene("CornellBox")
    jlk, jo, jd, _ = j_render._make_lanes(
        jsd.camera_at(0.0), jax.random.PRNGKey(7), np.array([K7_PIXEL], np.uint32),
        jnp.uint32(K7_SAMPLE), width=20, height=20, spp_chunk=1, spp_total=K7_SPP)
    np.testing.assert_array_equal(np.asarray(jo), o.numpy())
    np.testing.assert_array_equal(np.asarray(jd), d.numpy())
    js, _ = j_integrator.trace_resume(jsd.build(), jo, jd, jnp.ones((1, 3)),
                                      jnp.zeros((1, 3)), jnp.ones(1, bool), jlk,
                                      jnp.zeros(3), 0, 2)
    assert np.asarray(js["rad"])[0].tolist() == [15.0, 15.0, 15.0]
