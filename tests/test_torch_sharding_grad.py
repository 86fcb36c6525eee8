"""The sharded differentiable step (``parallel/shard.py``) on the CPU,
over 2 and 4 gloo ranks: the fused route (K1 with residuals and K2, their
plain versions here) on CornellBox and the generic route on
TwoSphereCheckers, and the dryrun on the fused route.

The JAX package never ran its sharded fused step on the CPU (Pallas
interpret mode inside ``shard_map`` trips a JAX limitation,
tests/test_sharding.py:131-144), so its single-device step is the
reference here.

Tolerances and why:

* every rank returns the same loss and gradients, bit for bit (one
  all-reduce makes them);
* against the port's single-device step: the loss within 1e-6 relative,
  each leaf within 1e-4 of that leaf's largest gradient (the per-pixel
  sums and the partial gradients add in another order), plus 1e-6 of
  the largest gradient of any leaf: a leaf whose gradient is zero in
  exact arithmetic (the focus distance at aperture 0) carries f32 noise
  of ~1e-8 on the generic route.  A gradient counted once per rank
  (tiles x samples times too large, or samples times) fails this by
  far;
* against JAX's single-device ``render_loss_and_grad``: the port's
  contract with JAX (tests/test_torch_grad.py): the loss within 2e-3
  relative, each leaf within rtol 0.05 and 2e-3 of the largest
  gradient.  The 1e-6 / 1e-4 of the sharded check cannot hold against
  JAX.  On CornellBox (key 3) the port's single-device step is 4.8e-4
  from JAX's loss and its background gradient 0.5% of the leaf's
  largest, from one lane, whose path f64 follows on the port's side
  and not on JAX's (``test_key3_lane_follows_f64``); every other pixel
  is JAX's to 2e-6.  On TwoSphereCheckers (generic route, key 0) the
  loss is 2.3e-6 from JAX's and the camera's gradients up to 1.7e-3 of
  the largest (``python tests/test_torch_sharding_grad.py`` prints
  each leaf's gap), on the same paths; at the first hit the gap is
  JAX's f32 sphere roots (``test_generic_gap_starts_at_jaxs_f32_roots``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rust_pathtracer_tpu.grad import CameraParams as JCameraParams
from rust_pathtracer_tpu.grad import DiffParams as JDiffParams
from rust_pathtracer_tpu.grad import render_loss_and_grad as j_render_loss_and_grad
from rust_pathtracer_tpu.models import get_scene as j_get_scene
from rust_pathtracer_tpu.render import RenderSettings as JRenderSettings
from rust_pathtracer_tpu_torch.grad import CameraParams, DiffParams, render_loss_and_grad
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.render import RenderSettings
from rust_pathtracer_tpu_torch.sampling import prng_key
from torch_spawn import run_ranks

torch.set_num_threads(2)

CAMERAS = {
    "CornellBox": [[278.0, 278.0, -800.0], [278.0, 278.0, 0.0], [0.0, 1.0, 0.0], 40.0,
                   1.0, 0.0, 10.0],
    "TwoSphereCheckers": [[13.0, 2.0, 3.0], [0.0, 0.0, 0.0], [0.0, 1.0, 0.0], 20.0,
                          854.0 / 480.0, 0.0, 10.0],
}
WHITE = [1.0, 1.0, 1.0]
# name -> (mesh, scene, settings, key)
CASES = {
    "fused_2x1": ((2, 1), "CornellBox", dict(width=16, height=16, samples_per_pixel=2,
                                             max_bounces=4, background=WHITE), 3),
    "fused_2x2": ((2, 2), "CornellBox", dict(width=16, height=16, samples_per_pixel=2,
                                             max_bounces=4, background=WHITE), 3),
    "generic_2x1": ((2, 1), "TwoSphereCheckers", dict(width=16, height=9,
                                                      samples_per_pixel=2, max_bounces=4,
                                                      background=WHITE), 0),
}
LEAVES = ("tex_color", "tex_images", "background", "camera.lookfrom", "camera.lookat",
          "camera.up", "camera.vfov_deg", "camera.aspect", "camera.aperture",
          "camera.focus_dist")


def _job(name):
    mesh, scene, cfg, key = CASES[name]
    return dict(mesh=list(mesh), scene=scene, settings=cfg, key=key,
                camera=CAMERAS[scene])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> every rank's (loss, gradients); "dryrun" -> every rank's
    dryrun on (2, 2)."""
    tmp = tmp_path_factory.mktemp("sharding_grad")
    got = {}
    two = [n for n in CASES if np.prod(CASES[n][0]) == 2]
    res = run_ranks("grad", 2, tmp, timeout=150, jobs=[_job(n) for n in two])
    for j, n in enumerate(two):
        got[n] = [r["jobs"][j] for r in res]
    res = run_ranks("grad", 4, tmp, timeout=150, jobs=[_job("fused_2x2")],
                    dryrun=[2, 2])
    got["fused_2x2"] = [r["jobs"][0] for r in res]
    got["dryrun"] = [r["dryrun"] for r in res]
    return got


def _single(scene_name, cfg, key):
    """The port's single-device loss and gradients, numpy leaves."""
    scene = get_scene(scene_name).build()
    s = RenderSettings(**dict(cfg, background=tuple(cfg["background"])))
    params = DiffParams.from_scene(scene, CameraParams.create(*CAMERAS[scene_name]),
                                   s.background)
    loss, g = render_loss_and_grad(params, scene, s, prng_key(key),
                                   torch.zeros((s.height, s.width, 3)), device="cpu")
    return float(loss), [x.numpy() for x in g.leaves()]


@pytest.fixture(scope="module")
def jax_steps():
    """scene -> JAX's single-device (loss, gradients by leaf name)."""
    out = {}
    for name in ("fused_2x1", "generic_2x1"):
        _, scene_name, cfg, key = CASES[name]
        jscene = j_get_scene(scene_name).build()
        s = JRenderSettings(**dict(cfg, background=tuple(cfg["background"])),
                            differentiable=True)
        params = JDiffParams.from_scene(jscene, JCameraParams.create(*CAMERAS[scene_name]),
                                        s.background)
        loss, g = j_render_loss_and_grad(params, jscene, s, jax.random.PRNGKey(key),
                                         jnp.zeros((s.height, s.width, 3)))
        leaves = {"tex_color": g.tex_color, "tex_images": g.tex_images,
                  "background": g.background}
        leaves.update({k: getattr(g.camera, k.split(".")[1])
                       for k in LEAVES if k.startswith("camera.")})
        out[scene_name] = (float(loss), {k: np.asarray(v) for k, v in leaves.items()})
    return out


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_single_device(runs, name):
    """Loss and every DiffParams leaf against the port's single-device
    step, tightly (module note); the same on every rank."""
    _, scene_name, cfg, key = CASES[name]
    recs = runs[name]
    for r in recs:
        assert r["loss"] == recs[0]["loss"]
        for a, b in zip(r["grads"], recs[0]["grads"]):
            assert torch.equal(a, b)
    loss, grads = _single(scene_name, cfg, key)
    assert loss > 0
    np.testing.assert_allclose(recs[0]["loss"], loss, rtol=1e-6)
    nonzero = 0
    floor = 1e-6 * max(np.abs(g).max() for g in grads)
    for k, got, want in zip(LEAVES, recs[0]["grads"], grads):
        scale = np.abs(want).max()
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-4 * scale + floor,
                                   err_msg=k)
        nonzero += scale > 1e3 * floor
    assert nonzero >= 2  # the texture colours and the background at least


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_jax(runs, jax_steps, name):
    """Loss and every leaf against JAX's single-device step under the
    port's contract with JAX (module note)."""
    _, scene_name, _, _ = CASES[name]
    jloss, jgrads = jax_steps[scene_name]
    rec = runs[name][0]
    np.testing.assert_allclose(rec["loss"], jloss, rtol=2e-3)
    scale = max(np.abs(v).max() for v in jgrads.values())
    assert scale > 0.01
    for k, got in zip(LEAVES, rec["grads"]):
        np.testing.assert_allclose(got.numpy(), jgrads[k], rtol=0.05, atol=2e-3 * scale,
                                   err_msg=k)
    if scene_name == "TwoSphereCheckers":  # the generic route carries the camera
        assert np.abs(rec["grads"][LEAVES.index("camera.lookfrom")].numpy()).max() > 0


def test_dryrun_on_the_fused_route(runs):
    """``dryrun_multichip`` on (2, 2): one SGD step on CornellBox (K1-res
    and K2's plain versions), loss > 0 and equal to the single-device
    step's at the dryrun's shape, some leaf changed; the same on every
    rank."""
    recs = runs["dryrun"]
    assert all(r == recs[0] for r in recs)
    assert recs[0]["mesh"] == {"tiles": 2, "samples": 2}
    assert recs[0]["changed"] > 0 and recs[0]["loss"] > 0
    loss, _ = _single("CornellBox", dict(width=8, height=8, samples_per_pixel=2,
                                         max_bounces=3, background=WHITE, spp_chunk=2), 0)
    np.testing.assert_allclose(recs[0]["loss"], loss, rtol=1e-6)


# key 3, pixel 138, sample 1: the camera ray meets glass sphere 1 (prim
# 18) at a grazing angle (cos 0.242 to the normal), and the Schlick coin
# reflects
K3_PIXEL, K3_SAMPLE, K3_SPHERE, K3_WALL = 138, 1, 18, 1


def test_key3_lane_follows_f64():
    """The one lane of the fused case's image where the port and JAX
    differ, traced in f64 from the camera ray both sides agree on bit for
    bit.  In f64 the ray meets glass sphere 1 at t = 91.324154, reflects
    (Schlick 0.2797 > coin 0.0093), and the reflected ray leaves the
    sphere (its roots -43.6 and 2e-12) and meets the red wall (prim 1) at
    t = 242.5039.  The port (f64 sphere roots) lands its bounce-0 point
    within 1e-5 of the sphere and follows f64 to the red wall; JAX's f32
    root lands its point 3.5e-4 inside the sphere, so its reflected ray
    meets the sphere again just past t_min.  Every other pixel of the two
    images agrees to 2e-6: JAX's f32 root is the whole gap between the
    port's single-device step and JAX's on this case."""
    import sys

    from rust_pathtracer_tpu import integrator as j_integrator
    from rust_pathtracer_tpu import render as j_render
    from rust_pathtracer_tpu.grad import render_radiance_diff as j_render_radiance_diff
    from rust_pathtracer_tpu_torch import integrator, sampling
    from rust_pathtracer_tpu_torch.grad import render_radiance_diff
    from rust_pathtracer_tpu_torch.ops.closest_hit import closest_hit_record_plain, pack_prims
    from rust_pathtracer_tpu_torch.render import _make_lanes

    sys.path.insert(0, str(__import__("pathlib").Path(__file__).parent))
    from oracle import reflect

    _, scene_name, cfg, key = CASES["fused_2x1"]
    W, H, spp = cfg["width"], cfg["height"], cfg["samples_per_pixel"]
    scene = get_scene(scene_name).build()
    cam = CameraParams.create(*CAMERAS[scene_name]).build()
    lk, o, d, _ = _make_lanes(cam, prng_key(key), torch.tensor([K3_PIXEL]), K3_SAMPLE,
                              width=W, height=H, spp_chunk=1, spp_total=spp)
    jlk, jo, jd, _ = j_render._make_lanes(
        JCameraParams.create(*CAMERAS[scene_name]).build(), jax.random.PRNGKey(key),
        np.array([K3_PIXEL], np.uint32), jnp.uint32(K3_SAMPLE), width=W, height=H,
        spp_chunk=1, spp_total=spp)
    np.testing.assert_array_equal(np.asarray(jo), o.numpy())
    np.testing.assert_array_equal(np.asarray(jd), d.numpy())

    # f64: the port's plain closest hit on f64 tensors, the dielectric's
    # reflection, the closest hit of the reflected ray
    table64 = pack_prims(scene.prims).double()
    hit, t, idx, rec = closest_hit_record_plain(table64, o.double(), d.double(),
                                                kinds=scene.kinds_static,
                                                t_min=integrator.T_MIN)
    assert bool(hit[0]) and int(idx[0]) == K3_SPHERE and bool(rec.front_face[0])
    assert abs(float(t[0]) - 91.32415370259022) < 1e-9
    p64, n64 = rec.point[0].numpy(), rec.normal[0].numpy()
    ud = d[0].double().numpy() / np.linalg.norm(d[0].double().numpy())
    cos_t = min(float(-ud @ n64), 1.0)
    r0 = ((1.0 - 1.0 / 1.5) / (1.0 + 1.0 / 1.5)) ** 2
    coin = float(sampling.bounce_draws(lk, 0, False)[2][0])
    assert r0 + (1.0 - r0) * (1.0 - cos_t) ** 5 > coin  # reflect
    d1 = reflect(ud[None], n64[None])
    hit1, t1, idx1, _ = closest_hit_record_plain(
        table64, torch.from_numpy(p64[None]), torch.from_numpy(d1),
        kinds=scene.kinds_static, t_min=integrator.T_MIN)
    assert bool(hit1[0]) and int(idx1[0]) == K3_WALL
    assert abs(float(t1[0]) - 242.5039) < 1e-3
    centre = scene.prims.data[K3_SPHERE, 0:3].double().numpy()
    radius = float(scene.prims.data[K3_SPHERE, 3])

    def off_sphere(p):
        return float(np.linalg.norm(np.asarray(p, np.float64) - centre)) - radius

    # the port in f32: bounce 0 on the f64 point, bounce 1 on the red wall
    ones, zeros = torch.ones((1, 3)), torch.zeros((1, 3))
    alive, bg = torch.ones(1, dtype=torch.bool), torch.ones(3)
    st, _ = integrator.trace_resume(scene, o, d, ones, zeros, alive, lk, bg, 0, 1)
    assert abs(off_sphere(st["o"][0].numpy())) < 1e-5
    st, _ = integrator.trace_resume(scene, o, d, ones, zeros, alive, lk, bg, 0, 2)
    assert float(st["o"][0, 0]) == 0.0  # on the red wall, x = 0
    # JAX in f32: its bounce-0 point inside the sphere, its bounce 1 on the
    # sphere again
    js, _ = j_integrator.trace_resume(j_get_scene(scene_name).build(), jo, jd,
                                      jnp.ones((1, 3)), jnp.zeros((1, 3)),
                                      jnp.ones(1, bool), jlk, jnp.ones(3), 0, 1)
    assert off_sphere(np.asarray(js["o"])[0]) < -1e-4
    js, _ = j_integrator.trace_resume(j_get_scene(scene_name).build(), jo, jd,
                                      jnp.ones((1, 3)), jnp.zeros((1, 3)),
                                      jnp.ones(1, bool), jlk, jnp.ones(3), 0, 2)
    assert abs(off_sphere(np.asarray(js["o"])[0])) < 1e-2

    # the two images: every pixel but this lane's within 2e-6
    s = RenderSettings(**dict(cfg, background=tuple(cfg["background"])))
    params = DiffParams.from_scene(scene, CameraParams.create(*CAMERAS[scene_name]),
                                   s.background)
    img = render_radiance_diff(params, scene, s, prng_key(key), device="cpu")
    jscene = j_get_scene(scene_name).build()
    js_ = JRenderSettings(**dict(cfg, background=tuple(cfg["background"])))
    jimg = j_render_radiance_diff(
        JDiffParams.from_scene(jscene, JCameraParams.create(*CAMERAS[scene_name]),
                               js_.background), jscene, js_, jax.random.PRNGKey(key))
    diff = np.abs(img.detach().numpy() - np.asarray(jimg)).max(axis=-1).reshape(-1)
    assert diff[K3_PIXEL] > 0.1
    assert np.delete(diff, K3_PIXEL).max() <= 2e-6


def test_generic_gap_starts_at_jaxs_f32_roots():
    """The generic case's images differ by up to 5e-5 on many pixels with
    the same paths: the two spheres of radius 10 touch, the rays graze
    them, and a hit point's rounding grows along the path.  At the first
    hit it starts as JAX's: on pixel 47's two camera rays (bit for bit
    the same on both sides) the port's point lies within 3e-7 of the f64
    closest hit, JAX's f32 roots up to 4e-6 from it."""
    from rust_pathtracer_tpu import integrator as j_integrator
    from rust_pathtracer_tpu import render as j_render
    from rust_pathtracer_tpu_torch import integrator
    from rust_pathtracer_tpu_torch.ops.closest_hit import closest_hit_record_plain, pack_prims
    from rust_pathtracer_tpu_torch.render import _make_lanes

    _, scene_name, cfg, key = CASES["generic_2x1"]
    W, H, spp, pix = cfg["width"], cfg["height"], cfg["samples_per_pixel"], 47
    scene = get_scene(scene_name).build()
    lk, o, d, _ = _make_lanes(CameraParams.create(*CAMERAS[scene_name]).build(),
                              prng_key(key), torch.tensor([pix]), 0, width=W, height=H,
                              spp_chunk=spp, spp_total=spp)
    jlk, jo, jd, _ = j_render._make_lanes(
        JCameraParams.create(*CAMERAS[scene_name]).build(), jax.random.PRNGKey(key),
        np.array([pix], np.uint32), jnp.uint32(0), width=W, height=H, spp_chunk=spp,
        spp_total=spp)
    np.testing.assert_array_equal(np.asarray(jo), o.numpy())
    np.testing.assert_array_equal(np.asarray(jd), d.numpy())
    hit, _, _, rec = closest_hit_record_plain(pack_prims(scene.prims).double(), o.double(),
                                              d.double(), kinds=scene.kinds_static,
                                              t_min=integrator.T_MIN)
    assert bool(hit.all())
    st, _ = integrator.trace_resume(scene, o, d, torch.ones((spp, 3)), torch.zeros((spp, 3)),
                                    torch.ones(spp, dtype=torch.bool), lk, torch.ones(3), 0, 1)
    js, _ = j_integrator.trace_resume(j_get_scene(scene_name).build(), jo, jd,
                                      jnp.ones((spp, 3)), jnp.zeros((spp, 3)),
                                      jnp.ones(spp, bool), jlk, jnp.ones(3), 0, 1)
    p64 = rec.point.numpy()
    port_err = np.abs(st["o"].double().numpy() - p64).max(axis=1)
    jax_err = np.abs(np.asarray(js["o"], np.float64) - p64).max(axis=1)
    assert (port_err < 3e-7).all(), port_err
    assert jax_err.max() > 3e-6 and (jax_err > port_err).all(), jax_err


if __name__ == "__main__":
    # each leaf's gap between the port's single-device step and JAX's
    for case in ("fused_2x1", "generic_2x1"):
        _, scene_name, cfg, key = CASES[case]
        loss, grads = _single(scene_name, cfg, key)
        jscene = j_get_scene(scene_name).build()
        s = JRenderSettings(**dict(cfg, background=tuple(cfg["background"])),
                            differentiable=True)
        params = JDiffParams.from_scene(jscene, JCameraParams.create(*CAMERAS[scene_name]),
                                        s.background)
        jloss, g = j_render_loss_and_grad(params, jscene, s, jax.random.PRNGKey(key),
                                          jnp.zeros((s.height, s.width, 3)))
        jleaves = [g.tex_color, g.tex_images, g.background] + [
            getattr(g.camera, k.split(".")[1]) for k in LEAVES[3:]]
        top = max(float(np.abs(np.asarray(x)).max()) for x in jleaves)
        print(f"{case} ({scene_name}, key {key}): loss {loss} against JAX's {float(jloss)} "
              f"({abs(loss - float(jloss)) / float(jloss):.3e} relative); largest "
              f"gradient {top:.6g}")
        for k, got, want in zip(LEAVES, grads, jleaves):
            want = np.asarray(want)
            gap = float(np.abs(got - want).max()) if want.size else 0.0
            scale = float(np.abs(want).max()) if want.size else 0.0
            print(f"  {k}: max gap {gap:.3e} = {gap / top:.3e} of the largest gradient, "
                  f"{gap / scale if scale else 0.0:.3e} of the leaf's largest ({scale:.3e})")
