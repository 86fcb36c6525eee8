"""The port's sharded render (``parallel/``) on the CPU, over 2 and 4 gloo
ranks, against its own single-device render and the JAX package's.

The ranks are processes of their own (``tests/torch_spawn.py``): one
4-rank group renders every 4-rank case in turn (meshes (4,1), (2,2) and
(1,4), the odd shapes, the cascades), one 2-rank group the (2,1) and
(1,2) meshes; JAX's references run meanwhile, on the conftest's 8-device
CPU mesh.  Shapes and keys are ``tests/test_sharding.py``'s.

Tolerances and why:

* every rank returns the same image, bit for bit (each rank adds the
  same slots in the same order);
* against the port's single-device render: bit for bit where the
  samples axis is 1 (every pixel sums the same lanes in the same
  order); within JAX's ``atol=2e-6`` otherwise (the sample groups' sums
  add in another order);
* against JAX's single-device render: JAX's ``atol=2e-6`` on at least
  99% of the pixels.  At 4-6 bounces the images are equal here, but at
  12 a lane's path can flip on an ulp of XLA's fused multiply-adds, and
  its pixel moves (by 0.73 on the cascade cases' key; on the "auto"
  case's 16 spp such pixels move the image mean by 1.2%, past the image
  contract's 1%);
* segments: the lanes the sharding adds (padded pixels wrap to pixel 0,
  padded samples past spp are traced and masked) are JAX's:
  the port's sharded minus single-device segments equal JAX's sharded
  minus single-device segments on the same mesh.  Equal segments
  outright are not asked: on the 24x24 shape one lane of the port
  traces one segment fewer than JAX's single-device render (18,022
  against 18,023, the images equal), a path that an ulp of XLA's fused
  multiply-adds reroutes.
"""

import threading
from contextlib import nullcontext

import jax
import numpy as np
import pytest
import torch

from rust_pathtracer_tpu.models import get_scene as j_get_scene
from rust_pathtracer_tpu.parallel import make_mesh as j_make_mesh
from rust_pathtracer_tpu.parallel import render_radiance_sharded as j_render_sharded
from rust_pathtracer_tpu.render import RenderSettings as JRenderSettings
from rust_pathtracer_tpu.render import render_radiance as j_render_radiance
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.parallel import mesh as M
from rust_pathtracer_tpu_torch.render import RenderSettings, render_radiance
from rust_pathtracer_tpu_torch.sampling import prng_key
from torch_spawn import run_ranks

torch.set_num_threads(2)

BLACK = [0.0, 0.0, 0.0]
BASE = dict(width=24, height=24, samples_per_pixel=8, max_bounces=6, background=BLACK)
DEEP = dict(BASE, max_bounces=12)
# name -> (mesh, settings, key, first auto margin or None)
CASES = {
    "4x1": ((4, 1), BASE, 11, None),
    "2x2": ((2, 2), BASE, 11, None),
    "1x4": ((1, 4), BASE, 11, None),
    "odd_pixels": ((4, 1), dict(width=13, height=11, samples_per_pixel=4, max_bounces=4,
                                background=BLACK), 3, None),
    "spp10_over_4": ((1, 4), dict(width=16, height=8, samples_per_pixel=10, max_bounces=4,
                                  background=BLACK), 4, None),
    # CornellBox keeps 31% of its lanes alive at bounce 8: a slice of
    # half the lanes a rank has room
    "cascade_8:2": ((2, 2), dict(DEEP, cascade_schedule="8:2"), 11, None),
    # spp 16 over 2 sample groups in chunks of 4: chunk 0 calibrates,
    # chunk 1 cascades; a first margin of 0.25 forces the retry
    "auto_retry": ((2, 2), dict(DEEP, samples_per_pixel=16, spp_chunk=4,
                                cascade_schedule="auto"), 11, 0.25),
    "dynamic": ((2, 2), dict(DEEP, cascade=True), 11, None),
    "tight_1:16": ((2, 2), dict(DEEP, cascade_schedule="1:16"), 11, None),
    "2x1": ((2, 1), BASE, 11, None),
    "1x2": ((1, 2), BASE, 11, None),
}
RENDERED = [n for n in CASES if n != "tight_1:16"]


def _plain(cfg):
    """The settings without the cascade (the reference render's)."""
    cfg = {k: v for k, v in cfg.items() if k not in ("cascade", "cascade_schedule")}
    return dict(cfg, background=tuple(cfg["background"]))


def _job(name):
    mesh, cfg, key, margin = CASES[name]
    job = dict(mesh=list(mesh), scene="CornellBox", settings=cfg, key=key)
    if margin is not None:
        job["margin"] = margin
    return job


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """name -> the ranks' records (``torch_spawn.case_render``); the
    4-rank and the 2-rank group run in threads while JAX renders."""
    tmp = tmp_path_factory.mktemp("sharding")
    groups = {4: [n for n in CASES if np.prod(CASES[n][0]) == 4],
              2: [n for n in CASES if np.prod(CASES[n][0]) == 2]}
    got, errors = {}, []

    def spawn(world, names):
        try:
            res = run_ranks("render", world, tmp, timeout=150,
                            jobs=[_job(n) for n in names])
            for j, n in enumerate(names):
                got[n] = [r["jobs"][j] for r in res]
        except BaseException as e:  # pytest.fail raises outside Exception
            errors.append(e)

    threads = [threading.Thread(target=spawn, args=item) for item in groups.items()]
    for t in threads:
        t.start()
    refs = jax_refs()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return got, refs


def jax_refs():
    """name -> (JAX single-device image, its segments, JAX's sharded
    segments on the case's mesh or None)."""
    sd = j_get_scene("CornellBox")
    scene, cam = sd.build(), sd.camera_at(0.0)
    out = {}
    for name in RENDERED:
        mesh, cfg, key, _ = CASES[name]
        img, st = j_render_radiance(scene, cam, JRenderSettings(**_plain(cfg)),
                                    jax.random.PRNGKey(key))
        sharded = None
        if name != "auto_retry":  # JAX's retry crashes (ROADMAP queue 3)
            jcfg = dict(cfg, background=tuple(cfg["background"]))
            with pytest.warns(UserWarning) if name == "dynamic" else nullcontext():
                _, sst = j_render_sharded(
                    scene, cam, JRenderSettings(**jcfg), jax.random.PRNGKey(key),
                    j_make_mesh(*mesh, devices=jax.devices()[:int(np.prod(mesh))]))
            sharded = float(sst.segments)
        out[name] = (np.asarray(img), float(st.segments), sharded)
    return out


def _port_single(name):
    _, cfg, key, _ = CASES[name]
    sd = get_scene("CornellBox")
    return render_radiance(sd.build(), sd.camera_at(0.0), RenderSettings(**_plain(cfg)),
                           prng_key(key), device="cpu")


@pytest.mark.parametrize("name", RENDERED)
def test_sharded_matches_single_device(runs, name):
    """The sharded image on every rank against the port's and JAX's
    single-device renders, and the lanes the sharding adds against
    JAX's (module note)."""
    got, refs = runs
    (tiles, samples), _, _, _ = CASES[name]
    recs = got[name]
    img = recs[0]["img"]
    assert img.dtype == torch.float32 and torch.isfinite(img).all()
    for r in recs:
        assert torch.equal(r["img"], img)
        assert r["segments"] == recs[0]["segments"]
    assert [r["coord"] for r in recs] == [divmod(i, samples) for i in range(len(recs))]
    ref, st = _port_single(name)
    if samples == 1:
        assert torch.equal(img, ref)
    else:
        np.testing.assert_allclose(img.numpy(), ref.numpy(), rtol=0, atol=2e-6)
    jimg, jseg, jsharded = refs[name]
    close = (np.abs(img.numpy() - jimg) <= 2e-6).all(axis=-1)
    assert close.mean() >= 0.99, close.mean()
    if jsharded is not None:
        assert recs[0]["segments"] - float(st.segments) == jsharded - jseg
    if name.startswith(("cascade", "auto")):
        assert float(recs[0]["occupancy"][-1]) == 0.0


def test_sharding_adds_the_padded_lanes(runs):
    """13x11 pixels on 4 tiles trace one padded pixel a sample; 10 spp
    over 4 sample groups trace 2 padded samples a pixel: both add
    segments to the single-device count, where the 24x24 meshes add
    none."""
    got, refs = runs
    for name, more in (("odd_pixels", True), ("spp10_over_4", True), ("2x2", False)):
        _, st = _port_single(name)
        assert (got[name][0]["segments"] > float(st.segments)) == more, name


def test_auto_retry_widens_and_matches(runs):
    """"auto" with its retry forced: each attempt that drops lanes warns
    and derives the schedule again at double the margin, then the image
    is the single-device render's (where the JAX package's retry crashes
    on a donated buffer)."""
    got, _ = runs
    recs = got["auto_retry"]
    retries = [w for w in recs[0]["warnings"] if "deriving again" in w]
    assert retries and all("dropped" in w for w in retries)


def test_dynamic_request_warns_and_renders_plain(runs):
    got, _ = runs
    for r in got["dynamic"]:
        assert any("no applicable STATIC schedule" in w for w in r["warnings"])
    ref, _ = _port_single("dynamic")
    np.testing.assert_allclose(got["dynamic"][0]["img"].numpy(), ref.numpy(), rtol=0,
                               atol=2e-6)


def test_tight_schedule_raises_on_every_rank(runs):
    """"1:16" drops live lanes: every rank raises CascadeOverflowError
    (the guard's count is summed over the ranks), no image comes back."""
    got, _ = runs
    for r in got["tight_1:16"]:
        assert "dropped" in r["raised"] and "img" not in r


def test_mesh_shape_and_coordinates():
    """make_mesh's arithmetic and errors are JAX's, and rank r sits where
    JAX's mesh puts device r: row major (r // samples, r % samples)."""
    assert M.mesh_shape(8) == (8, 1)
    assert M.mesh_shape(8, samples=2) == (4, 2)
    assert M.mesh_shape(8, 2, 4) == (2, 4)
    for args, msg in (((8, 3, 2), "mesh 3x2 != 8 devices"),
                      ((7, None, 2), "not divisible by samples=2")):
        with pytest.raises(ValueError, match=msg):
            M.mesh_shape(*args)
        with pytest.raises(ValueError, match=msg):
            j_make_mesh(args[1], args[2], devices=jax.devices()[:args[0]])
    for tiles, samples in ((4, 2), (2, 4), (8, 1)):
        jm = j_make_mesh(tiles, samples)
        ids = np.vectorize(lambda d: d.id)(jm.devices)
        for r in range(8):
            mesh = M.Mesh(tiles, samples, r, torch.device("cpu"), None, None)
            assert ids[mesh.coord] == r
            assert mesh.shape == dict(jm.shape)


def test_make_mesh_needs_the_process_group():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="distributed_init"):
        M.make_mesh(device="cpu")


def test_nccl_refuses_two_ranks_on_one_device(monkeypatch):
    """NCCL with more ranks on a host than cards raises before any
    process group exists (never a switch to gloo); gloo takes any; NCCL
    on the CPU raises."""
    cuda = torch.device("cuda", 0)
    with pytest.raises(ValueError, match="two ranks on one device"):
        M.check_backend("nccl", cuda, local_ranks=4, device_count=1)
    M.check_backend("nccl", cuda, local_ranks=4, device_count=4)
    M.check_backend("gloo", cuda, local_ranks=4, device_count=1)
    M.check_backend("gloo", torch.device("cpu"), local_ranks=4, device_count=0)
    with pytest.raises(ValueError, match="needs a CUDA device"):
        M.check_backend("nccl", torch.device("cpu"), 1, 0)
    with pytest.raises(ValueError, match="unknown backend"):
        M.check_backend("mpi", torch.device("cpu"), 1, 0)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="needs a CUDA device"):
        M.distributed_init("nccl", "file:///nonexistent", 2, 0, device="cpu")
    assert not torch.distributed.is_initialized()
    monkeypatch.setattr(M, "rank_device", lambda device, local_rank: cuda)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="two ranks on one device"):
        M.distributed_init("nccl", "file:///nonexistent", 2, 0, device="cuda")
    assert not torch.distributed.is_initialized()
