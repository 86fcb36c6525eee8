"""Render checkpoints with exact resume (``utils/checkpoint.py``) on the
CPU: the cases of ``tests/test_checkpoint.py``, the sharded ones over 2
and 4 gloo ranks (``tests/torch_spawn.py``), plus the file format across
the two packages and the CLI flags, ``--mesh`` among them.

Tolerances: none within the port.  A resumed render equals the
uninterrupted one bit for bit (the RNG keys on (pixel, sample), the
restored sums are the saved f32 values, and the chunks add in the same
order), also where a sharded render resumes on another tile count; a
file either package writes loads in the other with equal fields.  A
render that one package started and the other finished is held to the
finishing package's uninterrupted render on 99% of its pixels within
2e-6 (tests/test_torch_sharding.py: a lane's path may flip between the
packages).
"""

import dataclasses
import os
import shutil

import jax
import numpy as np
import pytest
import torch

from rust_pathtracer_tpu.models import get_scene as j_get_scene
from rust_pathtracer_tpu.utils import checkpoint as j_checkpoint
from rust_pathtracer_tpu_torch import cli, render
from rust_pathtracer_tpu_torch.models import get_scene
from rust_pathtracer_tpu_torch.render import (
    CascadeOverflowError,
    RenderSettings,
    _render_chunk,
    _render_chunk_cascaded,
    render_radiance,
)
from rust_pathtracer_tpu_torch.sampling import prng_key
from rust_pathtracer_tpu_torch.utils import checkpoint as ck
from rust_pathtracer_tpu_torch.utils.checkpoint import (
    RenderCheckpoint,
    load_checkpoint,
    render_radiance_checkpointed,
    save_checkpoint,
)

from torch_spawn import run_processes, run_ranks

torch.set_num_threads(2)


def _cornell():
    sd = get_scene("CornellBox")
    return sd.build(), sd.camera_at(0.0)


def _partial(scene, cam, key, s, chunks, path, cascade_schedule=None):
    """Save the sums of the first ``chunks`` sample chunks of ``s``."""
    chunk = s.resolve_chunk()
    acc = torch.zeros((s.width * s.height, 3))
    for s0 in range(0, chunks * chunk, chunk):
        args = dict(width=s.width, height=s.height, spp_chunk=chunk,
                    spp_total=s.samples_per_pixel, max_bounces=s.max_bounces,
                    rr_start=None)
        if cascade_schedule is None:
            part, _ = _render_chunk(scene, cam, key, s0, torch.zeros(3), **args)
        else:
            part, _ = _render_chunk_cascaded(scene, cam, key, s0, torch.zeros(3),
                                             schedule=cascade_schedule, **args)
        acc = acc + part
    save_checkpoint(path, RenderCheckpoint(
        acc=acc.numpy(), samples_done=chunks * chunk, width=s.width, height=s.height,
        spp_total=s.samples_per_pixel, key_data=ck.key_data(key), segments=0.0))


def test_checkpoint_roundtrip(tmp_path):
    p = os.path.join(tmp_path, "sub", "ck.npz")
    c = RenderCheckpoint(
        acc=np.random.default_rng(0).random((64, 3)).astype(np.float32), samples_done=7,
        width=8, height=8, spp_total=16, key_data=ck.key_data(prng_key(3)), segments=123.0)
    save_checkpoint(p, c)
    got = load_checkpoint(p)
    assert np.array_equal(got.acc, c.acc) and got.acc.dtype == np.float32
    assert (got.samples_done, got.width, got.height, got.spp_total) == (7, 8, 8, 16)
    assert np.array_equal(got.key_data, c.key_data) and got.segments == 123.0
    assert (got.samples_axis, got.chunk) == (1, 0)
    assert os.listdir(os.path.dirname(p)) == ["ck.npz"]  # no temporary left behind
    assert load_checkpoint(os.path.join(tmp_path, "missing.npz")) is None


def test_save_is_atomic(tmp_path, monkeypatch):
    """A save that fails mid-write leaves the old file and no temporary."""
    p = os.path.join(tmp_path, "ck.npz")
    c = RenderCheckpoint(acc=np.zeros((4, 3), np.float32), samples_done=2, width=2,
                         height=2, spp_total=4, key_data=ck.key_data(prng_key(1)),
                         segments=0.0)
    save_checkpoint(p, c)

    def boom(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(np, "savez", boom)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(p, c._replace(samples_done=4))
    assert os.listdir(tmp_path) == ["ck.npz"] and load_checkpoint(p).samples_done == 2


def test_file_format_crosses_packages(tmp_path):
    """A file the JAX package writes loads in the port with equal fields,
    and the other way; the key words are the same 32-bit values."""
    acc = np.random.default_rng(1).random((64, 3)).astype(np.float32)
    jp, tp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    j_checkpoint.save_checkpoint(jp, j_checkpoint.RenderCheckpoint(
        acc=acc, samples_done=4, width=8, height=8, spp_total=8,
        key_data=np.asarray(jax.random.PRNGKey(5)), segments=99.0))
    got = load_checkpoint(jp)
    assert np.array_equal(got.acc, acc) and got.samples_done == 4
    assert np.array_equal(got.key_data, ck.key_data(prng_key(5)))
    save_checkpoint(tp, got)
    back = j_checkpoint.load_checkpoint(tp)
    assert np.array_equal(back.acc, acc) and back.segments == 99.0
    assert np.array_equal(back.key_data, np.asarray(jax.random.PRNGKey(5)))
    assert back.key_data.dtype == np.asarray(jax.random.PRNGKey(5)).dtype


def test_resume_is_bitwise_exact(tmp_path):
    """Four of eight samples saved, then resumed: render_radiance's image."""
    scene, cam = _cornell()
    s = RenderSettings(16, 16, 8, 4, (0.0, 0.0, 0.0), spp_chunk=2)
    key = prng_key(1)
    ref, _ = render_radiance(scene, cam, s, key, device="cpu")
    p = str(tmp_path / "ck.npz")
    _partial(scene, cam, key, s, 2, p)
    img, _ = render_radiance_checkpointed(scene, cam, s, key, p, device="cpu")
    assert torch.equal(img, ref)
    assert load_checkpoint(p).samples_done == 8


class _Stop(RuntimeError):
    pass


@pytest.mark.parametrize("schedule", [None, "6:2"])
def test_stopped_and_resumed(tmp_path, monkeypatch, schedule):
    """A render stopped after 2 of 4 chunks (the checkpoint of chunk 2
    saved) and run again equals the uninterrupted render, with the
    segments, on the chunked path and through the cascade."""
    scene, cam = _cornell()
    s = RenderSettings(16, 16, 8, 8, (0.0, 0.0, 0.0), spp_chunk=2,
                       cascade_schedule=schedule)
    key = prng_key(4)
    ref, ref_st = render_radiance_checkpointed(scene, cam, s, key,
                                               str(tmp_path / "ref.npz"), device="cpu")
    plain, _ = render_radiance(scene, cam, s, key, device="cpu")
    assert torch.equal(ref, plain)
    name = "_render_chunk" if schedule is None else "_render_chunk_cascaded"
    real, calls = getattr(render, name), []

    def stopping(*a, **k):
        if len(calls) == 2:
            raise _Stop()
        calls.append(a[3])
        return real(*a, **k)

    p = str(tmp_path / "ck.npz")
    monkeypatch.setattr(render, name, stopping)
    with pytest.raises(_Stop):
        render_radiance_checkpointed(scene, cam, s, key, p, device="cpu")
    monkeypatch.setattr(render, name, real)
    assert calls == [0, 2] and load_checkpoint(p).samples_done == 4
    img, st = render_radiance_checkpointed(scene, cam, s, key, p, device="cpu")
    assert torch.equal(img, ref) and float(st.segments) == float(ref_st.segments)


def test_mismatched_checkpoint_ignored(tmp_path):
    """A file from another job (shape, samples or key) is not resumed."""
    scene, cam = _cornell()
    s = RenderSettings(8, 8, 4, 3, (0.0, 0.0, 0.0))
    key = prng_key(1)
    ref, _ = render_radiance(scene, cam, s, key, device="cpu")
    p = str(tmp_path / "ck.npz")
    for bad in (dict(width=2, height=2, acc=np.zeros((4, 3), np.float32)),
                dict(spp_total=8), dict(key_data=ck.key_data(prng_key(2)))):
        c = RenderCheckpoint(acc=np.ones((64, 3), np.float32), samples_done=2, width=8,
                             height=8, spp_total=4, key_data=ck.key_data(key), segments=0.0)
        save_checkpoint(p, c._replace(**bad))
        img, _ = render_radiance_checkpointed(scene, cam, s, key, p, device="cpu")
        assert torch.equal(img, ref), bad


def test_resume_with_cascade(tmp_path):
    """Cascade settings survive an interruption bit for bit: chunk 0
    through the static cascade, saved, resumed."""
    scene, cam = _cornell()
    s = RenderSettings(16, 16, 8, 12, (0.0, 0.0, 0.0), spp_chunk=4, cascade_schedule="8:2")
    key = prng_key(2)
    full, _ = render_radiance_checkpointed(scene, cam, s, key, str(tmp_path / "a.npz"),
                                           device="cpu")
    p = str(tmp_path / "b.npz")
    _partial(scene, cam, key, s, 1, p, cascade_schedule="8:2")
    resumed, _ = render_radiance_checkpointed(scene, cam, s, key, p, device="cpu")
    assert torch.equal(full, resumed)
    ref, _ = render_radiance(scene, cam, dataclasses.replace(s, cascade_schedule=None), key,
                             device="cpu")
    assert torch.equal(full, ref)


def test_resume_with_auto_cascade(tmp_path):
    """"auto" derives the same schedule on resume, so the resumed image is
    the uninterrupted one."""
    scene, cam = _cornell()
    s = RenderSettings(24, 24, 8, 12, (0.0, 0.0, 0.0), spp_chunk=4, cascade_schedule="auto")
    key = prng_key(5)
    sched = render.derive_cascade_schedule(scene, cam, s, key, device="cpu")
    assert sched is not None
    full, _ = render_radiance_checkpointed(scene, cam, s, key, str(tmp_path / "a.npz"),
                                           device="cpu")
    p = str(tmp_path / "b.npz")
    _partial(scene, cam, key, s, 1, p, cascade_schedule=sched)
    resumed, _ = render_radiance_checkpointed(scene, cam, s, key, p, device="cpu")
    assert torch.equal(full, resumed)


def test_checkpointed_auto_overflow_recovers(tmp_path, monkeypatch):
    """"auto" with checkpoint_every > 1 does not raise on overflow: the
    window renders again on the plain path, so the image is the plain
    one.  An explicit schedule raises."""
    scene, cam = _cornell()
    key = prng_key(2)
    monkeypatch.setattr(render, "derive_cascade_schedule", lambda *a, **k: "1:64")
    s = RenderSettings(20, 20, 12, 10, (0.0, 0.0, 0.0), spp_chunk=4, cascade_schedule="auto")
    img, _ = render_radiance_checkpointed(scene, cam, s, key, str(tmp_path / "auto.npz"),
                                          checkpoint_every=2, device="cpu")
    plain = dataclasses.replace(s, cascade_schedule=None)
    ref, _ = render_radiance_checkpointed(scene, cam, plain, key, str(tmp_path / "p.npz"),
                                          checkpoint_every=2, device="cpu")
    assert torch.equal(img, ref)
    with pytest.raises(CascadeOverflowError):
        render_radiance_checkpointed(scene, cam, dataclasses.replace(s, cascade_schedule="1:64"),
                                     key, str(tmp_path / "exp.npz"), checkpoint_every=2,
                                     device="cpu")


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

SMALL = ["--scene", "CornellBox", "--width", "8", "--height", "8", "--spp", "4",
         "--max-bounces", "4", "--spp-chunk", "2", "--device", "cpu"]


def test_cli_checkpoint_writes_and_resumes(tmp_path, capsys):
    """--checkpoint saves the frame's sums; a second run resumes from the
    complete file (no chunk left) and writes the same PNG."""
    p = str(tmp_path / "frame.npz")
    out = str(tmp_path / "out")
    assert cli.main(SMALL + ["--checkpoint", p, "--checkpoint-every", "1",
                             "--output-dir", out]) == 0
    c = load_checkpoint(p)
    assert c.samples_done == 4 and (c.width, c.height, c.spp_total) == (8, 8, 4)
    first = open(os.path.join(out, "image_0000.png"), "rb").read()
    assert cli.main(SMALL + ["--checkpoint", p, "--output-dir", out]) == 0
    assert open(os.path.join(out, "image_0000.png"), "rb").read() == first
    assert "segments=" in capsys.readouterr().out


def test_cli_checkpoint_every_checked(capsys):
    with pytest.raises(SystemExit) as e:
        cli.main(SMALL + ["--checkpoint", "x.npz", "--checkpoint-every", "0"])
    assert e.value.code == 2 and "--checkpoint-every" in capsys.readouterr().err


def test_cli_mesh_needs_its_world(tmp_path, capsys, monkeypatch):
    """--mesh 2x2 in a world of 1 (no torchrun) exits 2 and renders
    nothing: never a single-device render instead."""
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    out = str(tmp_path / "out")
    assert cli.main(SMALL + ["--mesh", "2x2", "--output-dir", out]) == 2
    assert "world size is 1" in capsys.readouterr().err
    assert not os.path.exists(out)


@pytest.mark.parametrize("bad,msg", [
    (["--mesh", "2x2", "--regen"], "mutually exclusive"),
    (["--mesh", "2by2"], "TILESxSAMPLES"),
    (["--mesh", "0x2"], "at least 1"),
    (["--backend", "gloo"], "--mesh only"),
])
def test_cli_mesh_flags_checked(capsys, bad, msg):
    with pytest.raises(SystemExit) as e:
        cli.main(SMALL + bad)
    assert e.value.code == 2 and msg in capsys.readouterr().err


def _cli_ranks(tmp_path, name, mesh, world, extra=()):
    """The CLI with ``--mesh`` on ``world`` ranks, as torchrun starts
    them (RANK, WORLD_SIZE, LOCAL_RANK), meeting at a file store.
    Returns (the ranks' output, the output directory)."""
    out = str(tmp_path / name)
    os.makedirs(out)
    argv = [os.sys.executable, "-m", "rust_pathtracer_tpu_torch.cli", *SMALL, "--mesh",
            mesh, "--init-method", "file://" + os.path.join(out, "store"),
            "--output-dir", out, *extra]
    envs = [dict(RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r))
            for r in range(world)]
    return run_processes([argv] * world, envs, out, 120, name), out


def test_cli_mesh_two_ranks(tmp_path, capsys):
    """--mesh 2x1 on 2 ranks: rank 0 writes the PNG (the single-device
    CLI's, byte for byte) and prints the line, rank 1 prints nothing;
    --mesh 1x2 with --checkpoint writes the sharded checkpoint."""
    logs, out = _cli_ranks(tmp_path, "tiles", "2x1", 2)
    assert "wrote" in logs[0] and "mesh=2x1" in logs[0] and "segments=" in logs[0]
    assert "wrote" not in logs[1]
    single = str(tmp_path / "single")
    assert cli.main(SMALL + ["--output-dir", single]) == 0
    png = "image_0000.png"
    assert open(os.path.join(out, png), "rb").read() == open(os.path.join(single, png),
                                                             "rb").read()
    ckpt = str(tmp_path / "frame.npz")
    logs, out = _cli_ranks(tmp_path, "samples", "1x2", 2, ("--checkpoint", ckpt))
    c = load_checkpoint(ckpt)
    assert (c.samples_axis, c.chunk, c.samples_done, c.spp_total) == (2, 2, 2, 4)
    assert os.path.exists(os.path.join(out, png))


# ---------------------------------------------------------------------------
# the sharded checkpoint
# ---------------------------------------------------------------------------

# 16 spp over 2 sample groups in chunks of 2: 4 chunks a group
SHARDED = dict(width=16, height=16, samples_per_pixel=16, max_bounces=4,
               background=[0.0, 0.0, 0.0], spp_chunk=2)
SHARDED_AUTO = dict(SHARDED, max_bounces=12, spp_chunk=4, cascade_schedule="auto")
KEY = 7


def _sjob(mesh, path, cfg=SHARDED, **kw):
    return dict(mesh=list(mesh), scene="CornellBox", settings=cfg, key=KEY, path=path,
                **kw)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    """The sharded checkpoint runs.  On (2, 2): uninterrupted ("full"),
    stopped as chunk 2 starts in every rank ("stopped"), and the same two
    under "auto" (stopped as chunk 1 starts).  JAX's sharded checkpoint
    of the same render on its (4, 2) CPU mesh, stopped after 2 chunks.
    Then on (1, 2): the stopped files resumed, the JAX file resumed; on
    (2, 1): the stopped file, whose samples axis is 2, restarting."""
    from rust_pathtracer_tpu.parallel import make_mesh as j_make_mesh
    from rust_pathtracer_tpu.parallel import shard as j_shard
    from rust_pathtracer_tpu.render import RenderSettings as JRenderSettings

    tmp = tmp_path_factory.mktemp("sharded_ckpt")
    p = {k: str(tmp / f"{k}.npz") for k in ("full", "stopped", "auto_full",
                                              "auto_stopped", "mismatch", "jax",
                                              "to_jax")}
    first = run_ranks("checkpoint", 4, tmp, timeout=150, jobs=[
        _sjob((2, 2), p["full"], flushes=(16, 3)), _sjob((2, 2), p["stopped"], stop_at=2),
        _sjob((2, 2), p["auto_full"], SHARDED_AUTO),
        _sjob((2, 2), p["auto_stopped"], SHARDED_AUTO, stop_at=1)])
    stopped_file = load_checkpoint(p["stopped"])
    shutil.copy(p["stopped"], p["mismatch"])
    shutil.copy(p["stopped"], p["to_jax"])

    # JAX's file: its run stopped as its third chunk starts
    real = j_shard.ShardedChunkPlan.run_chunk
    ran = []

    def stopping(plan, c):
        if len(ran) == 2:
            raise _Stop()
        ran.append(c)
        return real(plan, c)

    jcfg = dict(SHARDED, background=tuple(SHARDED["background"]))
    jscene = j_get_scene("CornellBox")
    jargs = (jscene.build(), jscene.camera_at(0.0), JRenderSettings(**jcfg),
             jax.random.PRNGKey(KEY))
    j_shard.ShardedChunkPlan.run_chunk = stopping
    try:
        with pytest.raises(_Stop):
            j_checkpoint.render_radiance_sharded_checkpointed(
                *jargs, j_make_mesh(4, 2), p["jax"])
    finally:
        j_shard.ShardedChunkPlan.run_chunk = real

    second = run_ranks("checkpoint", 2, tmp, timeout=150, jobs=[
        _sjob((1, 2), p["stopped"]), _sjob((1, 2), p["auto_stopped"], SHARDED_AUTO),
        _sjob((1, 2), p["jax"]), _sjob((2, 1), p["mismatch"])])

    # the port's stopped file, finished by JAX on its (2, 2) mesh
    ran.clear()

    def recording(plan, c):
        ran.append(c)
        return real(plan, c)

    j_shard.ShardedChunkPlan.run_chunk = recording
    try:
        jimg, _ = j_checkpoint.render_radiance_sharded_checkpointed(
            *jargs, j_make_mesh(2, 2, devices=jax.devices()[:4]), p["to_jax"])
    finally:
        j_shard.ShardedChunkPlan.run_chunk = real
    jax_ran = list(ran)
    jfull, _ = j_checkpoint.render_radiance_sharded_checkpointed(
        *jargs, j_make_mesh(2, 2, devices=jax.devices()[:4]), str(tmp / "jfull.npz"))
    return dict(first=first, second=second, stopped_file=stopped_file,
                jax_img=np.asarray(jimg), jax_ran=jax_ran, jax_full=np.asarray(jfull))


def test_sharded_stopped_and_resumed_on_another_tile_count(sharded):
    """Stopped on (2, 2) after 2 of 4 chunks a group (the fault in every
    rank at chunk 2), resumed on (1, 2): bit for bit the uninterrupted
    (2, 2) render, with the segments; the resumed run traced chunks 2
    and 3 only."""
    full = sharded["first"][0]["jobs"][0]
    assert sharded["first"][0]["jobs"][1] == {"stopped": True, "ran": [0, 1]}
    c = sharded["stopped_file"]
    assert (c.samples_done, c.samples_axis, c.chunk) == (4, 2, 2)
    for rank in sharded["second"]:
        resumed = rank["jobs"][0]
        assert resumed["ran"] == [2, 3]
        assert torch.equal(resumed["img"], full["img"])
        assert resumed["segments"] == full["segments"]
    sd = get_scene("CornellBox")
    cfg = dict(SHARDED, background=(0.0, 0.0, 0.0))
    ref, _ = render_radiance(sd.build(), sd.camera_at(0.0), RenderSettings(**cfg),
                             prng_key(KEY), device="cpu")
    np.testing.assert_allclose(full["img"].numpy(), ref.numpy(), rtol=0, atol=2e-6)


def test_sharded_render_reduces_once_to_the_checkpoints_bits(sharded):
    """``render_radiance_sharded`` traces its 4 chunks a group with no
    collective and reduces them once (or at every third chunk, the
    second render): the same image and segments, bit for bit, as the
    checkpointed render, which reduces every chunk."""
    for rank in sharded["first"]:
        full = rank["jobs"][0]
        assert len(full["renders"]) == 2
        for r in full["renders"]:
            assert torch.equal(r["img"], full["img"])
            assert r["segments"] == full["segments"]


def test_sharded_auto_resume_derives_the_same_schedule(sharded):
    """"auto" resolves its schedule on chunk 0 each run (a calibration
    run of chunk 0 on the plain path), so a run stopped after chunk 0 and
    resumed on another tile count equals the uninterrupted one bit for
    bit."""
    full = sharded["first"][0]["jobs"][2]
    assert full["ran"] == [0, 0, 1]  # 16 spp, 2 groups, chunks of 4
    assert sharded["first"][0]["jobs"][3] == {"stopped": True, "ran": [0, 0]}
    resumed = sharded["second"][0]["jobs"][1]
    assert resumed["ran"] == [0, 1]
    assert torch.equal(resumed["img"], full["img"])
    cfg = dict(SHARDED_AUTO, background=(0.0, 0.0, 0.0), cascade_schedule=None)
    sd = get_scene("CornellBox")
    ref, _ = render_radiance(sd.build(), sd.camera_at(0.0), RenderSettings(**cfg),
                             prng_key(KEY), device="cpu")
    np.testing.assert_allclose(full["img"].numpy(), ref.numpy(), rtol=0, atol=2e-6)


def test_sharded_mismatched_samples_axis_restarts(sharded):
    """A file of a samples axis of 2 on a (2, 1) mesh: ignored, every
    chunk traced from 0, the image the single-device render's bit for
    bit (a samples axis of 1)."""
    rec = sharded["second"][0]["jobs"][3]
    assert rec["ran"] == list(range(8))
    sd = get_scene("CornellBox")
    cfg = dict(SHARDED, background=(0.0, 0.0, 0.0))
    ref, _ = render_radiance(sd.build(), sd.camera_at(0.0), RenderSettings(**cfg),
                             prng_key(KEY), device="cpu")
    assert torch.equal(rec["img"], ref)


def _close(a, b):
    return (np.abs(np.asarray(a) - np.asarray(b)) <= 2e-6).all(axis=-1).mean()


def test_sharded_files_cross_packages(sharded):
    """JAX's sharded file (stopped after 2 chunks on its (4, 2) mesh) is
    resumed by the port on (1, 2), which traces chunks 2 and 3 only; the
    port's stopped file is resumed by JAX on (2, 2), which traces the
    same two.  Each result against the finishing package's
    uninterrupted render (module note)."""
    resumed = sharded["second"][0]["jobs"][2]
    assert resumed["ran"] == [2, 3]
    assert _close(resumed["img"], sharded["first"][0]["jobs"][0]["img"]) >= 0.99
    assert sharded["jax_ran"] == [2, 3]
    assert _close(sharded["jax_img"], sharded["jax_full"]) >= 0.99
