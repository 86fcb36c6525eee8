"""Render checkpoints with exact resume (``utils/checkpoint.py``) on the
CPU: the cases of ``tests/test_checkpoint.py`` without its sharded ones,
plus the file format across the two packages and the CLI flags.

Tolerances: none.  A resumed render equals the uninterrupted one bit for
bit (the RNG keys on (pixel, sample), the restored sums are the saved
f32 values, and the chunks add in the same order); a file either package
writes loads in the other with equal fields.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch

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
