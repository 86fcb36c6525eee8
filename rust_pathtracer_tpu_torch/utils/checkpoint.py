"""Render checkpoints with exact resume (single device).

Counterpart of ``rust_pathtracer_tpu/utils/checkpoint.py``; plain host
code around the renderer.

The accumulation state of a frame (the radiance sums, the samples done
and the base key) is saved between sample chunks.  The RNG is keyed by
(pixel, sample) counters, so a resumed render replays the remaining
lanes exactly and its image equals the uninterrupted one bit for bit.
The file is the JAX package's ``.npz`` with the same fields; ``key_data``
holds the key's two 32-bit words, so a file that either package wrote
loads in the other.

Not ported yet: ``render_radiance_sharded_checkpointed``, which waits for
sharding (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import os
import tempfile
from typing import NamedTuple, Optional

import numpy as np


class RenderCheckpoint(NamedTuple):
    acc: np.ndarray          # (H*W, 3) radiance sums over the completed samples
    samples_done: int        # samples completed (a chunk boundary)
    width: int
    height: int
    spp_total: int
    key_data: np.ndarray     # the key's two 32-bit words
    segments: float
    # a sharded render's samples-axis extent and chunk (the JAX
    # package's sharded checkpoints); 1 and 0 on a single device
    samples_axis: int = 1
    chunk: int = 0


def save_checkpoint(path: str, ckpt: RenderCheckpoint) -> None:
    """Write ``ckpt`` to ``path`` atomically: a temporary file in the same
    directory, then ``os.replace``, so a crash mid-save leaves the old
    file whole."""
    folder = os.path.dirname(os.path.abspath(path))
    os.makedirs(folder, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=folder)
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, acc=ckpt.acc, samples_done=ckpt.samples_done,
                     width=ckpt.width, height=ckpt.height, spp_total=ckpt.spp_total,
                     key_data=ckpt.key_data, segments=ckpt.segments,
                     samples_axis=ckpt.samples_axis, chunk=ckpt.chunk)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def load_checkpoint(path: str) -> Optional[RenderCheckpoint]:
    """The checkpoint at ``path``, or None where there is no file."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return RenderCheckpoint(
            acc=z["acc"], samples_done=int(z["samples_done"]), width=int(z["width"]),
            height=int(z["height"]), spp_total=int(z["spp_total"]),
            key_data=z["key_data"], segments=float(z["segments"]),
            samples_axis=int(z["samples_axis"]) if "samples_axis" in z else 1,
            chunk=int(z["chunk"]) if "chunk" in z else 0,
        )


def key_data(key) -> np.ndarray:
    """The (2,) uint32 words of a raw key, as the JAX package saves them."""
    return np.asarray(key.cpu() if hasattr(key, "cpu") else key).astype(np.uint32)


def render_radiance_checkpointed(scene, cam, settings, key, checkpoint_path: str,
                                 checkpoint_every: int = 1, *, device):
    """The chunked render of ``render.render_radiance`` on ``device``,
    saving its progress to ``checkpoint_path`` every ``checkpoint_every``
    sample chunks, and resuming from that file where it matches the job
    (width, height, samples per pixel, key); a file that does not match
    is ignored.  Returns (image (H, W, 3), TraceStats with the segments;
    bounces and occupancy are not kept across a resume, so they are 0).

    The cascade runs as in ``render_radiance``: "auto" derives its
    schedule from the probe, which is deterministic, so a resumed run
    derives the same one.  The overflow guard runs at each save, over
    the chunks since the last: an explicit schedule that dropped live
    lanes raises CascadeOverflowError; an "auto" one renders those
    chunks again on the plain chunked path, so resume stays exact."""
    import torch

    from rust_pathtracer_tpu_torch.integrator import MAX_BOUNCE_STATS, TraceStats
    from rust_pathtracer_tpu_torch.render import (
        CascadeOverflowError,
        _cascade_static_schedule,
        _render_chunk,
        _render_chunk_cascaded,
        derive_cascade_schedule,
        resolve_device,
        uses_cascade,
    )

    dev = resolve_device(device)
    scene, cam = scene.to(dev), cam.to(dev)
    key = torch.as_tensor(key, dtype=torch.int64, device=dev)
    spp, chunk = settings.samples_per_pixel, settings.resolve_chunk()
    npix = settings.width * settings.height
    use_cascade = uses_cascade(settings)
    schedule = settings.cascade_schedule
    auto = use_cascade and schedule == "auto"
    if auto:
        schedule = derive_cascade_schedule(scene, cam, settings, key, device=dev)
    static_applies = use_cascade and bool(
        _cascade_static_schedule(settings.max_bounces, npix * chunk, schedule))
    bg = torch.as_tensor(settings.background, dtype=torch.float32, device=dev)
    words = key_data(key)

    start, segments = 0, 0.0
    acc = torch.zeros((npix, 3), dtype=torch.float32, device=dev)
    ckpt = load_checkpoint(checkpoint_path)
    if ckpt is not None and (ckpt.width, ckpt.height, ckpt.spp_total) == (
            settings.width, settings.height, spp) and np.array_equal(ckpt.key_data, words):
        start, segments = ckpt.samples_done, ckpt.segments
        acc = torch.as_tensor(ckpt.acc, dtype=torch.float32, device=dev)

    args = dict(width=settings.width, height=settings.height, spp_chunk=chunk,
                spp_total=spp, max_bounces=settings.max_bounces,
                rr_start=settings.russian_roulette_start)

    def plain_chunk(s0):
        return _render_chunk(scene, cam, key, s0, bg,
                             differentiable=settings.differentiable,
                             remat=settings.remat, **args)

    # segments and the overflow count stay on the device between saves
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    seg_dev, overflow_dev = zero, zero
    acc_save, seg_save, window = acc, seg_dev, []

    def guard(acc, seg_dev, overflow_dev):
        """(acc, seg_dev) with the window's chunks made exact."""
        if static_applies and float(overflow_dev) > 0.0:
            if not auto:
                raise CascadeOverflowError(
                    f"static cascade schedule {schedule!r} dropped "
                    f"{float(overflow_dev):.0f} live lanes in a checkpointed "
                    "window: the image is biased.")
            acc, seg_dev = acc_save, seg_save
            for s0w in window:
                part, stats = plain_chunk(s0w)
                acc = acc + part
                seg_dev = seg_dev + stats.segments
        return acc, seg_dev

    for n_chunk, s0 in enumerate(range(start, spp, chunk), 1):
        window.append(s0)
        if use_cascade:
            part, stats = _render_chunk_cascaded(scene, cam, key, s0, bg,
                                                 schedule=schedule, **args)
            if static_applies:
                overflow_dev = overflow_dev + stats.occupancy[-1]
        else:
            part, stats = plain_chunk(s0)
        acc = acc + part
        seg_dev = seg_dev + stats.segments
        if n_chunk % checkpoint_every == 0:
            acc, seg_dev = guard(acc, seg_dev, overflow_dev)
            overflow_dev = zero
            acc_save, seg_save, window = acc, seg_dev, []
            save_checkpoint(checkpoint_path, RenderCheckpoint(
                acc=acc.detach().cpu().numpy(), samples_done=min(s0 + chunk, spp),
                width=settings.width, height=settings.height, spp_total=spp,
                key_data=words, segments=segments + float(seg_dev)))
    acc, seg_dev = guard(acc, seg_dev, overflow_dev)
    segments += float(seg_dev)

    img = (acc / torch.tensor(float(spp), dtype=torch.float32, device=dev)
           ).reshape(settings.height, settings.width, 3)
    return img, TraceStats(
        segments=torch.tensor(segments, dtype=torch.float32, device=dev), bounces=0,
        occupancy=torch.zeros(MAX_BOUNCE_STATS, dtype=torch.float32, device=dev))
