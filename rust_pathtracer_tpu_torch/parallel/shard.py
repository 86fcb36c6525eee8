"""Rendering over a (tiles, samples) grid of ranks.

Counterpart of ``rust_pathtracer_tpu/parallel/shard.py``; plain tensor
code and ``torch.distributed`` collectives around the renderer.

* each rank derives its tile's pixel ids from its grid coordinate: the
  pixels padded to a multiple of the tile count, the padded ids wrapping
  to pixel 0 (traced, then cropped);
* sample group s owns samples [s * spp_shard, (s + 1) * spp_shard),
  traced in chunks of ``min(resolve_chunk(), spp_shard)``; samples past
  ``spp`` are masked;
* the counter RNG keys off (pixel, sample) globally, so every lane
  traces the path it traces in the single-device render.

A frame reduces once: a rank traces its chunks with no collective, then
the sample partials of its tile add up over the tile's ranks
(``Mesh.sample_group``), chunk by chunk in sample-group order, the tile's
chunks add up in chunk order, and the tiles gather into the image over
``Mesh.tile_group``.  The sample sum and the gather are each an
all-reduce of a stack that holds each rank's tensor in its own slot and
zeros elsewhere, so the sum is exact and in a fixed order, the same on
every rank and for any tile count.  The statistics reduce once a frame
too: segments and occupancy add up over every rank, and bounces and the
worst-rank occupancy take the maximum, chunk by chunk.  A frame of more
than ``FLUSH_CHUNKS`` chunks sums its samples every ``FLUSH_CHUNKS``
chunks, so a rank holds at most that many chunks' partials.  Every rank
returns the full (H, W, 3) image.  Where the samples axis is 1 the image
is the single-device render's bit for bit; otherwise the per-pixel sums
run in another order (within ``atol = 2e-6`` on the tests' shapes, as in
the JAX package).

``ShardedChunkPlan.run_chunk`` reduces a single chunk the same way, in
four collectives: the sharded checkpoint runs it chunk by chunk, since
its file holds the whole image's sums after each chunk (every rank's
tile, summed over the samples axis) so that a job can resume on another
tile count; the "auto" cascade's calibration chunk runs it for the
worst-rank occupancy.  The sums come out the same bits either way.

Only ``all_reduce`` (and ``barrier``) is used: gloo takes it on CUDA
tensors (ProcessGroupGloo copies them through the host) as NCCL does, so
ranks that share a card run over gloo with no staging of our own.

The cascade runs per rank on static schedules only, as the JAX
package's: an explicit schedule runs as given; a dynamic request warns
and renders the plain chunked path; the overflow guard (occupancy[-1],
summed over every rank) raises ``CascadeOverflowError``; "auto"
calibrates on chunk 0 with the worst-rank occupancy and widens its
margin on overflow, three attempts.  Unlike the JAX package's retry
(which reuses chunk-0 totals it donated, ``parallel/shard.py:267``),
each attempt adds onto chunk 0's result, which stays alive.

Differentiable (``settings.differentiable``): the image carries autograd
through ``torch.distributed.nn.functional.all_reduce``, whose backward
all-reduces the cotangent.  The loss that counts is rank 0's: the image
passes rank 0's cotangent into the collectives' backward and drops the
other ranks', so every rank builds the same loss and calls backward (it
must: the backward runs collectives), and each rank's leaves then hold
the partial gradient of its own lanes.  ``reduce_replicated_grads``
adds those partials up over every rank, once, which gives every
replicated leaf of ``DiffParams`` the single-device gradient (the
counterpart of the JAX package's ``ops/fused_bounce.py:979
_psum_to_replicated``).  Had every rank's cotangent counted, each
gradient would come back tiles x samples times too large.  A geometry
leaf (``scene.prims.data`` under ``diff_t="rederive"``) is summed the
same way: pass it to ``reduce_replicated_grads`` beside the
``DiffParams`` leaves.  The plan draws under ``settings.rng_scheme``
on every rank.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import torch
import torch.distributed as dist
import torch.distributed.nn.functional as dist_fn

from rust_pathtracer_tpu_torch.camera import Camera
from rust_pathtracer_tpu_torch.integrator import TraceStats
from rust_pathtracer_tpu_torch.parallel.mesh import Mesh
from rust_pathtracer_tpu_torch.render import (
    AUTO_MARGIN,
    CascadeOverflowError,
    RenderSettings,
    _cascade_static_schedule,
    _derive_cascade_schedule,
    _maybe_prepend_reorder,
    _render_chunk_cascaded,
    trace_pixel_lanes,
    uses_cascade,
)
from rust_pathtracer_tpu_torch.utils.metrics import span


# a rank sums the samples of at most this many chunks at once (a chunk's
# partial is pix_per_tile x 3 floats)
FLUSH_CHUNKS = 16


def _slot_all_reduce(x, index: int, size: int, group):
    """(size, *x.shape): every rank's ``x`` of ``group`` at its index, on
    every rank.  One all-reduce of a stack that holds ``x`` at ``index``
    and zeros elsewhere, so each slot is its rank's tensor exactly; the
    backward all-reduces the cotangent over the group.  It moves about
    twice the bytes of an all_gather; it runs once a frame, and its
    backward is the same all-reduce on every backend (all_gather's takes
    reduce_scatter under NCCL and all_to_all under gloo)."""
    slots = [x if i == index else torch.zeros_like(x) for i in range(size)]
    with warnings.catch_warnings():
        # newer torch marks this all_reduce deprecated in favour of the
        # functional collectives, whose all_reduce has no backward
        warnings.filterwarnings("ignore", category=FutureWarning,
                                message=r"torch\.distributed\.nn\.functional\.all_reduce")
        return dist_fn.all_reduce(torch.stack(slots), group=group)


class _CotangentFromRank0(torch.autograd.Function):
    """The identity; in the backward, rank 0's cotangent passes and the
    other ranks' become zeros (see the module note)."""

    @staticmethod
    def forward(ctx, img, keep):
        ctx.keep = keep
        return img.clone()

    @staticmethod
    def backward(ctx, grad):
        return (grad if ctx.keep else torch.zeros_like(grad)), None


def _reduce_stats(stats, group):
    """Each chunk's segments and occupancy summed over the grid's ranks,
    its bounces and occupancy at their maximum: (segments (n,), bounces
    (n ints), occupancy (n, M), worst-rank occupancy (n, M)) for the n
    chunks' ``TraceStats`` of ``stats``.  Two all-reduces and one sync,
    no autograd."""
    n = len(stats)
    occ = torch.stack([st.occupancy.detach().to(torch.float32) for st in stats])
    dev = occ.device
    segs = torch.stack([st.segments.detach().reshape(()).to(torch.float32)
                        for st in stats])
    total = torch.cat([segs, occ.reshape(-1)])
    peak = torch.cat([torch.tensor([float(st.bounces) for st in stats], device=dev),
                      occ.reshape(-1)])
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(peak, op=dist.ReduceOp.MAX, group=group)
    with span("rpt.sync"):
        bounces = [int(b) for b in peak[:n].tolist()]
    return total[:n], bounces, total[n:].view(n, -1), peak[n:].view(n, -1)


class ShardedChunkPlan:
    """One rank's part of a sharded render, a sample chunk at a time.

    The chunk granularity is the host's: ``trace_chunk`` traces a chunk
    with no collective, ``sample_sums`` and ``gather_tiles`` reduce, and
    ``run_chunk`` does all three for one chunk, so a caller can persist
    the accumulation state between chunks (the sharded checkpoint).
    Every rank must reduce the same chunks in the same order."""

    def __init__(self, scene, cam: Camera, settings: RenderSettings, key,
                 mesh: Mesh, background=None):
        dev = mesh.device
        self.mesh, self.settings = mesh, settings
        self.scene, self.cam = scene.to(dev), cam.to(dev)
        self.key = torch.as_tensor(key, dtype=torch.int64, device=dev)
        self.bg = torch.as_tensor(
            settings.background if background is None else background,
            dtype=torch.float32, device=dev)
        width, height = settings.width, settings.height
        spp = settings.samples_per_pixel
        tile, s_group = mesh.coord
        self.npix = npix = width * height
        npix_pad = -(-npix // mesh.tiles) * mesh.tiles
        # each sample group owns a contiguous sample range
        self.spp_shard = spp_shard = -(-spp // mesh.samples)
        self.chunk = chunk = min(settings.resolve_chunk(), spp_shard)
        self.n_chunks = -(-spp_shard // chunk)
        self.pix_per_tile = ppt = npix_pad // mesh.tiles
        self.lanes_per_shard = ppt * chunk
        self.n_samples_axis = mesh.samples
        self.pix = (tile * ppt + torch.arange(ppt, dtype=torch.int64, device=dev)) % npix
        self.base = s_group * spp_shard

        # static cascade per rank; "auto" is resolved by the callers
        # (chunk-0 calibration) before a plan is built
        self.schedule = None
        stages = []
        if uses_cascade(settings):
            sched = settings.cascade_schedule
            stages = _cascade_static_schedule(settings.max_bounces, self.lanes_per_shard,
                                              sched if sched != "auto" else None)
            if stages:
                self.schedule = sched
            elif sched != "auto":
                warnings.warn(
                    "sharded render: cascade requested but no applicable STATIC "
                    f"schedule (the dynamic cascade is single-device only; got "
                    f"{sched!r} for {self.lanes_per_shard} lanes a rank): rendering "
                    "the plain chunked path", stacklevel=3)
        self.cascade_stages = tuple(stages) if stages else None

    def trace_chunk(self, c: int):
        """Trace sample chunk ``c`` of this rank's sample group over its
        tile's pixels, no collective: (the (pix_per_tile, 3) radiance
        sums, TraceStats)."""
        s = self.settings
        args = dict(width=s.width, height=s.height, spp_chunk=self.chunk,
                    spp_total=s.samples_per_pixel, max_bounces=s.max_bounces,
                    rr_start=s.russian_roulette_start, rng_scheme=s.rng_scheme,
                    reorder=s.reorder)
        offset = self.base + c * self.chunk
        if self.cascade_stages:
            part, stats = _render_chunk_cascaded(self.scene, self.cam, self.key, offset,
                                                 self.bg, schedule=self.schedule,
                                                 pix=self.pix, **args)
        else:
            part, stats = trace_pixel_lanes(self.scene, self.cam, self.key, self.pix,
                                            offset, self.bg,
                                            differentiable=s.differentiable,
                                            remat=s.remat, diff_t=s.diff_t,
                                            diff_cascade=s.diff_cascade, **args)
        return part, stats

    def sample_sums(self, parts):
        """The tile's sums over the samples axis of a list of chunks'
        ``trace_chunk`` sums, each in sample-group order; one all-reduce
        for the list."""
        mesh = self.mesh
        if mesh.sample_group is None:
            return list(parts)
        stacked = _slot_all_reduce(torch.stack(parts), mesh.coord[1], mesh.samples,
                                   mesh.sample_group)
        out = []
        for j in range(len(parts)):
            p = stacked[0, j]
            for i in range(1, mesh.samples):
                p = p + stacked[i, j]
            out.append(p)
        return out

    def gather_tiles(self, tile_sums):
        """(npix_pad, 3): every tile's (pix_per_tile, 3) sums, on every
        rank; one all-reduce."""
        mesh = self.mesh
        if mesh.tile_group is None:
            return tile_sums
        return _slot_all_reduce(tile_sums, mesh.coord[0], mesh.tiles,
                                mesh.tile_group).reshape(-1, 3)

    def run_chunk(self, c: int):
        """Trace and reduce sample chunk ``c`` (see the module note):
        (acc (npix_pad, 3): the chunk's radiance sums of every pixel,
        gathered over the tiles and summed over the samples axis,
        segments, bounces, occupancy, worst-rank occupancy), the same on
        every rank."""
        part, stats = self.trace_chunk(c)
        acc = self.gather_tiles(self.sample_sums([part])[0])
        segments, bounces, occupancy, occ_max = _reduce_stats([stats], self.mesh.group)
        return acc, segments[0], bounces[0], occupancy[0], occ_max[0]

    def finalize(self, acc, segments, bounces, occupancy):
        """(image (H, W, 3), TraceStats) from the chunks' totals."""
        s = self.settings
        spp = torch.tensor(float(s.samples_per_pixel), dtype=torch.float32,
                           device=acc.device)
        img = (acc[:self.npix] / spp).reshape(s.height, s.width, 3)
        if img.requires_grad:
            img = _CotangentFromRank0.apply(img, self.mesh.rank == 0)
        return img, TraceStats(segments=segments, bounces=bounces, occupancy=occupancy)


def _run_chunks(plan: ShardedChunkPlan, first: int, totals=None):
    """Chunks [first, n_chunks) added onto ``totals`` (acc, segments,
    bounces, occupancy: ``run_chunk``'s), or onto nothing; ``totals`` is
    not changed.  The chunks reduce once (every ``FLUSH_CHUNKS`` for the
    sample sum), in the order ``run_chunk`` after ``run_chunk`` would add
    them: the same bits."""
    mesh = plan.mesh
    acc = segments = bounces = occupancy = None
    if totals is not None:
        acc, segments, bounces, occupancy = totals
        ppt = plan.pix_per_tile
        acc = acc[mesh.coord[0] * ppt:(mesh.coord[0] + 1) * ppt]  # this tile's rows
    pending, stats = [], []
    for c in range(first, plan.n_chunks):
        part, st = plan.trace_chunk(c)
        pending.append(part)
        stats.append(st)
        if len(pending) == FLUSH_CHUNKS or c == plan.n_chunks - 1:
            for p in plan.sample_sums(pending):
                acc = p if acc is None else acc + p
            pending = []
    if not stats:
        return totals
    acc = plan.gather_tiles(acc)
    segs, bnc, occ, _ = _reduce_stats(stats, mesh.group)
    for j in range(len(stats)):
        if segments is None:
            segments, bounces, occupancy = segs[j], bnc[j], occ[j]
        else:
            segments = segments + segs[j]
            bounces = bounces + bnc[j]  # summed over chunks, as the renderer's
            occupancy = occupancy + occ[j]
    return acc, segments, bounces, occupancy


def render_radiance_sharded(scene, cam: Camera, settings: RenderSettings, key,
                            mesh: Mesh, background=None):
    """The sharded render; returns ((H, W, 3) radiance, TraceStats) on
    every rank, on ``mesh.device``.  Every rank of the mesh must call it
    with the same arguments.

    The cascade's guard is the renderer's: an explicit static schedule
    that drops live lanes (occupancy[-1] summed over every rank > 0)
    raises CascadeOverflowError on every rank; "auto" calibrates on chunk
    0 (the plain path, the worst rank's occupancy sets the widths a
    rank), renders the other chunks cascaded, and on overflow derives the
    schedule again at double the margin, three attempts, then renders
    them on the plain path."""
    with span("rpt.frame"):
        auto = settings.cascade_schedule == "auto" and uses_cascade(settings)
        if not auto:
            plan = ShardedChunkPlan(scene, cam, settings, key, mesh, background)
            totals = _run_chunks(plan, 0)
            if plan.cascade_stages:
                with span("rpt.sync"):
                    dropped = float(totals[3][-1])
                if dropped > 0.0:
                    raise CascadeOverflowError(
                        f"sharded static cascade schedule {settings.cascade_schedule!r} "
                        f"dropped {dropped:.0f} live lanes across ranks "
                        "(occupancy[-1] > 0): the image is biased.  Widen the schedule "
                        "or use cascade_schedule='auto'.")
            return plan.finalize(*totals)

        # auto: chunk 0 on the plain path is the calibration run
        plain = dataclasses.replace(settings, cascade=False, cascade_schedule=None)
        plan0 = ShardedChunkPlan(scene, cam, plain, key, mesh, background)
        a0, s0, b0, o0, om0 = plan0.run_chunk(0)
        first = (a0, s0, b0, o0)
        if plan0.n_chunks == 1:
            return plan0.finalize(*first)
        with span("rpt.sync"):
            om0_host = om0.cpu().numpy()
        margin = AUTO_MARGIN
        for _ in range(3):
            sched = _derive_cascade_schedule(om0_host, plan0.lanes_per_shard,
                                             settings.max_bounces, margin=margin)
            sched = _maybe_prepend_reorder(sched, plan0.scene)
            if sched is None:
                break  # no boundary pays: the plain path for the rest
            plan1 = ShardedChunkPlan(
                scene, cam, dataclasses.replace(settings, cascade=True, cascade_schedule=sched),
                key, mesh, background)
            if not plan1.cascade_stages:
                break
            totals = _run_chunks(plan1, 1, first)
            # the cascaded chunks' guard slot only: chunk 0 ran the plain path,
            # whose occupancy[-1] is a real alive count at deep bounces
            with span("rpt.sync"):
                dropped = float(totals[3][-1] - o0[-1])
            if dropped == 0.0:
                return plan1.finalize(*totals)
            warnings.warn(
                f"sharded auto cascade schedule {sched!r} dropped {dropped:.0f} live "
                f"lanes: deriving again at margin {margin * 2:g} and rendering again",
                stacklevel=2)
            margin *= 2.0
        return plan0.finalize(*_run_chunks(plan0, 1, first))


def reduce_replicated_grads(params, mesh: Optional[Mesh] = None):
    """All-reduce (sum) over the ranks of ``mesh`` (default: every rank)
    the partial gradients that a sharded backward left in ``.grad`` of
    each leaf of ``params`` (a ``DiffParams`` or a sequence of tensors; a
    leaf without one counts zero), one all-reduce for all of them.  Each leaf that requires grad
    gets the sum as its ``.grad``; returns the sums in the same form as
    ``params``."""
    from rust_pathtracer_tpu_torch.grad import DiffParams

    is_params = isinstance(params, DiffParams)
    leaves = list(params.leaves() if is_params else params)
    flat = torch.cat([(x.grad if x.grad is not None else torch.zeros_like(x)
                       ).detach().reshape(-1) for x in leaves])
    dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=None if mesh is None else mesh.group)
    out, at = [], 0
    for x in leaves:
        g = flat[at:at + x.numel()].view_as(x)
        at += x.numel()
        if x.requires_grad:
            x.grad = g
        out.append(g)
    return DiffParams.from_leaves(out) if is_params else out


def render_loss_and_grad_sharded(params, scene, settings: RenderSettings, key, target,
                                 mesh: Mesh):
    """``grad.render_loss_and_grad`` over the mesh: (loss, gradients as a
    DiffParams), the same on every rank and equal to the single-device
    step's.  Rank 0's loss counts (module note); every rank calls this
    with the same arguments.  A ``scene.prims.data`` that requires grad
    (``settings.diff_t = "rederive"``), with no ``.grad`` yet, gets the
    summed gradient in its ``.grad`` on every rank."""
    from rust_pathtracer_tpu_torch.grad import DiffParams, apply_params

    dev = mesh.device
    leaves = [x.detach().to(dev).requires_grad_(True) for x in params.leaves()]
    p = DiffParams.from_leaves(leaves)
    settings = dataclasses.replace(settings, differentiable=True)
    img, _ = render_radiance_sharded(apply_params(scene.to(dev), p), p.camera.build(),
                                     settings, key, mesh, background=p.background)
    target = torch.as_tensor(target, dtype=torch.float32, device=dev)
    loss = 0.5 * torch.mean((img - target) ** 2)
    loss.backward()
    data = scene.prims.data
    grads = reduce_replicated_grads(leaves + ([data] if data.requires_grad else []), mesh)
    return loss.detach(), DiffParams.from_leaves(grads[:len(leaves)])
