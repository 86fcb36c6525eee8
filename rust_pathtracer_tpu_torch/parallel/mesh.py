"""The (tiles, samples) grid of ``torch.distributed`` ranks.

Counterpart of ``rust_pathtracer_tpu/parallel/mesh.py``.  The reference
renders on one machine with rayon's work stealing over pixels
(renderer.rs:14-18); the port splits the same two axes over processes:

* ``tiles``: pixel tiles, each rank of a tile traces only its pixels;
* ``samples``: sample groups, each traces a disjoint sample range of the
  same pixels, and the partial sums add up over the sample axis.

One process a rank.  Rank r sits at (r // samples, r % samples), the row
major ``reshape(tiles, samples)`` of the JAX package's device mesh.
``distributed_init`` joins the process group (JAX's
``jax.distributed.initialize``) and returns the rank's device;
``make_mesh`` then builds the grid and its subgroups over the joined
ranks.  The backend is the caller's choice: NCCL where each rank has a
card of its own, gloo where ranks share a card or run on the CPU.  There
is no silent switch from one to the other.
"""

from __future__ import annotations

import dataclasses
import os
import socket
from datetime import timedelta
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

TILE_AXIS = "tiles"
SAMPLE_AXIS = "samples"

# every collective of the process group gives up after this long, so a
# rank that fails cannot leave the others blocked for ever
COLLECTIVE_TIMEOUT = timedelta(seconds=120)


def mesh_shape(world: int, tiles: Optional[int] = None, samples: int = 1
               ) -> Tuple[int, int]:
    """(tiles, samples) of a grid over ``world`` ranks, with the JAX
    package's errors: ``tiles`` defaults to world / samples."""
    if tiles is None:
        if world % samples != 0:
            raise ValueError(f"{world} devices not divisible by samples={samples}")
        tiles = world // samples
    if tiles * samples != world:
        raise ValueError(f"mesh {tiles}x{samples} != {world} devices")
    return tiles, samples


def check_backend(backend: str, device: torch.device, local_ranks: int,
                  device_count: int) -> None:
    """Raise where ``backend`` cannot serve ``local_ranks`` ranks of this
    host on ``device``: NCCL needs a card a rank (it refuses two ranks on
    one device), gloo serves any.  Nothing is switched: the caller picks
    gloo for ranks that share a card."""
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r}; want 'nccl' or 'gloo'")
    if backend != "nccl":
        return
    if device.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device a rank; ranks on "
                         "the CPU take backend='gloo'")
    if local_ranks > device_count:
        raise ValueError(
            f"the NCCL backend refuses two ranks on one device: {local_ranks} ranks "
            f"on this host, {device_count} CUDA device(s); ranks that share a card "
            "take backend='gloo'")


def rank_device(device: str, local_rank: int) -> torch.device:
    """The device of the rank ``local_rank`` of its host: ``cuda:{local_rank
    % device_count}``, or the CPU when ``device`` is "cpu"."""
    if device == "cpu":
        return torch.device("cpu")
    if device != "cuda":
        raise ValueError(f"unsupported device {device!r}; want 'cuda' or 'cpu'")
    if not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' was asked for, but "
                           "torch.cuda.is_available() is False")
    return torch.device("cuda", local_rank % torch.cuda.device_count())


def distributed_init(backend: str, init_method: Optional[str] = None,
                     world_size: Optional[int] = None, rank: Optional[int] = None,
                     *, device: str = "cuda",
                     timeout: timedelta = COLLECTIVE_TIMEOUT) -> torch.device:
    """Join the process group and return this rank's device.

    With no ``init_method``, ``world_size`` and ``rank``, reads torchrun's
    environment (``env://``: ``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``,
    ``WORLD_SIZE``); ``LOCAL_RANK`` (default: the rank) picks the card,
    ``cuda:{LOCAL_RANK % device_count}``, and ``device="cpu"`` puts the
    rank on the CPU.  Every collective gives up after ``timeout``.  Under
    NCCL, two ranks on one device raise here, before the first collective
    (``LOCAL_WORLD_SIZE`` against the cards where torchrun sets it, and
    the devices every rank publishes in the store in any case)."""
    rank = int(os.environ.get("RANK", 0)) if rank is None else rank
    world_size = (int(os.environ.get("WORLD_SIZE", 1)) if world_size is None
                  else world_size)
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    dev = rank_device(device, local_rank)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    check_backend(backend, dev, int(os.environ.get("LOCAL_WORLD_SIZE", 1)), n_cards)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank, timeout=timeout)
    if backend == "nccl":
        _check_nccl_devices(rank, world_size, dev)
    return dev


def _check_nccl_devices(rank: int, world: int, dev: torch.device) -> None:
    """Every rank publishes (host, device index) in the group's store and
    reads the others'; two ranks on one device raise (NCCL would refuse
    them at the first collective)."""
    store = dist.distributed_c10d._get_default_store()
    mine = f"{socket.gethostname()}:{dev.index}"
    store.set(f"rpt_device/{rank}", mine)
    seen = {}
    for r in range(world):
        where = store.get(f"rpt_device/{r}").decode()
        if where in seen:
            dist.destroy_process_group()
            raise ValueError(
                f"the NCCL backend refuses two ranks on one device: ranks "
                f"{seen[where]} and {r} are both on {where}; ranks that share a "
                "card take backend='gloo'")
        seen[where] = r


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A (tiles, samples) grid over the joined ranks, or over a subset
    of them (``make_mesh``'s ``ranks``).

    ``rank``: this rank's index in the grid (its global rank where the
    grid spans the world); ``group``: the grid's ranks (None: the whole
    world), over which the statistics and the gradients reduce;
    ``sample_group``: the ranks of this rank's tile, over which the
    per-tile sum of sample partials runs; ``tile_group``: the ranks of
    this rank's sample index, over which the tiles gather into the image.
    Each subgroup is None where it holds this rank alone.  ``device``:
    where this rank renders."""

    tiles: int
    samples: int
    rank: int
    device: torch.device
    sample_group: Optional[object]
    tile_group: Optional[object]
    group: Optional[object] = None

    @property
    def shape(self):
        return {TILE_AXIS: self.tiles, SAMPLE_AXIS: self.samples}

    @property
    def coord(self) -> Tuple[int, int]:
        """(tile, sample group) of this rank."""
        return divmod(self.rank, self.samples)

    def barrier(self) -> None:
        if self.device.type == "cuda" and dist.get_backend() == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)


def make_mesh(tiles: Optional[int] = None, samples: int = 1, *,
              device: torch.device, ranks: Optional[Sequence[int]] = None
              ) -> Optional[Mesh]:
    """The (tiles, samples) grid over ``ranks`` (default: every rank of
    the process group, in order), with its subgroups; grid index i is
    ``ranks[i]``, the JAX package's ``devices`` argument.  Every rank of
    the process group must call it, in the same order as any other
    ``make_mesh``, since each builds the same groups; a rank outside
    ``ranks`` gets None.  Each rank of the grid runs one collective on
    each of its groups before it returns.  ``device``: this rank's device
    (``distributed_init``'s)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs the process group: call "
                           "distributed_init first")
    world, me = dist.get_world_size(), dist.get_rank()
    members = list(range(world)) if ranks is None else [int(r) for r in ranks]
    if len(set(members)) != len(members) or not all(0 <= r < world for r in members):
        raise ValueError(f"ranks {members} are not distinct ranks of a world of {world}")
    tiles, samples = mesh_shape(len(members), tiles, samples)
    group = None if members == list(range(world)) else dist.new_group(members)
    rank = members.index(me) if me in members else None
    sample_group = tile_group = None
    # every rank builds every group of more than one rank, in one order
    if samples > 1:
        for t in range(tiles):
            g = dist.new_group([members[t * samples + s] for s in range(samples)])
            if rank is not None and rank // samples == t:
                sample_group = g
    if tiles > 1:
        for s in range(samples):
            g = dist.new_group([members[t * samples + s] for t in range(tiles)])
            if rank is not None and rank % samples == s:
                tile_group = g
    if rank is None:
        return None
    # NCCL sets up a group's communicator at the group's first collective:
    # one here on each of this rank's groups keeps that out of the first
    # render (every rank runs them in one order: samples, tiles, the grid)
    probe = torch.zeros(1, device=device)
    for g in (sample_group, tile_group):
        if g is not None:
            dist.all_reduce(probe, group=g)
    dist.all_reduce(probe, group=group)
    return Mesh(tiles=tiles, samples=samples, rank=rank, device=torch.device(device),
                sample_group=sample_group, tile_group=tile_group, group=group)
