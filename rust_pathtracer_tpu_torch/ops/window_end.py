"""The regen wavefront's window end in queue mode, on the device.

No Pallas counterpart: in the JAX package the window end
(``flush_refill``) is XLA's scatter-add, cumsum and spawn.  This module
wraps three CUDA kernels (``csrc/window_end.cu``) around one library sort
(``csrc/pool_sort.cu``, CUB's stable radix sort): the finish (the finished
lanes, their sort keys, the depth histogram, each row's count, the device
block of counts), the sort of (pixel, lane) pairs, the add (each pixel's
finished radiance in lane order) and the respawn (the finished lanes'
ranks, their next work ids and camera lanes, written in place).  Every
launch takes its sizes from device memory; the host reads the device
block one window late (``WindowEnd.previous``), only to end the loop.

Its plain twin is ``wavefront._flush_refill`` (tensor ops, with a
``nonzero`` and a ``bincount`` that the host reads), which runs every
window end this module does not take: the CPU's, and stripe mode's
(``_advance_stripe``).  ``window_end_ok`` says which it takes; the kernels
launch on CUDA tensors (and count in ``launches``) or raise.
"""

from __future__ import annotations

import contextlib
import ctypes

import torch

# kernel launches of the three hand-written kernels (CUDA tensors only)
launches = 0

HIST_BINS = 64  # csrc/window_end.cu; integrator.MAX_BOUNCE_STATS
# the device block's int32 words (csrc/window_end.cu enum Ctl)
CTL_HANDED, CTL_WID0, CTL_N_FIN, CTL_N_TAKE, CTL_LIVE = range(5)
CTL_WORDS = 8


def window_end_ok(device, mode: str) -> bool:
    """Whether a regen window end on ``device`` in ``mode`` takes the
    kernels: queue mode on a CUDA device.  The CPU and stripe mode keep
    the tensor ops (``wavefront._flush_refill``, ``_advance_stripe``)."""
    return torch.device(device).type == "cuda" and mode == "queue"


def camera_params(cam) -> torch.Tensor:
    """The camera's 19 f32 on its device (csrc/window_end.cu enum Cam):
    origin, lower left corner, horizontal, vertical, u, v, lens radius."""
    return torch.cat([cam.origin, cam.lower_left_corner, cam.horizontal, cam.vertical,
                      cam.u, cam.v, cam.lens_radius.reshape(1)]).to(torch.float32).detach()


def _library(name: str):
    from rust_pathtracer_tpu_torch.ops._build import load_library

    return load_library(name)


def _stream(dev: torch.device):
    return torch.cuda.current_stream(dev).cuda_stream if dev.type == "cuda" else None


def _check(lib, err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"window end {what} failed: {lib.error_string(err).decode()}")


def sort_pairs(keys, vals, end_bit: int, scratch) -> int:
    """Sort the pairs (keys[0], vals[0]) stably on the keys' low
    ``end_bit`` bits (CUB, ``csrc/pool_sort.cu``), with keys[1] and
    vals[1] the other buffers and ``scratch`` its uint8 scratch.  Returns
    which buffer holds the sorted pairs."""
    lib = _library("pool_sort")
    sel = ctypes.c_int(-1)
    _check(lib, lib.pool_sort_launch(
        scratch.data_ptr(), scratch.numel(), keys[0].data_ptr(), keys[1].data_ptr(),
        vals[0].data_ptr(), vals[1].data_ptr(), keys.shape[1], end_bit,
        ctypes.addressof(sel), _stream(keys.device)), "sort")
    return sel.value


def sort_scratch(n: int, end_bit: int, device) -> torch.Tensor:
    """``sort_pairs``' scratch for n pairs."""
    nbytes = _library("pool_sort").pool_sort_temp_bytes(n, end_bit)
    if nbytes < 0:
        raise RuntimeError(f"window end sort: no scratch size for {n} pairs, {end_bit} bits")
    return torch.empty(max(nbytes, 1), dtype=torch.uint8, device=device)


class WindowEnd:
    """One frame's window ends on the device, over a pool of ``lanes``
    lanes (ids 0 .. lanes - 1 handed out at the start) and ``total`` work
    items of a ``width`` x ``height`` frame at ``spp`` samples a pixel,
    pixel ids ``wid % npix``.  ``cam`` the frame's camera and ``key`` its
    (2,) int64 key, both on ``device``.  Call it once a window end; read
    ``previous()`` after the next call."""

    def __init__(self, lanes: int, *, width: int, height: int, spp: int, cam, key,
                 device):
        dev = torch.device(device)
        i32 = torch.int32
        self.lanes, self.width, self.height, self.spp = lanes, width, height, spp
        self.npix = width * height
        self.total = self.npix * spp
        self.end_bit = max(1, self.npix.bit_length())  # the sentinel npix sorts last
        lib = _library("window_end")
        self.ctl = torch.zeros(CTL_WORDS, dtype=i32, device=dev)
        self.ctl[CTL_HANDED] = lanes  # a fill on the device: no sync
        self.row_fin = torch.empty(lib.window_end_rows(lanes), dtype=i32, device=dev)
        self.hist_count = torch.zeros(HIST_BINS, dtype=i32, device=dev)
        self.sort_keys = torch.empty((2, lanes), dtype=i32, device=dev)
        self.sort_vals = torch.empty((2, lanes), dtype=i32, device=dev)
        self.scratch = sort_scratch(lanes, self.end_bit, dev)
        self.base = key.to(device=dev, dtype=torch.int64).contiguous()
        self.cam = camera_params(cam).to(dev).contiguous()
        # the device block's readings, two windows' slots on the host
        self._host = torch.empty((2, CTL_WORDS), dtype=i32, pin_memory=dev.type == "cuda")
        self._events = ([torch.cuda.Event(), torch.cuda.Event()] if dev.type == "cuda"
                        else None)
        self.windows = 0

    def __call__(self, pool, acc, hist) -> None:
        """Queue mode's window end on the pool (``wavefront._Pool``: its
        rows written in place), the (npix, 3) image sums ``acc`` and the
        f32 length histogram ``hist`` (added to), then the device block's
        copy to the host."""
        global launches
        lib = _library("window_end")
        dev = acc.device
        n = self.lanes
        state = pool.state
        f32, i32 = torch.float32, torch.int32
        for x, shape, dtype, what in (
                (state, (13, n), f32, "state"), (pool.keys, (2, n), i32, "key words"),
                (pool.depth, (n,), i32, "depth"), (pool.work, (n,), i32, "work"),
                (pool.pixel, (n,), torch.int64, "pixel"), (acc, (self.npix, 3), f32, "acc"),
                (hist, (HIST_BINS,), f32, "hist")):
            if (tuple(x.shape) != shape or x.dtype != dtype or x.device != dev
                    or not x.is_contiguous()):
                raise ValueError(f"window end: {what} must be a contiguous {shape} {dtype} "
                                 f"on {dev}, got {tuple(x.shape)} {x.dtype} on {x.device}")
        s = _stream(dev)
        current = (dev.type != "cuda" or dev.index is None
                   or dev.index == torch.cuda.current_device())
        with contextlib.nullcontext() if current else torch.cuda.device(dev):
            _check(lib, lib.window_end_finish_launch(
                state[12].data_ptr(), pool.work.data_ptr(), pool.pixel.data_ptr(),
                pool.depth.data_ptr(), n, self.npix, self.total, self.sort_keys[0].data_ptr(),
                self.sort_vals[0].data_ptr(), self.row_fin.data_ptr(),
                self.hist_count.data_ptr(), hist.data_ptr(), self.ctl.data_ptr(), s), "finish")
            sel = sort_pairs(self.sort_keys, self.sort_vals, self.end_bit, self.scratch)
            _check(lib, lib.window_end_add_launch(
                self.sort_keys[sel].data_ptr(), self.sort_vals[sel].data_ptr(),
                state[9].data_ptr(), n, self.npix, acc.data_ptr(), s), "add")
            _check(lib, lib.window_end_respawn_launch(
                state.data_ptr(), pool.keys.data_ptr(), pool.depth.data_ptr(),
                pool.work.data_ptr(), pool.pixel.data_ptr(), n, self.row_fin.data_ptr(),
                self.ctl.data_ptr(), self.base.data_ptr(), self.cam.data_ptr(), self.width,
                self.height, self.spp, s), "respawn")
            launches += 3
            slot = self.windows % 2
            self._host[slot].copy_(self.ctl, non_blocking=True)
            if self._events is not None:
                self._events[slot].record()
        self.windows += 1

    def previous(self):
        """(n_take, live) of the window end before the last call, once the
        copy of its device block has landed: the lanes that took work and
        the lanes alive after its respawn."""
        if self.windows < 2:
            raise RuntimeError("window end: no earlier window to read")
        slot = (self.windows - 2) % 2
        if self._events is not None:
            self._events[slot].synchronize()
        words = self._host[slot].tolist()
        return words[CTL_N_TAKE], words[CTL_LIVE]
