"""The camera lanes' draws for every lane: the lanes kernel.

No Pallas counterpart: in the JAX package XLA fuses the camera lanes of
a chunk into one pass (``render._make_lanes``) and the regen
wavefront's refills the same way (``spawn``).  This module wraps a CUDA
kernel (``csrc/lanes.cu``, on ``csrc/threefry.cuh``) that makes, for
each (pixel, sample) lane, its threefry key, its jittered viewport
coordinates and its lens-disk point in one launch, and holds its plain
twin, ``camera_lane_draws_plain`` (the ``sampling`` module's lane keys,
jitter and disk draws in tensor ops).

``render.camera_lanes`` draws here for every chunk and every regen
spawn; the camera's affine part stays in PyTorch
(``camera.camera_rays_from_disk``), so the camera parameters' gradients
flow through autograd.  ``camera_lane_draws`` dispatches on where its
tensors lie: CUDA tensors launch the kernel (and count in
``launches``); CPU tensors run the plain version.
"""

from __future__ import annotations

import contextlib

import torch

from rust_pathtracer_tpu_torch import sampling
from rust_pathtracer_tpu_torch.ops.fused_bounce import key_words

# kernel launches (CUDA tensors only)
launches = 0

_M32 = 0xFFFFFFFF
N_ROWS = 6  # the key's two words, s_vp, t_vp, disk_x, disk_y

_entry = None


def _split(buf):
    """(6, R) int32 rows -> (key words (2, R) int32, s_vp (R,), t_vp (R,),
    disk_xy (R, 2)), views of the rows."""
    f = buf[2:].view(torch.float32)
    return buf[0:2], f[0], f[1], f[2:4].T


def camera_lane_draws_plain(base_key, pixel, sample, *, width, height, spp_total):
    """``camera_lane_draws`` in plain tensor ops (the sampling module's
    threefry in int64).  Runs on any device."""
    dev = pixel.device
    lkeys = sampling.lane_keys(base_key.to(dev),
                               (pixel * spp_total + sample) & _M32)
    jit_u = sampling.uniform2(sampling.bounce_keys(lkeys, 0, sampling.P_PIXEL_JITTER))
    col = (pixel % width).to(torch.float32)
    y = (height - 1 - pixel // width).to(torch.float32)  # renderer.rs:16: reversed rows

    def f32(v):  # divide by a tensor: true division on every device
        return torch.tensor(v, dtype=torch.float32, device=dev)

    s_vp = (col + jit_u[:, 0]) / f32(width - 1.0)   # renderer.rs:23
    t_vp = (y + jit_u[:, 1]) / f32(height - 1.0)    # renderer.rs:24
    disk = sampling.in_unit_disk_xy(sampling.bounce_keys(lkeys, 0, sampling.P_LENS))
    return key_words(lkeys), s_vp, t_vp, disk[:, :2]


def camera_lane_draws(base_key, pixel, sample, *, width, height, spp_total):
    """The camera lanes of R (pixel, sample) items: ``(key words (2, R)
    int32, s_vp (R,), t_vp (R,), disk_xy (R, 2))``.

    ``base_key`` the frame's (2,) threefry key (``sampling.prng_key``);
    ``pixel`` and ``sample`` (R,) int64, pixel ids >= 0.  A lane's key is
    ``fold_in(base_key, (pixel * spp_total + sample) mod 2**32)``, its
    words as ``fused_bounce.key_words`` lays them out; s_vp and t_vp its
    jittered viewport coordinates (rows counted from the bottom), and
    disk_xy its point in the unit lens disk.  CUDA tensors launch the
    kernel, whose results are views of one (6, R) buffer; CPU tensors
    run ``camera_lane_draws_plain``."""
    dev = pixel.device
    R = pixel.shape[0]
    if (pixel.dim() != 1 or sample.shape != (R,) or pixel.dtype != torch.int64
            or sample.dtype != torch.int64 or sample.device != dev):
        raise ValueError(f"camera_lane_draws: pixel and sample must be ({R},) int64 on "
                         f"{dev}, got {tuple(sample.shape)} {pixel.dtype} / {sample.dtype} "
                         f"on {sample.device}")
    if base_key.shape != (2,):
        raise ValueError(f"camera_lane_draws: base_key must be a (2,) key, got "
                         f"{tuple(base_key.shape)}")
    if min(int(width), int(height), int(spp_total)) < 1:
        raise ValueError(f"camera_lane_draws: width {width}, height {height} and "
                         f"spp_total {spp_total} must be positive")
    if dev.type == "cpu":
        return camera_lane_draws_plain(base_key, pixel, sample, width=width,
                                       height=height, spp_total=spp_total)
    if dev.type != "cuda":
        raise ValueError(f"camera_lane_draws: no kernel for device {dev}")
    return _split(_launch(base_key, pixel, sample, int(width), int(height), int(spp_total)))


def _launch(base_key, pixel, sample, width, height, spp_total):
    """One launch on CUDA tensors; returns the (6, R) int32 rows."""
    global launches, _entry
    from rust_pathtracer_tpu_torch.ops._build import load_library

    R = pixel.shape[0]
    out = torch.empty((N_ROWS, R), dtype=torch.int32, device=pixel.device)
    if R == 0:
        return out
    if _entry is None:
        _entry = load_library("lanes").camera_lanes_launch
    base = base_key.to(device=pixel.device, dtype=torch.int64).contiguous()
    pixel, sample = pixel.contiguous(), sample.contiguous()
    current = pixel.device.index is None or pixel.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(pixel.device):
        err = _entry(base.data_ptr(), pixel.data_ptr(), sample.data_ptr(), width, height,
                     spp_total, out.data_ptr(), R, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("camera_lanes kernel launch failed: "
                           f"{load_library('lanes').error_string(err).decode()}")
    launches += 1
    return out
