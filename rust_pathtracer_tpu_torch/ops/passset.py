"""The pass-set keys of the between-bounce reorder: the pass-set key kernel.

No Pallas counterpart: in the JAX package XLA computes the keys in
``ops/projected.py:793`` (``passset_sort_keys``).  This module wraps a
CUDA kernel (``csrc/passset.cu``) that computes the same words, one lane
a thread, where the plain version (``projected.passset_sort_keys_plain``)
materialises (R, G) planes of slab bounds.  ``passset_keys`` dispatches
on where its tensors lie: CUDA tensors launch the kernel (and count in
``launches``); CPU tensors run the plain version.  ``projected.passset_perm``
sorts by its words.
"""

from __future__ import annotations

import contextlib

import torch

from rust_pathtracer_tpu_torch.ops.projected import (
    ProjTables,
    passset_sort_keys_plain,
    passset_words,
)

# kernel launches (CUDA tensors only)
launches = 0

_entry = None


def passset_keys(tables: ProjTables, o, d, alive, t_min=1e-3):
    """The pass-set sort keys of R lanes: an int32 (1 + W, R) tensor of
    uint32 bits, the dead flag then the pass-set words
    (``passset_sort_keys_plain`` says what they hold).  ``o``, ``d``
    (R, 3) f32 and ``alive`` (R,) bool on the tables' device.  CUDA
    tensors launch the kernel; CPU tensors run the plain version."""
    dev = tables.device
    R = o.shape[0]
    if o.shape != (R, 3) or d.shape != (R, 3) or alive.shape != (R,):
        raise ValueError(f"passset_keys: rays {tuple(o.shape)}, {tuple(d.shape)} and "
                         f"alive {tuple(alive.shape)}, want (R, 3), (R, 3), (R,)")
    if o.dtype != torch.float32 or d.dtype != torch.float32 or alive.dtype != torch.bool:
        raise TypeError(f"passset_keys: dtypes {o.dtype}, {d.dtype}, {alive.dtype}, "
                        "want float32, float32, bool")
    for x in (o, d, alive):
        if x.device != dev:
            raise ValueError(f"passset_keys: tensors on {x.device} and {dev}")
    if dev.type == "cpu":
        return passset_sort_keys_plain(tables, o, d, alive, t_min)
    if dev.type != "cuda":
        raise ValueError(f"passset_keys: no kernel for device {dev}")
    return _launch(tables, o, d, alive, t_min)


def _launch(tables: ProjTables, o, d, alive, t_min):
    """One launch on CUDA tensors; returns the (1 + W, R) int32 rows."""
    global launches, _entry
    from rust_pathtracer_tpu_torch.ops._build import load_library

    if _entry is None:
        _entry = load_library("passset").passset_keys_launch
    o, d, alive = o.contiguous(), d.contiguous(), alive.contiguous()
    R, G = o.shape[0], tables.num_groups
    out = torch.empty((1 + passset_words(G), R), dtype=torch.int32, device=o.device)
    bounds8 = tables.bounds8
    current = o.device.index is None or o.device.index == torch.cuda.current_device()
    with contextlib.nullcontext() if current else torch.cuda.device(o.device):
        err = _entry(o.data_ptr(), d.data_ptr(), alive.data_ptr(), bounds8.data_ptr(),
                     G, float(t_min), out.data_ptr(), R,
                     torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError("passset_keys kernel launch failed: "
                           f"{load_library('passset').error_string(err).decode()}")
    launches += 1
    return out
