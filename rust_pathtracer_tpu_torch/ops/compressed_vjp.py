"""bfloat16 reverse-mode residuals: ``remat="bf16"``.

Counterpart of ``rust_pathtracer_tpu/ops/compressed_vjp.py``.  The
generic differentiable trace with remat "none" keeps every intermediate
of every bounce for the backward (1,125 B a lane-bounce on
TwoSphereCheckers).  Under "bf16" the tensors autograd saves while a
bounce runs (``integrator._bounce_step`` after its detached search) are
stored in bfloat16 and widened back to f32 when the backward reads
them.  The JAX package gets there with a ``custom_vjp`` around the
bounce whose residuals it hoists and casts; PyTorch's idiom is a pair of
``saved_tensors_hooks``:

* pack: an f32 tensor of at least MIN_COMPRESS_ELEMS elements becomes a
  bf16 copy (detached); every other saved tensor (integer, bool, small)
  passes through;
* unpack: a bf16 tensor becomes f32 again.

The accuracy contract is the JAX package's (compressed_vjp.py:22-29):
the forward runs in f32 and only what is saved is rounded, so the loss
is bit for bit the f32-residual one; the gradients come from residuals
with an 8-bit mantissa, within ~1e-2 normalised error of remat "none"'s.
A pack hook hides an in-place change of a saved tensor from autograd's
version check (the copy is what is saved), so the bounce it wraps writes
into no tensor it saves.
"""

from __future__ import annotations

import torch

# saved f32 tensors of at least this many elements are stored in bf16
# (smaller ones are not worth the casts)
MIN_COMPRESS_ELEMS = 1 << 15


def _pack(x: torch.Tensor):
    if x.dtype == torch.float32 and x.numel() >= MIN_COMPRESS_ELEMS:
        return x.detach().to(torch.bfloat16)
    return x


def _unpack(x: torch.Tensor):
    if x.dtype == torch.bfloat16:
        return x.to(torch.float32)
    return x


def compressed_residuals():
    """A context in which the tensors autograd saves are stored as above."""
    return torch.autograd.graph.saved_tensors_hooks(_pack, _unpack)
