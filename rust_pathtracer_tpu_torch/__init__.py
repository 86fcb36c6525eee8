"""rust_pathtracer_tpu_torch — the path tracer on PyTorch and CUDA.

A port of ``rust_pathtracer_tpu`` (JAX on a TPU) to PyTorch, with the
Pallas kernels rewritten by hand for NVIDIA Hopper (sm_90a).  The JAX
package stays the reference: every module here names its counterpart
there, and ``tests/test_torch_*.py`` hold each one against it.

It renders and differentiates the six reference scenes and any scene
the builder makes:

* counter-based threefry RNG, legacy stream, bit-exact (sampling)
* scene tables, image textures and OBJ meshes included, the BVH order
  and the packed kernel tables (scene, bvh, ops.fused_bounce,
  ops.closest_hit, ops.projected)
* camera lanes and the chunked frame loop (camera, render)
* the bounce loops with russian roulette (integrator): the fused route,
  one whole bounce per launch of the CUDA kernel K1
  (ops/csrc/fused_bounce.cu) and, differentiable, K1 with residuals and
  the backward kernel K2 (ops/csrc/fused_bounce_bwd.cu); the generic
  route for image textures, nested checkers and differentiable perlin,
  with the searches K3 and K4 (ops/csrc/closest_hit.cu) and the shading
  in tensor ops (textures, materials, ops.intersect); past 128
  primitives the searches are K5, K6 and K7 over the projected tables
  (ops/csrc/projected.cu), with the payload shading, and the wavefront
  is sorted between bounces by its lanes' cluster pass-sets, keyed by
  the kernel of ops/csrc/passset.cu
* image gradients for inverse rendering (grad), with the residuals
  optionally in bfloat16 (ops.compressed_vjp) and the differentiable
  cascade

Every kernel has a plain PyTorch twin, which CPU tensors run.
Everything takes an explicit ``device``; there is no global device state.
"""

from rust_pathtracer_tpu_torch.version import __version__

__all__ = ["__version__"]
