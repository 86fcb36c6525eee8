"""rust_pathtracer_tpu_torch — the path tracer on PyTorch and CUDA.

A port of ``rust_pathtracer_tpu`` (JAX on a TPU) to PyTorch, with the
Pallas kernels rewritten by hand for NVIDIA Hopper (sm_90a).  The JAX
package stays the reference: every module here names its counterpart
there, and ``tests/test_torch_*.py`` hold each one against it.

This slice covers the non-differentiable forward render of the scenes
whose whole bounce fits the fused-bounce kernel (CornellBox,
TriangleTest, TwoSphereCheckers, LightTest):

* counter-based threefry RNG, legacy stream, bit-exact (sampling)
* scene tables and the packed shading table (scene, ops.fused_bounce)
* camera lanes and the chunked frame loop (camera, render)
* the bounce loop with russian roulette (integrator)
* one whole bounce per launch in the CUDA kernel K1
  (ops/csrc/fused_bounce.cu), with a plain PyTorch twin for CPU tensors

Everything takes an explicit ``device``; there is no global device state.
"""

from rust_pathtracer_tpu_torch.version import __version__

__all__ = ["__version__"]
