"""Kernels of the port and their plain PyTorch twins.

``fused_bounce`` wraps K1 (``csrc/fused_bounce.cu``), ``fused_bounce_bwd``
K2 and ``closest_hit`` K3 and K4 (``csrc/closest_hit.cu``);
``intersect`` builds hit records in plain tensor ops; ``_build`` builds
the CUDA sources at first use.  Neither imports a GPU toolchain when
imported.
"""
