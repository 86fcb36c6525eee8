"""Kernels of the port and their plain PyTorch twins.

``fused_bounce`` wraps K1 (``csrc/fused_bounce.cu``), ``fused_bounce_bwd``
K2, ``closest_hit`` K3 and K4 (``csrc/closest_hit.cu``), and
``projected``, ``resident`` and ``worklist`` K5, K6 and K7
(``csrc/projected.cu``) with the big-scene tables and worklist;
``intersect`` builds hit records in plain tensor ops; ``_build`` builds
the CUDA sources at first use.  Neither imports a GPU toolchain when
imported.
"""
