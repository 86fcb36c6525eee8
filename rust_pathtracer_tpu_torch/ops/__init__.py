"""Kernels of the port and their plain PyTorch twins.

``fused_bounce`` wraps K1 (``csrc/fused_bounce.cu``), ``fused_bounce_bwd``
K2, ``closest_hit`` K3 and K4 (``csrc/closest_hit.cu``), and
``projected``, ``resident`` and ``worklist`` K5, K6 and K7
(``csrc/projected.cu``) with the big-scene tables and worklist,
``draws`` the draw kernel (``csrc/draws.cu``), ``lanes`` the camera
lanes' kernel (``csrc/lanes.cu``) and ``passset`` the pass-set key
kernel of the between-bounce reorder (``csrc/passset.cu``) and ``shade``
the big-scene forward bounce after the search (``csrc/shade.cu``);
``intersect`` builds hit records in plain tensor ops, ``compressed_vjp``
stores the residuals of remat "bf16"; ``_build`` builds the CUDA
sources at first use.  Neither imports a GPU toolchain when
imported.
"""
