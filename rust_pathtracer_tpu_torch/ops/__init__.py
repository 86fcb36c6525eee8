"""Kernels of the port and their plain PyTorch twins.

``fused_bounce`` wraps K1 (``csrc/fused_bounce.cu``); ``_build`` builds
the CUDA sources at first use.  Neither imports a GPU toolchain when
imported.
"""
