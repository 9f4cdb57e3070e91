"""PyTorch port of the parallel-detection serving system, with
hand-written CUDA kernels for NVIDIA Hopper.

The layout mirrors the JAX package ``repro`` module for module
(``kernels``, ``detector``, ``tracking``, ``core``, ``obs``,
``serving``) so each function's counterpart is easy to find; nothing
here imports JAX or ``repro``.  Entry points run on ``cuda`` unless the
caller passes ``device="cpu"``; a kernel wrapper launches its CUDA
kernel for a CUDA tensor and takes its plain PyTorch version only for a
CPU tensor.
"""
