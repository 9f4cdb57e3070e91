"""Kernels on the serving path, each in three tiers: a plain-loop oracle
(``ref``), a plain PyTorch version (the CPU path) and a hand-written
CUDA kernel for Hopper (``csrc/``, built by ``build``), dispatched by
tensor device in ``ops``."""
from . import ops, ref
from .ops import batched_nms, greedy_assign, launches, reset_launches

__all__ = ["batched_nms", "greedy_assign", "launches", "ops", "ref",
           "reset_launches"]
