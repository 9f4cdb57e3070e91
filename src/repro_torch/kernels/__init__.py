"""The port's kernels, each in three tiers: a plain-loop oracle (``ref``),
a plain PyTorch version (the CPU path) and a hand-written CUDA kernel for
Hopper (``csrc/``, built by ``build``), dispatched by tensor device in
``ops``.  ``ops.nms``, ``ops.flash_attention``, ``ops.decode_attention``
and ``ops.rwkv_scan`` are reached through ``ops``: their names are those
of the kernels' modules."""
from . import ops, ref
from .ops import (batched_nms, crop_resize, greedy_assign, iou_matrix,
                  launches, nms_serial, reset_launches, uncrop_boxes)

__all__ = ["batched_nms", "crop_resize", "greedy_assign", "iou_matrix",
           "launches", "nms_serial", "ops", "ref", "reset_launches",
           "uncrop_boxes"]
