"""Association stage of the tracker: box-format plumbing around the
fused cost-matrix + greedy-assignment kernel (``kernels.ops``).

The tracker state carries boxes as (cx, cy, w, h); detections arrive as
xyxy.  This module owns the conversions and the call into
``ops.greedy_assign`` (the CUDA kernel for tensors on the card).
"""
from __future__ import annotations

import torch

from ..kernels import ops


def cxcywh_to_xyxy(pos):
    """(..., 4) center boxes -> xyxy, with w/h floored at 1 so long
    coasts can never emit an inverted box."""
    wh = torch.clamp(pos[..., 2:], min=1.0)
    c = pos[..., :2]
    return torch.cat([c - wh / 2.0, c + wh / 2.0], -1)


def xyxy_to_cxcywh(boxes):
    return torch.cat([(boxes[..., :2] + boxes[..., 2:]) / 2.0,
                      boxes[..., 2:] - boxes[..., :2]], -1)


def associate(pos, active, cls, det_boxes, det_valid, det_cls,
              iou_thr: float):
    """Match predicted track boxes to detections.

    pos (B, T, 4) cxcywh, active (B, T) bool, det_boxes (B, D, 4) xyxy
    -> match (B, T) int32 (detection index per track slot or -1).
    Class-gated: a track never matches a detection of another class.
    """
    return ops.greedy_assign(
        cxcywh_to_xyxy(pos), det_boxes.float(), t_mask=active,
        d_mask=det_valid, t_cls=cls, d_cls=det_cls, iou_thr=iou_thr)
