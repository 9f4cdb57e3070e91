"""Dispatch over the kernels on the serving path, by tensor device only.

A tensor on the CPU takes the kernel's plain PyTorch version; any other
tensor goes to the CUDA kernel's wrapper, which launches the kernel or
raises.  There is no switch that sends CUDA tensors to the plain
version and no fallback on failure.  Each CUDA wrapper counts its own
kernel launches; ``launches()`` reads the counts, so a run can show that
its main path went through the kernels.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import association, nms
from .association import greedy_assign_cuda, greedy_assign_torch
from .nms import batched_nms_cuda, batched_nms_torch


def launches() -> Dict[str, int]:
    """Kernel launches counted by each CUDA wrapper."""
    return {"batched_nms": nms.LAUNCHES,
            "greedy_assign": association.LAUNCHES}


def reset_launches() -> None:
    nms.LAUNCHES = 0
    association.LAUNCHES = 0


def batched_nms(boxes, scores, *, iou_thr=0.5, score_thr=None, max_out=64,
                stop_at_zero=False):
    """Fused batched greedy NMS over a micro-batch of frames.

    boxes (B, A, 4) xyxy, scores (B, A) -> (keep (B, max_out) int32,
    valid (B, max_out) bool); see ``kernels.nms`` for the semantics."""
    kw = dict(iou_thr=iou_thr, score_thr=score_thr, max_out=max_out,
              stop_at_zero=stop_at_zero)
    if boxes.device.type == "cpu":
        return batched_nms_torch(boxes, scores, **kw)
    return batched_nms_cuda(boxes, scores, **kw)


def greedy_assign(t_boxes, d_boxes, *, t_mask=None, d_mask=None,
                  t_cls=None, d_cls=None, iou_thr=0.3):
    """Fused IoU cost-matrix + greedy assignment over a frame batch (the
    tracker's association step).

    t_boxes (B, T, 4) xyxy predicted track boxes, d_boxes (B, D, 4)
    detections -> match (B, T) int32 (detection index per track slot or
    -1).  Masks default to all-true, class ids to all-zero (no class
    gate)."""
    B, T, _ = t_boxes.shape
    D = d_boxes.shape[1]
    dev = t_boxes.device
    if T == 0 or D == 0:
        return torch.full((B, T), -1, dtype=torch.int32, device=dev)
    t_mask = (torch.ones((B, T), dtype=torch.bool, device=dev)
              if t_mask is None else t_mask.bool())
    d_mask = (torch.ones((B, D), dtype=torch.bool, device=dev)
              if d_mask is None else d_mask.bool())
    t_cls = (torch.zeros((B, T), dtype=torch.int32, device=dev)
             if t_cls is None else t_cls.to(torch.int32))
    d_cls = (torch.zeros((B, D), dtype=torch.int32, device=dev)
             if d_cls is None else d_cls.to(torch.int32))
    args = (t_boxes, d_boxes, t_mask, d_mask, t_cls, d_cls)
    if dev.type == "cpu":
        return greedy_assign_torch(*args, iou_thr=iou_thr)
    return greedy_assign_cuda(*args, iou_thr=iou_thr)
