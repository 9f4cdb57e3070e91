"""Dispatch over the port's kernels, by tensor device only.

A tensor on the CPU takes the kernel's plain PyTorch version; any other
tensor goes to the CUDA kernel's wrapper, which launches the kernel or
raises.  There is no switch that sends CUDA tensors to the plain
version and no fallback on failure.  Each CUDA wrapper counts its own
kernel launches; ``launches()`` reads the counts, so a run can show that
its main path went through the kernels.  A CUDA graph's replay calls no
wrapper: its holder adds the launches it captured at every replay
(``add_launches``), so a count is always of kernels that ran.
"""
from __future__ import annotations

from typing import Dict

import torch

from . import association, iou, roi
from . import decode_attention as kdecode
from . import flash_attention as kflash
from . import nms as knms
from . import rwkv_scan as krwkv
from .association import greedy_assign_cuda, greedy_assign_torch
from .decode_attention import decode_attention_cuda, decode_attention_torch
from .flash_attention import flash_attention_cuda, flash_attention_torch
from .iou import iou_matrix_cuda, iou_matrix_torch
from .nms import batched_nms_cuda, batched_nms_torch
from .roi import (crop_resize_cuda, crop_resize_torch, uncrop_boxes_cuda,
                  uncrop_boxes_torch)
from .rwkv_scan import CHUNK_T, rwkv_scan_cuda, rwkv_scan_torch


# each kernel's launch counter: (module, attribute)
_COUNTERS = {"batched_nms": (knms, "LAUNCHES"),
             "greedy_assign": (association, "LAUNCHES"),
             "crop_resize": (roi, "CROP_LAUNCHES"),
             "uncrop_boxes": (roi, "UNCROP_LAUNCHES"),
             "iou_matrix": (iou, "LAUNCHES"),
             "flash_attention": (kflash, "LAUNCHES"),
             "decode_attention": (kdecode, "LAUNCHES"),
             "rwkv_scan": (krwkv, "LAUNCHES")}


def launches() -> Dict[str, int]:
    """Kernel launches counted by each CUDA wrapper."""
    return {k: getattr(m, a) for k, (m, a) in _COUNTERS.items()}


def reset_launches() -> None:
    for m, a in _COUNTERS.values():
        setattr(m, a, 0)


def add_launches(counts: Dict[str, int], times: int = 1) -> None:
    """Add ``times`` x ``counts`` to the wrappers' counters: how a CUDA
    graph's holder counts the launches that a replay runs without
    calling a wrapper (and, with ``times=-1``, takes back the counts its
    wrappers made while the graph was captured, when nothing ran)."""
    for k, n in counts.items():
        m, a = _COUNTERS[k]
        setattr(m, a, getattr(m, a) + times * n)


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


def crop_resize(images, rois, *, out_size):
    """ROI crop + nearest-neighbour resize for the cascade's second
    pass: images (B, H, W, ch), rois (B, R, 4) normalized xyxy -> crops
    (B, R, C, C, ch) float32, C = ``out_size``; see ``kernels.roi``."""
    if images.device.type == "cpu":
        return crop_resize_torch(images, rois, out_size=out_size)
    return crop_resize_cuda(images, rois, out_size=out_size)


def uncrop_boxes(boxes, rois, *, bounds, crop_size):
    """Second-pass boxes from crop pixels back to the parent frame:
    boxes (..., 4) in [0, crop_size], rois (..., 4) normalized windows
    (broadcast), bounds = (W, H); see ``kernels.roi``."""
    kw = dict(bounds=tuple(bounds), crop_size=crop_size)
    if boxes.device.type == "cpu":
        return uncrop_boxes_torch(boxes, rois, **kw)
    return uncrop_boxes_cuda(boxes, rois, **kw)


def iou_matrix(a, b):
    """Pairwise IoU: a (N, 4), b (M, 4) xyxy -> (N, M) float32; see
    ``kernels.iou``."""
    if a.device.type == "cpu":
        return iou_matrix_torch(a, b)
    return iou_matrix_cuda(a, b)


def nms(boxes, scores, iou_thr=0.5, max_out=64):
    """Single-frame greedy NMS through the fused batched kernel (B=1):
    boxes (A, 4), scores (A,) -> (keep (max_out,) int32, valid
    (max_out,) bool), identical to ``ref.nms_ref``."""
    keep, valid = batched_nms(boxes[None], scores[None], iou_thr=iou_thr,
                              max_out=max_out)
    return keep[0], valid[0]


def nms_serial(boxes, scores, iou_thr=0.5, max_out=64):
    """The seed's per-image NMS: the IoU matrix kernel, then an A-step
    greedy suppress loop in tensor ops on the boxes' device (no host
    sync per step).  boxes (A, 4), scores (A,) -> (keep (max_out,)
    int32, valid (max_out,) bool).  Candidates go in stable descending
    score order; survivor s lands in ``keep[s]`` for s < max_out (later
    survivors are dropped but still counted, so ``valid`` is all true
    once there are max_out of them); unused slots hold 0."""
    A = boxes.shape[0]
    dev = boxes.device
    order = torch.argsort(-scores, stable=True)
    # suppression among candidates in score order; row i clears only the
    # later candidates, so alive[i] is final once step i has run
    sup = iou_matrix(boxes, boxes) >= iou_thr
    sup = torch.triu(sup[order][:, order], diagonal=1)
    alive = torch.ones((A,), dtype=torch.bool, device=dev)
    for i in range(A - 1):
        alive[i + 1:] &= ~(sup[i, i + 1:] & alive[i])
    rank = torch.cumsum(alive, 0) - 1
    slot = torch.where(alive & (rank < max_out), rank, max_out)
    keep = torch.zeros((max_out + 1,), dtype=torch.int32, device=dev)
    keep.scatter_(0, slot, order.to(torch.int32))
    valid = torch.arange(max_out, device=dev) < alive.sum()
    return keep[:max_out].contiguous(), valid


def flash_attention(q, k, v, *, causal=True, scale=None):
    """Blocked prefill attention: q (B, H, T, D), k/v (B, H, S, D) ->
    (B, H, T, D) in q's dtype, causal mask aligned to the bottom right;
    T and S multiples of 128.  See ``kernels.flash_attention``."""
    if q.device.type == "cpu":
        return flash_attention_torch(q, k, v, causal=causal, scale=scale)
    return flash_attention_cuda(q, k, v, causal=causal, scale=scale)


def decode_attention(q, k, v, *, scale=None):
    """GQA single-token decode: q (B, H, D) against the whole cache k/v
    (B, S, KV, D) -> (B, H, D) in q's dtype; S a multiple of
    min(512, S).  See ``kernels.decode_attention``."""
    if q.device.type == "cpu":
        return decode_attention_torch(q, k, v, scale=scale)
    return decode_attention_cuda(q, k, v, scale=scale)


def rwkv_scan(r, k, v, w, u, s0, *, chunk_t=CHUNK_T):
    """RWKV-6 recurrence: r/k/v/w (B, H, T, hs), u (H, hs), s0 (B, H, hs,
    hs) -> (out (B, H, T, hs) in r's dtype, s_final float32); T a
    multiple of min(chunk_t, T).  See ``kernels.rwkv_scan``."""
    if r.device.type == "cpu":
        return rwkv_scan_torch(r, k, v, w, u, s0, chunk_t=chunk_t)
    return rwkv_scan_cuda(r, k, v, w, u, s0, chunk_t=chunk_t)
