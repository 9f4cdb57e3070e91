"""Batched track <-> detection association: IoU cost matrix + greedy
assignment.  The plain PyTorch version and the wrapper of the
hand-written CUDA kernel (``csrc/association.cu``).

Both compute what the reference package's ``kernels/association.py``
computes (``greedy_assign_pallas`` and its XLA twin
``greedy_assign_xla``), per frame of the batch: the (T, D) IoU of track
boxes against detection boxes, set to -1 where a track slot or a
detection is masked out or the classes differ; then at most
``min(T, D)`` greedy steps, each committing the global maximum (first
in row-major order among equal values) and retiring its row and column,
until the best remaining pair falls below ``iou_thr``.
``LAUNCHES`` counts the CUDA kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .nms import _pair_iou

LAUNCHES = 0     # kernel launches made by greedy_assign_cuda


def greedy_assign_torch(t_boxes, d_boxes, t_mask, d_mask, t_cls, d_cls,
                        *, iou_thr=0.3):
    """Plain PyTorch version (a port of the XLA twin, batched over
    frames with a per-frame active gate).  t_boxes (B, T, 4) xyxy,
    d_boxes (B, D, 4) xyxy, bool masks, int class ids -> match (B, T)
    int32: the detection index committed to each track slot, or -1."""
    B, T, _ = t_boxes.shape
    D = d_boxes.shape[1]
    dev = t_boxes.device
    iou = _pair_iou(t_boxes.float(), d_boxes.float())          # (B, T, D)
    ok = (t_mask[:, :, None] & d_mask[:, None, :] &
          (t_cls[:, :, None] == d_cls[:, None, :]))
    cost = torch.where(ok, iou, torch.full_like(iou, -1.0))
    match = torch.full((B, T), -1, dtype=torch.int32, device=dev)
    for _ in range(min(T, D)):
        flat = torch.argmax(cost.reshape(B, T * D), -1)
        best = torch.gather(cost.reshape(B, T * D), 1, flat[:, None])[:, 0]
        act = best >= iou_thr
        if not bool(act.any()):
            break
        f = torch.nonzero(act)[:, 0]
        i, j = flat[f] // D, flat[f] % D
        match[f, i] = j.to(torch.int32)
        cost[f, i, :] = -1.0
        cost[f, :, j] = -1.0
    return match


_LAUNCH_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
    ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p]


def greedy_assign_cuda(t_boxes, d_boxes, t_mask, d_mask, t_cls, d_cls,
                       *, iou_thr=0.3):
    """The CUDA kernel's wrapper: same arguments and result as
    ``greedy_assign_torch``, for tensors on one CUDA device.  Raises on
    any other device, on a missing kernel library and on a failed
    launch (a (T, D) cost matrix larger than one CTA's shared memory
    fails there)."""
    global LAUNCHES
    launch = build.function("association", "greedy_assign_launch",
                            _LAUNCH_ARGS)
    dev = t_boxes.device
    args = (t_boxes, d_boxes, t_mask, d_mask, t_cls, d_cls)
    if dev.type != "cuda" or any(a.device != dev for a in args):
        raise ValueError("greedy_assign_cuda takes CUDA tensors on one "
                         f"device, got {[str(a.device) for a in args]}")
    B, T, _ = t_boxes.shape
    D = d_boxes.shape[1]
    if (t_boxes.shape != (B, T, 4) or d_boxes.shape != (B, D, 4)
            or t_mask.shape != (B, T) or t_cls.shape != (B, T)
            or d_mask.shape != (B, D) or d_cls.shape != (B, D)):
        raise ValueError("greedy_assign_cuda: inconsistent shapes "
                         f"{[tuple(a.shape) for a in args]}")
    tb = t_boxes.float().contiguous()
    db = d_boxes.float().contiguous()
    tm = t_mask.bool().contiguous()
    dm = d_mask.bool().contiguous()
    tc = t_cls.to(torch.int32).contiguous()
    dc = d_cls.to(torch.int32).contiguous()
    match = torch.empty((B, T), dtype=torch.int32, device=dev)
    if B and T and D:
        err = launch(tb.data_ptr(), db.data_ptr(), tm.data_ptr(),
                     dm.data_ptr(), tc.data_ptr(), dc.data_ptr(), B, T, D,
                     float(iou_thr), match.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "greedy_assign_launch")
        LAUNCHES += 1
    else:
        match.fill_(-1)
    return match
