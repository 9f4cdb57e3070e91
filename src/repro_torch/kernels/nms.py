"""Fused batched greedy NMS: the plain PyTorch version and the wrapper of
the hand-written CUDA kernel (``csrc/nms.cu``).

Both compute what the reference package's ``kernels/nms.py`` computes
(``batched_nms_pallas`` and its XLA twin ``batched_nms_xla``), per frame
of a micro-batch:

1. scores below ``score_thr`` are zeroed (the detector's semantics);
2. candidates are sorted stably by descending thresholded score;
3. greedy suppression runs over the sorted candidates in tiles of
   ``TILE`` = 32.  A frame stops before a tile once it has ``max_out``
   survivors or, with ``stop_at_zero``, when the tile's first score is
   not > 0.  The stops are tile-granular: a tile that is entered is
   processed whole, so zero-score candidates in it can survive;
4. survivor ``s`` (in score order) lands in ``keep[:, s]`` for
   ``s < max_out``; unused slots hold 0; ``valid`` marks the first
   ``min(#survivors, max_out)`` slots.

``batched_nms_torch`` is a port of the XLA twin (tiles unrolled, an
intra-tile suppression fixpoint, a per-frame active gate) and is the
CPU path; it thresholds, sorts with ``torch.argsort(stable=True)`` and
gathers outside the suppression, as the reference wrapper does.
``batched_nms_cuda`` launches one kernel a call, one CTA per frame,
which does steps 1-4 itself from the unsorted boxes and scores (its
rank sort gives ``torch.argsort(-key, stable=True)``'s order, ties,
-0.0 == 0.0 and NaN included); ``LAUNCHES`` counts its launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

TILE = 32
LAUNCHES = 0     # kernel launches made by batched_nms_cuda


def _pair_iou(a, b):
    """a (B, T, 4) vs b (B, M, 4) -> (B, T, M), in the reference's
    operation order."""
    tl = torch.maximum(a[:, :, None, :2], b[:, None, :, :2])
    br = torch.minimum(a[:, :, None, 2:], b[:, None, :, 2:])
    inter = (torch.clamp(br[..., 0] - tl[..., 0], min=0.0) *
             torch.clamp(br[..., 1] - tl[..., 1], min=0.0))
    aa = (a[:, :, 2] - a[:, :, 0]) * (a[:, :, 3] - a[:, :, 1])
    ab = (b[:, :, 2] - b[:, :, 0]) * (b[:, :, 3] - b[:, :, 1])
    return inter / torch.clamp(aa[:, :, None] + ab[:, None, :] - inter,
                               min=1e-9)


def _sorted_candidates(boxes, scores, score_thr):
    """Threshold, stable descending sort and gather: the part of the
    reference wrapper that runs outside its kernel."""
    B, A = scores.shape
    s_key = scores.float()
    if score_thr is not None:
        s_key = torch.where(s_key >= score_thr, s_key,
                            torch.zeros_like(s_key))
    order = torch.argsort(-s_key, dim=-1, stable=True)
    bs = torch.gather(boxes.float(), 1, order[..., None].expand(B, A, 4))
    ss = torch.gather(s_key, 1, order)
    return bs, ss, order


def batched_nms_torch(boxes, scores, *, iou_thr=0.5, score_thr=None,
                      max_out=64, stop_at_zero=False):
    """Plain PyTorch version: boxes (B, A, 4) xyxy, scores (B, A) ->
    keep (B, max_out) int32, valid (B, max_out) bool."""
    B, A = scores.shape
    dev = scores.device
    bs, ss, order = _sorted_candidates(boxes, scores, score_thr)
    tri = (torch.arange(TILE, device=dev)[:, None] <
           torch.arange(TILE, device=dev)[None, :])
    alive = torch.ones((B, A), dtype=torch.bool, device=dev)
    survived = torch.zeros((B, A), dtype=torch.bool, device=dev)
    active = torch.ones((B,), dtype=torch.bool, device=dev)
    found = torch.zeros((B,), dtype=torch.int32, device=dev)
    for c0 in range(0, A, TILE):
        T = min(TILE, A - c0)
        if stop_at_zero:
            active = active & (ss[:, c0] > 0.0)
        gate = active & (found < max_out)
        if not bool(gate.any()):
            break
        pre = alive[:, c0:c0 + T] & gate[:, None]
        sup = _pair_iou(bs[:, c0:c0 + T], bs[:, c0:]) >= iou_thr
        intra = sup[:, :, :T] & tri[:T, :T]
        a_c = pre
        while True:        # greedy inside the tile, as a fixpoint
            new = pre & ~torch.any(intra & a_c[:, :, None], 1)
            if torch.equal(new, a_c):
                break
            a_c = new
        dead = torch.any(sup[:, :, T:] & a_c[:, :, None], 1)
        alive[:, c0 + T:] &= ~dead
        survived[:, c0:c0 + T] = a_c
        found += a_c.sum(-1, dtype=torch.int32)
    count = torch.clamp(found, max=max_out)
    # survivor -> slot (#survivors before it); the rest land in a spill
    # column that is sliced away
    slot = torch.where(survived, torch.cumsum(survived, -1) - 1, max_out)
    slot = torch.clamp(slot, max=max_out)
    keep = torch.zeros((B, max_out + 1), dtype=torch.int32, device=dev)
    keep.scatter_(1, slot, order.to(torch.int32))
    valid = torch.arange(max_out, device=dev)[None, :] < count[:, None]
    return keep[:, :max_out].contiguous(), valid


_LAUNCH_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
                ctypes.c_void_p]


def batched_nms_cuda(boxes, scores, *, iou_thr=0.5, score_thr=None,
                     max_out=64, stop_at_zero=False):
    """The CUDA kernel's wrapper: same arguments and results as
    ``batched_nms_torch``, for tensors on a CUDA device.  Checks its
    inputs, allocates ``keep`` and ``valid`` and launches the kernel,
    which thresholds, sorts and suppresses.  Raises on any other device,
    on a missing kernel library and on a failed launch (a frame of more
    candidates than one CTA's shared memory holds fails there)."""
    global LAUNCHES
    launch = build.function("nms", "batched_nms_launch", _LAUNCH_ARGS)
    dev = build.cuda_device("batched_nms_cuda", boxes, scores)
    B, A = scores.shape
    if boxes.shape != (B, A, 4):
        raise ValueError(f"boxes {tuple(boxes.shape)} do not match "
                         f"scores {tuple(scores.shape)}")
    if A < 1 or max_out < 1:
        raise ValueError(f"need A >= 1 and max_out >= 1, got {A}, "
                         f"{max_out}")
    boxes = build.operand(boxes, torch.float32, align16=True)
    scores = build.operand(scores, torch.float32)
    keep = torch.empty((B, max_out), dtype=torch.int32, device=dev)
    valid = torch.empty((B, max_out), dtype=torch.bool, device=dev)
    if B:
        err = launch(boxes.data_ptr(), scores.data_ptr(), B, A, max_out,
                     int(score_thr is not None),
                     0.0 if score_thr is None else float(score_thr),
                     float(iou_thr), int(bool(stop_at_zero)),
                     keep.data_ptr(), valid.data_ptr(),
                     build.stream(dev))
        build.check(err, "batched_nms_launch")
        LAUNCHES += 1
    return keep, valid
