"""Plain-loop oracles for the kernels on the serving path: the PyTorch
counterparts of the reference package's ``kernels/ref.py`` NMS and
association oracles.  Slow and obvious on purpose; the tests hold the
batched plain versions and the CUDA kernels against them."""
from __future__ import annotations

import torch


def iou_matrix_ref(a, b):
    """a:(N,4) b:(M,4) xyxy -> (N,M) IoU in f32."""
    a = a.float()
    b = b.float()
    tl = torch.maximum(a[:, None, :2], b[None, :, :2])
    br = torch.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = torch.prod(torch.clamp(br - tl, min=0.0), -1)
    area_a = torch.prod(a[:, 2:] - a[:, :2], -1)
    area_b = torch.prod(b[:, 2:] - b[:, :2], -1)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


def nms_ref(boxes, scores, iou_thr: float = 0.5, max_out: int = 64):
    """Greedy NMS oracle. Returns (keep_idx (max_out,), valid mask)."""
    n = boxes.shape[0]
    iou = iou_matrix_ref(boxes, boxes)
    order = torch.argsort(-scores, stable=True)
    keep = torch.zeros((max_out,), dtype=torch.int32)
    alive = torch.ones((n,), dtype=torch.bool)
    kcount = 0
    for i in range(n):
        idx = int(order[i])
        if not bool(alive[idx]):
            continue
        if kcount < max_out:
            keep[kcount] = idx
        kcount += 1
        alive &= ~(iou[idx] >= iou_thr)
    valid = torch.arange(max_out) < kcount
    return keep, valid


def batched_nms_ref(boxes, scores, iou_thr: float = 0.5,
                    max_out: int = 64, score_thr: float | None = None):
    """Batched greedy-NMS oracle: ``nms_ref`` per frame, with the
    detector's score-threshold semantics (scores below ``score_thr``
    are zeroed but still iterated).  boxes (B, A, 4), scores (B, A)."""
    if score_thr is not None:
        scores = torch.where(scores >= score_thr, scores,
                             torch.zeros_like(scores))
    outs = [nms_ref(b, s, iou_thr, max_out) for b, s in zip(boxes, scores)]
    return (torch.stack([k for k, _ in outs]),
            torch.stack([v for _, v in outs]))


def greedy_assign_ref(t_boxes, d_boxes, t_mask, d_mask, t_cls=None,
                      d_cls=None, iou_thr: float = 0.3):
    """Greedy IoU-association oracle for the tracker.

    t_boxes (B, T, 4) xyxy predicted track boxes, d_boxes (B, D, 4)
    detections, boolean slot masks, optional int class ids (class
    mismatch forbids a pair) -> match (B, T) int32: detection index per
    track slot or -1.  Per step the globally best remaining pair is
    committed (row-major tie break) and its row+column retired, until
    the best pair falls below ``iou_thr``.
    """
    B, T = t_boxes.shape[0], t_boxes.shape[1]
    D = d_boxes.shape[1]
    match = torch.full((B, T), -1, dtype=torch.int32)
    for b in range(B):
        ok = t_mask[b].bool()[:, None] & d_mask[b].bool()[None, :]
        if t_cls is not None:
            ok &= t_cls[b][:, None] == d_cls[b][None, :]
        cost = torch.where(ok, iou_matrix_ref(t_boxes[b], d_boxes[b]),
                           torch.tensor(-1.0))
        for _ in range(min(T, D)):
            flat = int(torch.argmax(cost))
            i, j = divmod(flat, D)
            if cost[i, j] < iou_thr:
                break
            match[b, i] = j
            cost[i, :] = -1.0
            cost[:, j] = -1.0
    return match
