"""Plain oracles for the port's kernels: the PyTorch counterparts of the
reference package's ``kernels/ref.py`` attention, IoU, NMS, association
and RWKV-scan oracles, and copies of its numpy ROI crop / uncrop oracles
(float32 index math, returning tensors).  Slow and obvious on purpose;
the tests hold the plain versions and the CUDA kernels against them."""
from __future__ import annotations

import numpy as np
import torch


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        scale: float | None = None):
    """q:(B,H,T,D) k/v:(B,H,S,D) -> (B,H,T,D)  (full softmax attention).

    As in the reference, p is cast to q's dtype before PV, and a causal
    query that sees no key (S < T) gets the mean of v."""
    B, H, T, D = q.shape
    S = k.shape[2]
    scale = D ** -0.5 if scale is None else scale
    s = torch.einsum("bhtd,bhsd->bhts", q, k).float() * scale
    if causal:
        mask = (torch.arange(S, device=q.device)[None, :] <=
                torch.arange(T, device=q.device)[:, None] + (S - T))
        s = torch.where(mask[None, None], s, -1e30)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhts,bhsd->bhtd", p.to(q.dtype), v)


def decode_attention_ref(q, k, v, *, scale: float | None = None):
    """GQA flash-decode oracle.
    q:(B,H,D) one token; k/v:(B,S,KV,D) full cache -> (B,H,D)."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, D)
    scale = D ** -0.5 if scale is None else scale
    s = torch.einsum("bkgd,bskd->bkgs", qg, k).float() * scale
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p.to(q.dtype), v)
    return out.reshape(B, H, D)


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


def crop_resize_ref(images, rois, *, out_size: int):
    """Nearest-neighbour ROI crop oracle (numpy loops, float32 index
    math: the bit-compatibility reference for ``kernels.roi``).

    images (B, H, W, ch), rois (B, R, 4) normalized xyxy ->
    crops (B, R, C, C, ch) float32 tensor, C = out_size."""
    images = np.asarray(images)
    rois = np.asarray(rois, np.float32)
    B, H, W, ch = images.shape
    R = rois.shape[1]
    C = out_size
    f = (np.arange(C, dtype=np.float32) + np.float32(0.5)) / np.float32(C)
    out = np.zeros((B, R, C, C, ch), np.float32)
    for b in range(B):
        for r in range(R):
            x0, y0, x1, y1 = rois[b, r]
            ys = np.clip(np.floor((y0 + f * (y1 - y0)) * np.float32(H)),
                         0, H - 1).astype(np.int64)
            xs = np.clip(np.floor((x0 + f * (x1 - x0)) * np.float32(W)),
                         0, W - 1).astype(np.int64)
            out[b, r] = images[b].astype(np.float32)[ys][:, xs]
    return torch.from_numpy(out)


def uncrop_boxes_ref(boxes, rois, *, bounds, crop_size: int):
    """Crop-space -> parent-frame box mapping oracle for ``kernels.roi``.

    boxes (..., 4) xyxy in [0, crop_size] pixels, rois (..., 4)
    normalized parent windows (broadcast), bounds = (W, H) -> float32
    tensor of the boxes' shape."""
    W, H = np.float32(bounds[0]), np.float32(bounds[1])
    b = np.asarray(boxes, np.float32)
    r = np.broadcast_to(np.asarray(rois, np.float32), b.shape)
    C = np.float32(crop_size)
    out = np.stack([
        (r[..., 0] + b[..., 0] / C * (r[..., 2] - r[..., 0])) * W,
        (r[..., 1] + b[..., 1] / C * (r[..., 3] - r[..., 1])) * H,
        (r[..., 0] + b[..., 2] / C * (r[..., 2] - r[..., 0])) * W,
        (r[..., 1] + b[..., 3] / C * (r[..., 3] - r[..., 1])) * H,
    ], axis=-1)
    return torch.from_numpy(np.ascontiguousarray(out))


def rwkv_scan_ref(r, k, v, w, u, s0):
    """Stepwise oracle for the RWKV-6 recurrence kernel.
    r/k/v/w: (B,H,T,hs); u: (H,hs); s0: (B,H,hs,hs).  kv is formed in
    the inputs' dtype and promoted against the float32 state, as in the
    reference."""
    S = s0.float()
    outs = []
    for t in range(r.shape[2]):
        r_t, k_t, v_t, w_t = (x[:, :, t] for x in (r, k, v, w))
        kv = k_t[..., :, None] * v_t[..., None, :]
        inner = S + u[None, :, :, None] * kv
        outs.append(torch.einsum("bhk,bhkv->bhv", r_t.to(inner.dtype),
                                 inner))
        S = w_t[..., :, None] * S + kv
    return torch.stack(outs, 2).to(r.dtype), S
