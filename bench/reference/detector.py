"""Plain reference of the served detector: the mini-SSD forward pass, its
box decode and greedy NMS, written from the model's description in plain
PyTorch (forward) and numpy (NMS), with no kernel, batching rule or code
of the program.  Also the judge that holds the program's detections to
it.

The forward pass computes in float32 with IEEE products.  ``tf32=True``
rounds every convolution operand to TF32 (10 explicit mantissa bits,
round to nearest even) and accumulates in float32, which is what a TF32
convolution does: the control of the detection cells.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``t`` (float32) rounded to TF32's 10 mantissa bits, nearest even."""
    bits = t.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


def _same_pad(size: int, k: int, stride: int):
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, b, stride, tf32):
    k = w.shape[-1]
    top, bottom = _same_pad(x.shape[2], k, stride)
    left, right = _same_pad(x.shape[3], k, stride)
    x = F.pad(x, (left, right, top, bottom))
    if tf32:
        x, w = tf32_round(x), tf32_round(w)
    return F.conv2d(x, w, b, stride=stride)


def anchors(cfg) -> np.ndarray:
    """(A, 4) xyxy in [0, 1]: for each feature map, aspect ratios 1 and
    2, each over the map's cells in row-major order."""
    out = []
    for stride, scale in zip(cfg["feature_strides"], cfg["anchor_scales"]):
        g = cfg["image_size"] // stride
        cs = (np.arange(g) + 0.5) / g
        cx, cy = np.meshgrid(cs, cs)
        for ar in (1.0, 2.0):
            w, h = scale * np.sqrt(ar), scale / np.sqrt(ar)
            out.append(np.stack([cx - w / 2, cy - h / 2, cx + w / 2,
                                 cy + h / 2], -1).reshape(-1, 4))
    return np.concatenate(out, 0).astype(np.float32)


def forward(params, cfg, images: torch.Tensor, tf32: bool = False):
    """images (N, S, S, 3) float32 -> (deltas (N, A, 4), objectness
    logits (N, A), class logits (N, A, C)).  Stride-2 3x3 conv blocks
    with ReLU; the heads are 3x3 convs on the last two maps, their
    outputs read channels last, (y, x, anchor kind) order."""
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        x = images.permute(0, 3, 1, 2)
        feats = []
        for blk in params["backbone"]:
            x = F.relu(_conv(x, blk["w"], blk["b"], 2, tf32))
            feats.append(x)
        outs = []
        n_out = 5 + cfg["n_classes"]
        for f, head in ((feats[-2], params["head8"]),
                        (feats[-1], params["head16"])):
            y = _conv(f, head["w"], head["b"], 1, tf32).permute(0, 2, 3, 1)
            outs.append(y.reshape(y.shape[0], -1, n_out))
        y = torch.cat(outs, 1)
    return y[..., :4], y[..., 4], y[..., 5:]


def candidates(params, cfg, images, anc: torch.Tensor, tf32=False):
    """Decoded per-anchor candidates: boxes (N, A, 4) xyxy, objectness
    scores (N, A), class logits (N, A, C)."""
    deltas, obj, cls_logits = forward(params, cfg, images, tf32)
    wh_a = anc[:, 2:] - anc[:, :2]
    c_a = (anc[:, :2] + anc[:, 2:]) / 2
    c = c_a + deltas[..., :2] * wh_a
    wh = wh_a * torch.exp(torch.clamp(deltas[..., 2:], -4, 4))
    boxes = torch.cat([c - wh / 2, c + wh / 2], -1)
    return boxes, torch.sigmoid(obj), cls_logits


def iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of xyxy boxes a (..., N, 4) and b (..., M, 4) in
    float32: intersection over the union floored at 1e-9."""
    a = a.astype(np.float32)[..., :, None, :]
    b = b.astype(np.float32)[..., None, :, :]
    iw = np.clip(np.minimum(a[..., 2], b[..., 2]) -
                 np.maximum(a[..., 0], b[..., 0]), 0, None)
    ih = np.clip(np.minimum(a[..., 3], b[..., 3]) -
                 np.maximum(a[..., 1], b[..., 1]), 0, None)
    inter = iw * ih
    aa = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    ab = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = np.maximum(aa + ab - inter, np.float32(1e-9))
    return (inter / union).astype(np.float32)


def nms(boxes, scores, classes, score_thr, iou_thr, max_out):
    """Greedy NMS of one frame: candidates at or above ``score_thr`` in
    descending score order (ties: lower index first); a kept box removes
    every later one whose IoU with it is ``iou_thr`` or more; at most
    ``max_out`` kept.  Returns (boxes, scores, classes, valid) rows of
    width ``max_out``."""
    s = np.where(scores >= np.float32(score_thr), scores, 0).astype(
        np.float32)
    order = np.argsort(-s, kind="stable")
    ov = iou(boxes, boxes)
    alive = s > 0
    keep = []
    for i in order:
        if len(keep) == max_out or not s[i] > 0:
            break
        if not alive[i]:
            continue
        keep.append(i)
        alive &= ~(ov[i] >= np.float32(iou_thr))
    out_b = np.zeros((max_out, 4), np.float32)
    out_s = np.zeros(max_out, np.float32)
    out_c = np.zeros(max_out, np.int32)
    valid = np.zeros(max_out, bool)
    n = len(keep)
    out_b[:n], out_s[:n], out_c[:n] = boxes[keep], s[keep], classes[keep]
    valid[:n] = True
    return out_b, out_s, out_c, valid


def judge_frame(rows, ref, score_thr, iou_thr, max_out):
    """Hold one frame's served detections to the reference's candidates.

    ``rows`` = the program's (boxes (D, 4), scores (D,), classes (D,),
    valid (D,)); ``ref`` = the reference's (boxes (A, 4), scores (A,),
    class logits (A, C)).  Each valid row is matched to the candidate
    nearest its box.  Returns ``(err, gap)``:

    * ``err``: the largest distance of a row's box (max norm) or score
      from its candidate's;
    * ``gap``: the widest decision margin the rows overstep, each in its
      own units: a class whose logit lies below the candidate's best;
      a kept row suppressed by an earlier one (IoU over ``iou_thr``) or
      under ``score_thr``; a row kept while a higher-scored candidate,
      not suppressed by the rows before it, was passed over (the lesser
      of its score lead and its IoU room under ``iou_thr``); fewer than
      ``max_out`` rows while such a candidate is left.  Near ties give
      gaps near zero whichever way the program broke them; a wrong row
      gives a gap of the decision's own size.
    """
    bx, sc, cl, va = (np.asarray(a) for a in rows)
    rb, rs, rl = (np.asarray(a, np.float64) for a in ref)
    ov = iou(ref[0], ref[0]).astype(np.float64)
    thr = score_thr
    live = rs >= thr
    picked = np.zeros(len(rs), bool)
    sup = np.full(len(rs), -np.inf)          # max IoU with rows so far
    err = gap = 0.0
    rows_v = np.flatnonzero(va)
    n = len(rows_v)
    if n:
        dist = np.abs(rb[None] - bx[rows_v][:, None].astype(np.float64)
                      ).max(-1)                              # (n, A)
        js = dist.argmin(-1)
        err = max(float(dist[np.arange(n), js].max()),
                  float(np.abs(sc[rows_v] - rs[js]).max()))
        gap = float((rl[js].max(-1) - rl[js, cl[rows_v]]).max())
    for j in js if n else ():
        if picked[j]:
            gap = max(gap, 1.0)
        gap = max(gap, thr - rs[j], sup[j] - iou_thr)
        cand = live & ~picked & (sup < iou_thr) & (rs > rs[j])
        cand[j] = False
        if cand.any():
            lead = np.minimum(rs[cand] - rs[j], iou_thr - sup[cand])
            gap = max(gap, float(lead.max()))
        picked[j] = True
        sup = np.maximum(sup, ov[j])
    if n < max_out:
        cand = live & ~picked & (sup < iou_thr)
        if cand.any():
            left = np.minimum(rs[cand] - thr, iou_thr - sup[cand])
            gap = max(gap, float(left.max()))
    return err, gap
