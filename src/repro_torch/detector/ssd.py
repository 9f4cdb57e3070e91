"""Mini single-shot detector in PyTorch: the port of the reference
package's ``detector/ssd.py`` (inference only; the training loss comes
with a later slice).

Conv backbone (stride-2 blocks) -> two feature maps -> per-anchor box
regression + objectness + class logits; decode + greedy NMS through the
fused batched NMS (``kernels.ops.batched_nms``: the CUDA kernel for
tensors on the card) — the whole micro-batch is suppressed in one
launch.  Input: (B, 64, 64, 3), channels last, as in the reference.

Parameters are a plain dict of tensors shaped like the reference's
pytree, with conv weights in PyTorch's (out, in, kh, kw) layout.  Two
details keep the forward pass equal to the reference's:

* the convolutions pad like XLA's ``"SAME"``: for a stride-2 3x3 conv on
  an even input that is 0 rows before and 1 after, not PyTorch's
  symmetric ``padding=1``, so the padding is explicit;
* the head outputs are permuted to channels last before the reshape to
  (B, g*g*2, 5+C), so rows come out in (y, x, aspect) order beside
  ``make_anchors``' (aspect, y, x) order — the reference pairs the two
  this way, and so does the port.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..device import ieee_float32, resolve_device
from ..kernels import ops as kops


@dataclass(frozen=True)
class SSDConfig:
    image_size: int = 64
    n_classes: int = 3
    channels: Tuple[int, ...] = (16, 32, 64, 64)   # stride-2 conv blocks
    anchor_scales: Tuple[float, ...] = (0.15, 0.35)
    feature_strides: Tuple[int, ...] = (8, 16)     # maps at 8x8 and 4x4


def truncated_normal(generator, shape, stddev, dtype=torch.float32):
    """``stddev`` x a standard normal truncated to [-2, 2] (the
    reference's ``models.layers.truncated_normal``, drawn from a
    ``torch.Generator``)."""
    t = torch.empty(shape, dtype=torch.float32)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (stddev * t).to(dtype)


def _conv_init(generator, k, c_in, c_out):
    return {
        "w": truncated_normal(generator, (c_out, c_in, k, k),
                              1.0 / np.sqrt(k * k * c_in)),
        "b": torch.zeros((c_out,), dtype=torch.float32),
    }


def _same_pad(size: int, k: int, stride: int) -> Tuple[int, int]:
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def _conv(p, x, stride=1):
    """XLA-``"SAME"`` conv of an NCHW tensor."""
    k = p["w"].shape[-1]
    top, bottom = _same_pad(x.shape[2], k, stride)
    left, right = _same_pad(x.shape[3], k, stride)
    x = F.pad(x, (left, right, top, bottom))
    return F.conv2d(x, p["w"], p["b"], stride=stride)


def make_anchors(cfg: SSDConfig) -> np.ndarray:
    """(A_total, 4) xyxy in [0,1] image coords."""
    out = []
    for stride, scale in zip(cfg.feature_strides, cfg.anchor_scales):
        g = cfg.image_size // stride
        cs = (np.arange(g) + 0.5) / g
        cx, cy = np.meshgrid(cs, cs)
        for ar in (1.0, 2.0):
            w = scale * np.sqrt(ar)
            h = scale / np.sqrt(ar)
            out.append(np.stack([cx - w / 2, cy - h / 2,
                                 cx + w / 2, cy + h / 2], -1).reshape(-1, 4))
    return np.concatenate(out, 0).astype(np.float32)


def init_ssd(cfg: SSDConfig, generator: torch.Generator, device=None):
    """Random parameters drawn from ``generator``, on ``device`` (None:
    ``cuda``, raising where no CUDA device exists).  They do not
    reproduce the reference's ``jax.random`` draws; to run the
    reference's weights use ``params_from_numpy``."""
    p = {"backbone": []}
    c_in = 3
    for c in cfg.channels:
        p["backbone"].append(_conv_init(generator, 3, c_in, c))
        c_in = c
    n_anchor_kinds = 2
    out_dim = n_anchor_kinds * (4 + 1 + cfg.n_classes)
    p["head8"] = _conv_init(generator, 3, cfg.channels[-2], out_dim)
    p["head16"] = _conv_init(generator, 3, cfg.channels[-1], out_dim)
    return params_to(p, resolve_device(device))


def params_to(p, device):
    """The same parameter tree with every tensor on ``device``."""
    if isinstance(p, dict):
        return {k: params_to(v, device) for k, v in p.items()}
    if isinstance(p, (list, tuple)):
        return [params_to(v, device) for v in p]
    return p.to(device)


def params_from_numpy(tree, device=None):
    """The reference's SSD parameter pytree, given as nested dicts and
    lists of numpy arrays, as the port's parameters on ``device`` (as
    in ``init_ssd``): conv kernels go from (kh, kw, in, out) to
    (out, in, kh, kw)."""
    device = resolve_device(device)
    def conv(d):
        w = np.asarray(d["w"], np.float32)
        return {"w": torch.from_numpy(np.ascontiguousarray(
                    w.transpose(3, 2, 0, 1))),
                "b": torch.from_numpy(np.array(d["b"], np.float32))}
    p = {"backbone": [conv(d) for d in tree["backbone"]],
         "head8": conv(tree["head8"]), "head16": conv(tree["head16"])}
    return params_to(p, device)


@ieee_float32()
def ssd_forward(p, cfg: SSDConfig, images):
    """images: (B, S, S, 3) -> (boxes_delta (B,A,4), obj (B,A),
    cls_logits (B,A,C)).  The convolutions run in IEEE float32 whatever
    the process-wide TF32 settings say (``device.ieee_float32``)."""
    x = images.permute(0, 3, 1, 2)
    feats = []
    for blk in p["backbone"]:
        x = F.relu(_conv(blk, x, stride=2))
        feats.append(x)
    f8, f16 = feats[-2], feats[-1]           # (B,C,8,8), (B,C,4,4)
    outs = []
    for f, head in ((f8, p["head8"]), (f16, p["head16"])):
        y = _conv(head, f).permute(0, 2, 3, 1)   # (B,g,g,2*(5+C))
        B, g = y.shape[0], y.shape[1]
        outs.append(y.reshape(B, g * g * 2, 5 + cfg.n_classes))
    y = torch.cat(outs, 1)                   # (B, A, 5+C)
    return y[..., :4], y[..., 4], y[..., 5:]


def ssd_candidates(p, cfg: SSDConfig, images, anchors):
    """Forward + box decode: the per-anchor candidates the detector
    hands to NMS, (boxes (B,A,4) xyxy, scores (B,A), classes (B,A)
    int32)."""
    deltas, obj, cls_logits = ssd_forward(p, cfg, images)
    anc = anchors
    anc_wh = anc[:, 2:] - anc[:, :2]
    anc_c = (anc[:, :2] + anc[:, 2:]) / 2
    c = anc_c + deltas[..., :2] * anc_wh
    wh = anc_wh * torch.exp(torch.clamp(deltas[..., 2:], -4, 4))
    boxes = torch.cat([c - wh / 2, c + wh / 2], -1)         # (B,A,4)
    scores = torch.sigmoid(obj)
    classes = torch.argmax(cls_logits, -1).to(torch.int32)
    return boxes, scores, classes


def decode_detections(p, cfg: SSDConfig, images, anchors, score_thr=0.4,
                      iou_thr=0.5, max_out=32):
    """Full inference: ``ssd_candidates`` + fused batched NMS (one
    suppression launch for the whole micro-batch; the CUDA kernel for
    tensors on the card).  Returns per-image (boxes, scores, classes,
    valid)."""
    boxes, scores, classes = ssd_candidates(p, cfg, images, anchors)
    # score-thresholding and suppression are fused into the batched NMS;
    # stop_at_zero skips the zero-score tail
    keep, valid = kops.batched_nms(boxes, scores, iou_thr=iou_thr,
                                   score_thr=score_thr, max_out=max_out,
                                   stop_at_zero=True)
    sc = torch.where(scores >= score_thr, scores, torch.zeros_like(scores))
    k = keep.long()
    bxk = torch.gather(boxes, 1, k[..., None].expand(*k.shape, 4))
    sck = torch.gather(sc, 1, k)
    clk = torch.gather(classes, 1, k)
    valid = valid & (sck > 0)
    return bxk, sck, clk, valid

