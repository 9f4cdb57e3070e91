"""Closed-form operations and bytes that the per-layer metrics hold the
program to, and the chip's peaks (``peaks.json``).  Each count is what
the inputs need, not what a kernel happens to do: an input byte read
once, an output byte written once, an operation counted once."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json")
                   .read_text())

IOU_FLOPS = 15     # 4 min/max, 3 sub, 2 clamp, 2 mul, add + sub, div


# ------------------------------------------------------------- detector
def ssd_conv_flops(cfg: dict) -> int:
    """Multiply-adds x 2 of the mini-SSD's convolutions for one frame:
    the stride-2 3x3 backbone blocks and the two 3x3 heads (biases,
    activations and the decode are left out)."""
    s, c_in, flops = cfg["image_size"], 3, 0
    maps = []
    for c in cfg["channels"]:
        s = -(-s // 2)
        flops += 2 * 9 * c_in * c * s * s
        maps.append((s, c))
        c_in = c
    out = 2 * (5 + cfg["n_classes"])
    for s, c in maps[-2:]:
        flops += 2 * 9 * c * out * s * s
    return flops


def nms_iou_count(boxes: np.ndarray, scores: np.ndarray, iou_thr: float,
                  score_thr: float, max_out: int, tile: int = 32) -> int:
    """IoUs greedy NMS needs on one frame's candidates: each kept box
    against the later candidates still alive when it is kept, over the
    tiles of ``tile`` sorted candidates the frame enters (the work
    stops at the tile after ``max_out`` kept boxes or at a zero score)."""
    from .reference.detector import iou
    s = np.where(scores >= np.float32(score_thr), scores, 0).astype(
        np.float32)
    order = np.argsort(-s, kind="stable")
    bs, ss = boxes[order], s[order]
    ov = iou(bs, bs)
    A = len(ss)
    alive = np.ones(A, bool)
    found = n = 0
    for c0 in range(0, A, tile):
        if found >= max_out or not ss[c0] > 0:
            break
        for i in range(c0, min(c0 + tile, A)):
            if not alive[i]:
                continue
            found += 1
            n += int(alive[i + 1:].sum())
            alive[i + 1:] &= ~(ov[i, i + 1:] >= np.float32(iou_thr))
    return n


def nms_bytes(B: int, A: int, max_out: int) -> int:
    """Boxes and scores in, kept indices and flags out."""
    return B * A * (16 + 4) + B * max_out * (4 + 1)


def assign_bytes(B: int, T: int, D: int) -> int:
    """Track and detection boxes, masks and classes in; matches out."""
    return B * (T * 16 + D * 16 + T + D + 4 * T + 4 * D) + B * T * 4


def least_time(flops: float, nbytes: float, flop_rate: float) -> float:
    """The roofline's least time: the larger of the two bounds."""
    return max(flops / flop_rate, nbytes / PEAKS["hbm_bytes_per_s"])


# ------------------------------------------------------------------ LLM
# ``cfg`` below is a configuration file's contents (published key names)
def llm_layer_params(cfg: dict) -> dict:
    """Parameters of one attention + MoE layer, by part."""
    d, H, KV, D = (cfg["hidden_size"], cfg["num_attention_heads"],
                   cfg["num_key_value_heads"], cfg["head_dim"])
    return {"attn": d * (H * D + 2 * KV * D) + H * D * d,
            "router": d * cfg["num_experts"],
            "expert": 3 * d * cfg["intermediate_size"]}


def llm_token_flops(cfg: dict, n_ctx: int, logits: bool) -> float:
    """FLOPs one token needs at context length ``n_ctx`` (itself
    included): 2 x the active parameters (attention, router, its
    ``top_k`` routed experts; the unembedding where its logits are
    needed) plus the attention scores and values over its context."""
    p = llm_layer_params(cfg)
    per_layer = (2 * (p["attn"] + p["router"]
                      + cfg["num_experts_per_tok"] * p["expert"])
                 + 4 * cfg["num_attention_heads"] * cfg["head_dim"] * n_ctx)
    f = cfg["num_hidden_layers"] * per_layer
    if logits:
        f += 2 * cfg["hidden_size"] * cfg["vocab_size"]
    return float(f)


def llm_request_flops(cfg: dict, prompt: int, served: int) -> float:
    """A served request of ``served`` tokens: a prefill of ``prompt``
    tokens whose last position's logits give the first token, then
    ``served - 1`` single-token steps, each needing its logits."""
    f = sum(llm_token_flops(cfg, t + 1, t == prompt - 1)
            for t in range(prompt))
    f += sum(llm_token_flops(cfg, prompt + i + 1, True)
             for i in range(served - 1))
    return f


def moe_least_time(cfg: dict, n_tokens: int, experts_used: int) -> float:
    """Least time of one MoE layer over ``n_tokens`` tokens that route to
    ``experts_used`` distinct experts: the routed pairs' expert FLOPs at
    the bf16 peak, against those experts' weight bytes read once."""
    p = llm_layer_params(cfg)["expert"]
    flops = 2.0 * p * n_tokens * cfg["num_experts_per_tok"]
    nbytes = 2.0 * p * experts_used
    return least_time(flops, nbytes, PEAKS["bf16_flops_per_s"])
