"""Rotary position embeddings: standard ("full"), GLM partial-2d ("glm"),
and none (the port of the reference package's ``models/rope.py``).  All
functions take explicit integer positions so the same code serves train,
prefill, and single-token decode.
"""
from __future__ import annotations

import torch


def _rope_freqs(dim: int, theta: float, device):
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    return 1.0 / (theta ** exps)


def _rotate_half(x):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x, positions, theta: float, variant: str = "full"):
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers.

    variant:
      "none" -> identity
      "full" -> rotary over the whole head_dim (non-interleaved halves)
      "glm"  -> ChatGLM-style: rotary over the first half of head_dim only
                (the "2d" scheme degenerates to 1d positions for standard
                causal LM usage; the second half carries no rotation).
    """
    if variant == "none":
        return x
    head_dim = x.shape[-1]
    if variant == "glm":
        rot_dim = head_dim // 2
        x_rot, x_pass = x[..., :rot_dim], x[..., rot_dim:]
        x_rot = _apply(x_rot, positions, theta)
        return torch.cat([x_rot, x_pass], dim=-1)
    if variant == "full":
        return _apply(x, positions, theta)
    raise ValueError(f"unknown rope variant {variant!r}")


def _apply(x, positions, theta):
    dt = x.dtype
    dim = x.shape[-1]
    freqs = _rope_freqs(dim, theta, x.device)            # (dim/2,)
    angles = positions[..., None].float() * freqs        # (..., seq, dim/2)
    angles = torch.cat([angles, angles], dim=-1)         # (..., seq, dim)
    # broadcast over the heads axis: x is (..., seq, heads, dim)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x32 = x.float()
    return (x32 * cos + _rotate_half(x32) * sin).to(dt)
