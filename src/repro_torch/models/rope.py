"""Rotary position embeddings: standard ("full"), GLM partial-2d ("glm"),
and none (the port of the reference package's ``models/rope.py``), and
YaRN's scaled frequencies (DeepSeek-V3's ``rope_scaling``), which the
reference package does not have.  All functions take explicit integer
positions so the same code serves train, prefill, and single-token
decode.
"""
from __future__ import annotations

import math

import torch


def _rope_freqs(dim: int, theta: float, device, scaling=None):
    exps = torch.arange(0, dim, 2, dtype=torch.float32, device=device) / dim
    if scaling is None:
        return 1.0 / (theta ** exps)
    return yarn_freqs(exps, dim, theta, scaling)


def yarn_correction_range(scaling, dim: int, theta: float):
    """The rotary pairs YaRN blends over: below ``low`` a pair keeps its
    frequency, above ``high`` it is divided by ``factor`` (DeepSeek-V3's
    ``yarn_find_correction_range``)."""
    def dim_of(rotations):
        return (dim * math.log(scaling.original_max_position_embeddings
                               / (rotations * 2 * math.pi))
                / (2 * math.log(theta)))
    low = math.floor(dim_of(scaling.beta_fast))
    high = math.ceil(dim_of(scaling.beta_slow))
    return max(low, 0), min(high, dim - 1)


def yarn_freqs(exps, dim: int, theta: float, scaling):
    """YaRN's frequencies: each pair's ``f = theta ** -exps`` blended with
    ``f / factor`` by the linear ramp between the correction dims."""
    extra = 1.0 / (theta ** exps)
    inter = 1.0 / (scaling.factor * theta ** exps)
    low, high = yarn_correction_range(scaling, dim, theta)
    if low == high:
        high += 0.001
    ramp = torch.clamp((torch.arange(dim // 2, dtype=torch.float32,
                                     device=exps.device) - low)
                       / (high - low), 0, 1)
    keep = 1.0 - ramp
    return inter * (1.0 - keep) + extra * keep


def yarn_mscale(factor: float, mscale: float = 1.0) -> float:
    return 1.0 if factor <= 1 else 0.1 * mscale * math.log(factor) + 1.0


def yarn_attention_factor(scaling) -> float:
    """The factor on cos and sin: ``mscale`` over ``mscale_all_dim``'s."""
    return (yarn_mscale(scaling.factor, scaling.mscale)
            / yarn_mscale(scaling.factor, scaling.mscale_all_dim))


def _rotate_half(x):
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(x, positions, theta: float, variant: str = "full",
               scaling=None):
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers;
    ``scaling`` a ``YaRNConfig`` or None.

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
        return _apply(x, positions, theta, scaling)
    raise ValueError(f"unknown rope variant {variant!r}")


def _apply(x, positions, theta, scaling=None):
    dt = x.dtype
    dim = x.shape[-1]
    freqs = _rope_freqs(dim, theta, x.device, scaling)   # (dim/2,)
    angles = positions[..., None].float() * freqs        # (..., seq, dim/2)
    angles = torch.cat([angles, angles], dim=-1)         # (..., seq, dim)
    # broadcast over the heads axis: x is (..., seq, heads, dim)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    if scaling is not None and yarn_attention_factor(scaling) != 1.0:
        cos = cos * yarn_attention_factor(scaling)
        sin = sin * yarn_attention_factor(scaling)
    x32 = x.float()
    return (x32 * cos + _rotate_half(x32) * sin).to(dt)
