"""Unified model configuration covering every assigned architecture family
(copied from the reference package's ``models/config.py``).  The port
adds DeepSeek-V3's published router (expert groups, the correction bias,
the routed scaling factor), the share of experts a card holds
(``MoEConfig.expert_first``/``n_held``) and YaRN rotary positions
(``ModelConfig.rope_scaling``); every added field defaults to the
reference's behaviour.

A model is a stack of *stages*; each stage repeats a *pattern* (period) of
layers, and each layer is a (mixer, ffn) pair:

  mixer ∈ {"attn", "mamba", "rwkv"}      ffn ∈ {"dense", "moe", "rwkv_cmix"}

Homogeneous models are one stage with a single-layer pattern; Jamba is one
stage whose pattern is the 8-layer Mamba/attention period; DeepSeek-V3 is a
3-layer dense-FFN stage followed by a 58-layer MoE stage.  Stages are
executed layer by layer in Python, over a list of per-layer parameter
dicts (the reference scans stacked period parameters instead).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

MIXERS = ("attn", "mamba", "rwkv")
FFNS = ("dense", "moe", "rwkv_cmix", "none")


@dataclass(frozen=True)
class LayerSpec:
    mixer: str = "attn"
    ffn: str = "dense"
    # Sliding-window attention (None = full). Per-layer so hybrids can mix.
    window: Optional[int] = None

    def __post_init__(self):
        assert self.mixer in MIXERS, self.mixer
        assert self.ffn in FFNS, self.ffn


@dataclass(frozen=True)
class Stage:
    pattern: Tuple[LayerSpec, ...]
    repeats: int

    @property
    def n_layers(self) -> int:
        return len(self.pattern) * self.repeats


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                      # per-expert hidden dim
    n_shared_experts: int = 0      # DeepSeek-style always-on shared experts
    shared_d_ff: int = 0           # hidden dim of the shared expert(s)
    router: str = "softmax"        # "softmax" | "sigmoid" (DeepSeek-V3)
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    router_z_weight: float = 1e-3
    dispatch: str = "global"       # "global" (paper-faithful pool) |
    #                                "batched" (per-row; shard-local gather)
    # DeepSeek-V3's "noaux_tc" router: the experts fall into n_group
    # groups, the topk_group best groups (each scored by its two best
    # choice scores) are kept, and the top_k come from them
    n_group: int = 1
    topk_group: int = 1
    routed_scaling_factor: float = 1.0   # the normalized weights' scale
    correction_bias: bool = False  # a per-expert bias on the choice score
    # the experts this card holds, ids expert_first .. expert_first +
    # n_held - 1 of n_experts (expert parallelism); n_held 0: all of them
    expert_first: int = 0
    n_held: int = 0


@dataclass(frozen=True)
class YaRNConfig:
    """YaRN rotary scaling (DeepSeek-V3's ``rope_scaling``, type yarn)."""
    factor: float = 40.0
    original_max_position_embeddings: int = 4096
    beta_fast: float = 32.0
    beta_slow: float = 1.0
    mscale: float = 1.0
    mscale_all_dim: float = 1.0


@dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0               # 0 -> ceil(d_model / 16)


@dataclass(frozen=True)
class RWKVConfig:
    head_size: int = 64
    decay_lora: int = 64           # rank of the data-dependent decay LoRA
    mix_lora: int = 32             # rank of the token-shift mix LoRA


@dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    d_ff: int
    vocab_size: int
    stages: Tuple[Stage, ...]
    # --- attention ---
    n_heads: int = 0               # 0 for attention-free models
    n_kv_heads: int = 0
    head_dim: int = 128
    qk_norm: bool = False
    causal: bool = True            # False => encoder-only (no decode path)
    rope: str = "full"             # "none" | "full" | "glm" (partial/2d)
    rope_theta: float = 10000.0
    rope_scaling: Optional[YaRNConfig] = None   # None: unscaled rotary
    mla: Optional[MLAConfig] = None
    # --- mixture of experts ---
    moe: Optional[MoEConfig] = None
    # --- SSM families ---
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # --- io / heads ---
    modality: str = "text"         # "text" | "audio" | "vlm"
    frontend_dim: int = 0          # stub-frontend embedding dim (audio/vlm)
    n_frontend_tokens: int = 0     # patches/frames occupying the seq prefix
    tie_embeddings: bool = False
    mtp: bool = False              # DeepSeek multi-token-prediction head
    mtp_loss_weight: float = 0.3
    # --- numerics ---
    norm_eps: float = 1e-5
    dtype: str = "float32"         # activation/compute dtype
    param_dtype: str = "float32"
    # --- serving ---
    decode_window: Optional[int] = None  # SWA variant window for long-context

    @property
    def n_layers(self) -> int:
        return sum(s.n_layers for s in self.stages)

    @property
    def attn_free(self) -> bool:
        return all(l.mixer != "attn" for s in self.stages for l in s.pattern)

    @property
    def encoder_only(self) -> bool:
        return not self.causal

    def layer_specs(self):
        """Flat list of LayerSpec in execution order."""
        out = []
        for s in self.stages:
            out.extend(list(s.pattern) * s.repeats)
        return out

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


def dense_stages(n_layers: int, window: Optional[int] = None,
                 ffn: str = "dense") -> Tuple[Stage, ...]:
    return (Stage(pattern=(LayerSpec("attn", ffn, window),), repeats=n_layers),)
