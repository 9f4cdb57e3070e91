"""Grok-1-314B [hf:xai-org/grok-1] — MoE 8 experts top-2, every layer.
64L d_model=6144 48H (kv=8) d_ff=32768 vocab=131072.  8 experts on a
16-way model axis: expert dim is tensor-parallel *within* experts (the
rules engine picks the (None, fsdp, tensor) layout automatically)."""
from .base import SWA_WINDOW
from ..models.config import (LayerSpec, ModelConfig, MoEConfig, Stage)


def make_config(preset="full", variant=None):
    win = SWA_WINDOW if variant == "swa" else None
    if preset == "smoke":
        return ModelConfig(
            name="grok-1-smoke", d_model=256, d_ff=512, vocab_size=512,
            stages=(Stage((LayerSpec("attn", "moe"),), 2),),
            n_heads=4, n_kv_heads=2, head_dim=64,
            moe=MoEConfig(n_experts=4, top_k=2, d_ff=512), decode_window=win)
    return ModelConfig(
        name="grok-1-314b", d_model=6144, d_ff=32768, vocab_size=131072,
        stages=(Stage((LayerSpec("attn", "moe"),), 64),),
        n_heads=48, n_kv_heads=8, head_dim=128,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32768, dispatch="batched"), decode_window=win,
        dtype="bfloat16", param_dtype="bfloat16")
