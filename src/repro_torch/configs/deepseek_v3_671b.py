"""DeepSeek-V3-671B [arXiv:2412.19437] — MLA + 1 shared / 256 routed top-8
MoE + MTP.  61L d_model=7168 128H vocab=129280.  The assigned d_ff=2048 is
the per-expert hidden dim; the first 3 layers are dense FFN (18432, per the
source paper) and layers 4..61 are MoE.  Sigmoid router with normalized
top-8 weights.  The MLA compressed KV cache (kv_lora 512 + rope 64) is what
makes long-context decode shapes small."""
from .base import SWA_WINDOW
from ..models.config import (MLAConfig, ModelConfig, MoEConfig,
                                 dense_stages, LayerSpec, Stage)


def make_config(preset="full", variant=None):
    win = SWA_WINDOW if variant == "swa" else None
    if preset == "smoke":
        return ModelConfig(
            name="deepseek-v3-smoke", d_model=256, d_ff=512, vocab_size=512,
            stages=(Stage((LayerSpec("attn", "dense"),), 1),
                    Stage((LayerSpec("attn", "moe"),), 1)),
            n_heads=4, n_kv_heads=4, head_dim=64,
            mla=MLAConfig(q_lora_rank=128, kv_lora_rank=64, qk_nope_dim=32,
                          qk_rope_dim=16, v_head_dim=32),
            moe=MoEConfig(n_experts=4, top_k=2, d_ff=256,
                          n_shared_experts=1, shared_d_ff=256,
                          router="sigmoid"),
            mtp=True, decode_window=win)
    return ModelConfig(
        name="deepseek-v3-671b", d_model=7168, d_ff=18432, vocab_size=129280,
        stages=(Stage((LayerSpec("attn", "dense"),), 3),
                Stage((LayerSpec("attn", "moe"),), 58)),
        n_heads=128, n_kv_heads=128, head_dim=128,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                      qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(n_experts=256, top_k=8, d_ff=2048,
                      n_shared_experts=1, shared_d_ff=2048,
                      router="sigmoid", capacity_factor=1.25,
                      dispatch="batched"),
        mtp=True, decode_window=win,
        dtype="bfloat16", param_dtype="bfloat16")
