"""DeepSeek-V3-671B [arXiv:2412.19437] — MLA + 1 shared / 256 routed top-8
MoE + MTP.  61L d_model=7168 128H vocab=129280.  The assigned d_ff=2048 is
the per-expert hidden dim; the first 3 layers are dense FFN (18432, per the
source paper) and layers 4..61 are MoE.  The MLA compressed KV cache
(kv_lora 512 + rope 64) is what makes long-context decode shapes small.

``full`` routes as published ("noaux_tc": sigmoid scores, a per-expert
correction bias on the choice score, the best 4 of 8 expert groups, the
top 8 inside them, weights normalized and scaled by 2.5) and scales its
rotary positions by YaRN (factor 40 over 4096 original positions,
``mscale`` = ``mscale_all_dim`` = 1), which the reference package has
neither of.  ``smoke`` is the reference's reduced preset (a plain
sigmoid top-k, no YaRN), held to the JAX package by the parity tests.
``small`` is a reduced preset with the published mechanisms, in float32,
for the CPU tests: 16 experts in 4 groups, top 4 inside the best 2, YaRN
as published."""
from .base import SWA_WINDOW
from ..models.config import (MLAConfig, ModelConfig, MoEConfig, YaRNConfig,
                                 dense_stages, LayerSpec, Stage)

#: the published ``rope_scaling``
YARN = YaRNConfig(factor=40.0, original_max_position_embeddings=4096,
                  beta_fast=32.0, beta_slow=1.0, mscale=1.0,
                  mscale_all_dim=1.0)


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
    if preset == "small":
        return ModelConfig(
            name="deepseek-v3-small", d_model=64, d_ff=128, vocab_size=256,
            stages=(Stage((LayerSpec("attn", "dense"),), 1),
                    Stage((LayerSpec("attn", "moe"),), 2)),
            n_heads=4, n_kv_heads=4, head_dim=32,
            rope_scaling=YARN,
            mla=MLAConfig(q_lora_rank=32, kv_lora_rank=32, qk_nope_dim=16,
                          qk_rope_dim=16, v_head_dim=16),
            moe=MoEConfig(n_experts=16, top_k=4, d_ff=32,
                          n_shared_experts=1, shared_d_ff=32,
                          router="sigmoid", capacity_factor=1.25,
                          dispatch="batched", n_group=4, topk_group=2,
                          routed_scaling_factor=2.5, correction_bias=True),
            norm_eps=1e-6, decode_window=win)
    return ModelConfig(
        name="deepseek-v3-671b", d_model=7168, d_ff=18432, vocab_size=129280,
        stages=(Stage((LayerSpec("attn", "dense"),), 3),
                Stage((LayerSpec("attn", "moe"),), 58)),
        n_heads=128, n_kv_heads=128, head_dim=128,
        rope_scaling=YARN,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512, qk_nope_dim=128,
                      qk_rope_dim=64, v_head_dim=128),
        moe=MoEConfig(n_experts=256, top_k=8, d_ff=2048,
                      n_shared_experts=1, shared_d_ff=2048,
                      router="sigmoid", capacity_factor=1.25,
                      dispatch="batched", n_group=8, topk_group=4,
                      routed_scaling_factor=2.5, correction_bias=True),
        mtp=True, decode_window=win,
        dtype="bfloat16", param_dtype="bfloat16")
