"""Jamba-v0.1-52B [arXiv:2403.19887] — hybrid Mamba+attention 7:1 with
MoE 16e top-2 every other layer.  32L d_model=4096 32H (kv=8) d_ff=14336
vocab=65536.  Period of 8 layers: attention at index 4, Mamba elsewhere;
MoE FFN on odd indices.  SSM state ⇒ long_500k runs natively (the 4
attention layers keep a full KV cache, sharded over the data axis).
"""
from ..models.config import (LayerSpec, MambaConfig, ModelConfig,
                                 MoEConfig, Stage)


def _pattern(window=None):
    specs = []
    for i in range(8):
        mixer = "attn" if i == 4 else "mamba"
        ffn = "moe" if i % 2 == 1 else "dense"
        specs.append(LayerSpec(mixer, ffn, window))
    return tuple(specs)


def make_config(preset="full", variant=None):
    if preset == "smoke":
        return ModelConfig(
            name="jamba-v0.1-52b-smoke", d_model=256, d_ff=512,
            vocab_size=512,
            stages=(Stage(pattern=(LayerSpec("mamba", "moe"),
                                   LayerSpec("attn", "dense")), repeats=1),),
            n_heads=4, n_kv_heads=2, head_dim=64, rope="full",
            moe=MoEConfig(n_experts=4, top_k=2, d_ff=512),
            mamba=MambaConfig(d_state=8, d_conv=4, expand=2))
    return ModelConfig(
        name="jamba-v0.1-52b", d_model=4096, d_ff=14336, vocab_size=65536,
        stages=(Stage(pattern=_pattern(), repeats=4),),
        n_heads=32, n_kv_heads=8, head_dim=128, rope="full",
        moe=MoEConfig(n_experts=16, top_k=2, d_ff=14336, dispatch="batched"),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        dtype="bfloat16", param_dtype="bfloat16")
