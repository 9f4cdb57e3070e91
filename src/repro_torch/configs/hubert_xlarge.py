"""HuBERT-XLarge [arXiv:2106.07447] — audio encoder-only backbone.

48L d_model=1280 16H (kv=16) d_ff=5120 vocab=504 (masked-unit prediction
targets).  The mel/conv feature extractor is a stub: ``input_specs`` feeds
precomputed frame embeddings (frontend_dim=512, the wav2vec2 conv output
width).  Positional information: we use RoPE in place of HuBERT's
convolutional relative positional embedding (stub-frontend carve-out;
recorded here).  Encoder-only ⇒ no decode shapes.
"""
from ..models.config import ModelConfig, dense_stages


def make_config(preset="full", variant=None):
    if preset == "smoke":
        return ModelConfig(
            name="hubert-xlarge-smoke", d_model=256, d_ff=512, vocab_size=504,
            stages=dense_stages(2), n_heads=4, n_kv_heads=4, head_dim=64,
            causal=False, rope="full", modality="audio", frontend_dim=64)
    return ModelConfig(
        name="hubert-xlarge", d_model=1280, d_ff=5120, vocab_size=504,
        stages=dense_stages(48), n_heads=16, n_kv_heads=16, head_dim=80,
        causal=False, rope="full", modality="audio", frontend_dim=512,
        dtype="bfloat16", param_dtype="bfloat16")
