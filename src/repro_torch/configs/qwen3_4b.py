"""Qwen3-4B [hf:Qwen/Qwen3-8B] — dense, GQA kv=8, per-head qk-RMSNorm.
36L d_model=2560 32H d_ff=9728 vocab=151936, head_dim=128."""
from .base import SWA_WINDOW
from ..models.config import ModelConfig, dense_stages


def make_config(preset="full", variant=None):
    win = SWA_WINDOW if variant == "swa" else None
    if preset == "smoke":
        return ModelConfig(
            name="qwen3-4b-smoke", d_model=256, d_ff=512, vocab_size=512,
            stages=dense_stages(2), n_heads=4, n_kv_heads=2, head_dim=64,
            qk_norm=True, decode_window=win)
    return ModelConfig(
        name="qwen3-4b", d_model=2560, d_ff=9728, vocab_size=151936,
        stages=dense_stages(36), n_heads=32, n_kv_heads=8, head_dim=128,
        qk_norm=True, rope_theta=1e6, decode_window=win,
        dtype="bfloat16", param_dtype="bfloat16")
