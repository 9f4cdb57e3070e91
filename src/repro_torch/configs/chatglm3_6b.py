"""ChatGLM3-6B [arXiv:2406.12793] — dense, RoPE-2d (GLM partial rotary),
GQA with kv=2 (multi-query-ish).  28L d_model=4096 32H d_ff=13696
vocab=65024."""
from .base import SWA_WINDOW
from ..models.config import ModelConfig, dense_stages


def make_config(preset="full", variant=None):
    win = SWA_WINDOW if variant == "swa" else None
    if preset == "smoke":
        return ModelConfig(
            name="chatglm3-6b-smoke", d_model=256, d_ff=512, vocab_size=512,
            stages=dense_stages(2), n_heads=4, n_kv_heads=2, head_dim=64,
            rope="glm", decode_window=win)
    return ModelConfig(
        name="chatglm3-6b", d_model=4096, d_ff=13696, vocab_size=65024,
        stages=dense_stages(28), n_heads=32, n_kv_heads=2, head_dim=128,
        rope="glm", rope_theta=10000.0, decode_window=win,
        dtype="bfloat16", param_dtype="bfloat16")
