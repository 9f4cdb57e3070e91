"""Mistral-Nemo-12B [hf:mistralai/Mistral-Nemo-Base-2407] — dense, GQA
kv=8, 128k context.  40L d_model=5120 32H d_ff=14336 vocab=131072,
head_dim=128."""
from .base import SWA_WINDOW
from ..models.config import ModelConfig, dense_stages


def make_config(preset="full", variant=None):
    win = SWA_WINDOW if variant == "swa" else None
    if preset == "smoke":
        return ModelConfig(
            name="mistral-nemo-12b-smoke", d_model=256, d_ff=512,
            vocab_size=512, stages=dense_stages(2), n_heads=4, n_kv_heads=2,
            head_dim=64, decode_window=win)
    return ModelConfig(
        name="mistral-nemo-12b", d_model=5120, d_ff=14336, vocab_size=131072,
        stages=dense_stages(40), n_heads=32, n_kv_heads=8, head_dim=128,
        rope_theta=1e6, decode_window=win,
        dtype="bfloat16", param_dtype="bfloat16")
