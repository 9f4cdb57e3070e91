"""Pixtral-12B [hf:mistralai/Pixtral-12B-2409] — VLM: Pixtral-ViT frontend
(STUB: ``input_specs`` provides precomputed patch embeddings, dim 1024)
feeding a Mistral-Nemo-12B language backbone.  40L d_model=5120 32H (kv=8)
d_ff=14336 vocab=131072.  Image patches occupy the first 1024 sequence
positions during train/prefill; decode consumes text tokens only."""
from .base import SWA_WINDOW
from ..models.config import ModelConfig, dense_stages


def make_config(preset="full", variant=None):
    win = SWA_WINDOW if variant == "swa" else None
    if preset == "smoke":
        return ModelConfig(
            name="pixtral-12b-smoke", d_model=256, d_ff=512, vocab_size=512,
            stages=dense_stages(2), n_heads=4, n_kv_heads=2, head_dim=64,
            modality="vlm", frontend_dim=64, n_frontend_tokens=16,
            decode_window=win)
    return ModelConfig(
        name="pixtral-12b", d_model=5120, d_ff=14336, vocab_size=131072,
        stages=dense_stages(40), n_heads=32, n_kv_heads=8, head_dim=128,
        rope_theta=1e6, modality="vlm", frontend_dim=1024,
        n_frontend_tokens=1024, decode_window=win,
        dtype="bfloat16", param_dtype="bfloat16")
