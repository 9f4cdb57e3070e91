"""MiniCPM-2B [arXiv:2404.06395] — llama-like dense, MHA (kv=36), tied
embeddings, trained with the WSD (warmup-stable-decay) schedule, which is
implemented in ``repro.optim.schedules``.  40L d_model=2304 36H d_ff=5760
vocab=122753, head_dim=64.  36 heads do not divide the 16-way model axis —
the rules engine falls back to fsdp-only sharding for attention projections
(padding to 48 heads is a recorded §Perf candidate)."""
from .base import SWA_WINDOW
from ..models.config import ModelConfig, dense_stages


def make_config(preset="full", variant=None):
    win = SWA_WINDOW if variant == "swa" else None
    if preset == "smoke":
        return ModelConfig(
            name="minicpm-2b-smoke", d_model=256, d_ff=512, vocab_size=512,
            stages=dense_stages(2), n_heads=4, n_kv_heads=4, head_dim=64,
            tie_embeddings=True, decode_window=win)
    return ModelConfig(
        name="minicpm-2b", d_model=2304, d_ff=5760, vocab_size=122753,
        stages=dense_stages(40), n_heads=36, n_kv_heads=36, head_dim=64,
        tie_embeddings=True, decode_window=win,
        dtype="bfloat16", param_dtype="bfloat16")
