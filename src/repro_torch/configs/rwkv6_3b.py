"""RWKV6-3B "Finch" [arXiv:2404.05892] — attention-free, data-dependent
per-channel decay.  32L d_model=2560 d_ff=8960 vocab=65536, head_size=64
(40 heads).  O(1) recurrent state ⇒ long_500k runs natively."""
from ..models.config import (LayerSpec, ModelConfig, RWKVConfig, Stage)


def make_config(preset="full", variant=None):
    if preset == "smoke":
        return ModelConfig(
            name="rwkv6-3b-smoke", d_model=256, d_ff=512, vocab_size=512,
            stages=(Stage((LayerSpec("rwkv", "rwkv_cmix"),), 2),),
            n_heads=0, n_kv_heads=0, rope="none",
            rwkv=RWKVConfig(head_size=32))
    return ModelConfig(
        name="rwkv6-3b", d_model=2560, d_ff=8960, vocab_size=65536,
        stages=(Stage((LayerSpec("rwkv", "rwkv_cmix"),), 32),),
        n_heads=0, n_kv_heads=0, rope="none",
        rwkv=RWKVConfig(head_size=64),
        dtype="bfloat16", param_dtype="bfloat16")
