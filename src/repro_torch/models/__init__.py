"""The LLM substrate of the port: model configuration, the dense GQA
transformer (train / prefill / decode over ring caches) and its
building blocks, mirroring the reference package's ``models``."""
from .config import (LayerSpec, MLAConfig, MambaConfig, ModelConfig,
                     MoEConfig, RWKVConfig, Stage, dense_stages)
from .transformer import (init_cache, init_model, logits_fn, model_apply,
                          params_from_numpy)

__all__ = [
    "LayerSpec", "MLAConfig", "MambaConfig", "ModelConfig", "MoEConfig",
    "RWKVConfig", "Stage", "dense_stages", "init_cache", "init_model",
    "logits_fn", "model_apply", "params_from_numpy",
]
