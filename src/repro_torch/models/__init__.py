"""The LLM substrate of the port: model configuration, the transformer
over every mixer and ffn kind of the assigned architectures (GQA and
multi-head latent attention, Mamba, RWKV-6, dense and MoE ffns, the
multi-token-prediction head; train / prefill / decode over caches) and
its building blocks, mirroring the reference package's ``models``."""
from .config import (LayerSpec, MLAConfig, MambaConfig, ModelConfig,
                     MoEConfig, RWKVConfig, Stage, dense_stages)
from .transformer import (init_cache, init_model, logits_fn, model_apply,
                          param_shapes, params_from_numpy,
                          train_state_from_numpy)

__all__ = [
    "LayerSpec", "MLAConfig", "MambaConfig", "ModelConfig", "MoEConfig",
    "RWKVConfig", "Stage", "dense_stages", "init_cache", "init_model",
    "logits_fn", "model_apply", "param_shapes", "params_from_numpy",
    "train_state_from_numpy",
]
