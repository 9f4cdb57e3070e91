"""Prefill / decode step builders for serving (the port of the serving
half of the reference package's ``runtime/steps.py``; ``train_step``,
``loss_fn`` and the AdamW path wait for ``optim/``, ROADMAP.md section 1,
item 2).  The reference jits each step; here each is a plain function
that runs eagerly on the device of its inputs."""
from __future__ import annotations

from ..models import init_cache, model_apply
from ..models.config import ModelConfig


def make_prefill_step(cfg: ModelConfig, cache_len: int | None = None):
    """``prefill(params, batch) -> (logits (B, V) at the last position,
    cache)``; the cache holds ``cache_len`` positions (default: the
    prompt's length) on the device of the batch's inputs."""
    def prefill(params, batch):
        x = batch["features"] if cfg.modality == "audio" else batch["tokens"]
        S = _seq_len(cfg, batch)
        cache = init_cache(cfg, x.shape[0], cache_len or S, device=x.device)
        logits, cache, _ = model_apply(params, cfg, batch, mode="prefill",
                                       cache=cache)
        return logits[:, -1], cache
    return prefill


def make_decode_step(cfg: ModelConfig):
    """``decode(params, {"tokens" (B, 1), "cache", "decode_pos"}) ->
    (logits (B, V), cache)``."""
    def decode(params, batch):
        logits, cache, _ = model_apply(
            params, cfg, {"tokens": batch["tokens"]}, mode="decode",
            cache=batch["cache"], decode_pos=batch["decode_pos"])
        return logits[:, -1], cache
    return decode


def _seq_len(cfg: ModelConfig, batch):
    if cfg.modality == "audio":
        return batch["features"].shape[1]
    S = batch["tokens"].shape[1]
    if cfg.modality == "vlm" and "image_embeds" in batch:
        S += batch["image_embeds"].shape[1]
    return S
