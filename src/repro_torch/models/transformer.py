"""Composable model: stages of layer periods over the ported mixer/ffn
kinds (the port of the reference package's ``models/transformer.py``).

One code path serves the dense attention architectures in all three
execution modes (train / prefill / decode).  The reference runs each
stage under ``jax.lax.scan`` over stacked period parameters; the port
runs the layers one by one in Python, over a flat list of per-layer
parameter dicts in execution order (``params["stages"][i]["layers"]``,
and likewise ``cache[i]["caches"]``).  The reference's sharding
constraints have no counterpart here (the XLA sharding modules are
``ROADMAP.md`` section 1, item 3).  The mixers ``mamba`` and ``rwkv``,
the ffns ``moe`` and ``rwkv_cmix``, multi-head latent attention and the
multi-token-prediction head are not ported yet and raise
``NotImplementedError`` (``ROADMAP.md`` section 1, item 2).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..device import ieee_float32, params_to, resolve_device
from . import attention, layers
from .config import ModelConfig

ZERO_AUX = {"aux_loss": 0.0, "load_balance": 0.0, "router_z": 0.0}


def unported(cfg: ModelConfig):
    """The parts of the reference's model code that ``cfg`` needs and the
    port does not have yet (``ROADMAP.md`` section 1, item 2)."""
    specs = cfg.layer_specs()
    parts = [f"the {m!r} mixer"
             for m in sorted({s.mixer for s in specs} - {"attn"})]
    parts += [f"the {f!r} ffn"
              for f in sorted({s.ffn for s in specs} - {"dense", "none"})]
    if cfg.mla:
        parts.append("multi-head latent attention")
    if cfg.mtp:
        parts.append("the multi-token-prediction head")
    return parts


def check_ported(cfg: ModelConfig):
    """Raise ``NotImplementedError`` where ``cfg`` needs a part of the
    reference's model code that the port does not have yet: the one gate
    of ``get_config``, ``init_model``, ``init_cache``,
    ``params_from_numpy`` and ``model_apply``."""
    parts = unported(cfg)
    if parts:
        raise NotImplementedError(
            f"{cfg.name} needs {', '.join(parts)}, not ported yet "
            "(ROADMAP.md, section 1, item 2)")


# ------------------------------------------------------------------ layers
def init_layer(generator, cfg: ModelConfig, spec):
    dt = layers.torch_dtype(cfg.param_dtype)
    dev = generator.device
    p: Dict[str, Any] = {
        "mixer_norm": layers.init_rms_norm(cfg.d_model, dt, dev),
        "mixer": attention.init_attention(generator, cfg)}
    if spec.ffn == "dense":
        p["ffn_norm"] = layers.init_rms_norm(cfg.d_model, dt, dev)
        p["ffn"] = layers.init_mlp(generator, cfg.d_model, cfg.d_ff, dt)
    return p


def apply_layer(p, cfg: ModelConfig, spec, h, positions, mode="train",
                cache=None, decode_pos=None):
    cache = cache or {}
    h_norm = layers.apply_rms_norm(p["mixer_norm"], h, cfg.norm_eps)
    y, mc = attention.apply_attention(p["mixer"], cfg, spec, h_norm,
                                      positions, mode=mode,
                                      cache=cache.get("mixer"),
                                      decode_pos=decode_pos)
    h = h + y
    if spec.ffn == "dense":
        f_norm = layers.apply_rms_norm(p["ffn_norm"], h, cfg.norm_eps)
        h = h + layers.apply_mlp(p["ffn"], f_norm)
    return h, {"mixer": mc if mc is not None else {}, "ffn": {}}


# ------------------------------------------------------------------ model
def init_model(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Random parameters drawn from ``generator`` (on its device), placed
    on ``device`` (None: ``cuda``, raising where no CUDA device exists).
    They do not reproduce the reference's ``jax.random`` draws; to run
    the reference's weights use ``params_from_numpy``."""
    check_ported(cfg)
    device = resolve_device(device)
    dt = layers.torch_dtype(cfg.param_dtype)
    p: Dict[str, Any] = {}
    if cfg.modality != "audio":
        p["embed"] = layers.init_embedding(generator, cfg.vocab_size,
                                           cfg.d_model, dt)
    if cfg.modality in ("audio", "vlm"):
        p["frontend"] = {"w": layers.dense_init(generator, cfg.frontend_dim,
                                                cfg.d_model, dt)}
    p["stages"] = [{"layers": [init_layer(generator, cfg, spec)
                               for _ in range(s.repeats)
                               for spec in s.pattern]}
                   for s in cfg.stages]
    p["final_norm"] = layers.init_rms_norm(cfg.d_model, dt, generator.device)
    if not cfg.tie_embeddings:
        p["unembed"] = layers.init_unembed(generator, cfg.d_model,
                                           cfg.vocab_size, dt)
    return params_to(p, device)


def _tensor(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":      # ml_dtypes' bfloat16 (jax's numpy)
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def params_from_numpy(cfg: ModelConfig, tree, device=None):
    """The reference's parameter pytree, given as nested dicts and lists
    of numpy arrays (``jax.tree.map(np.array, init_model(cfg, key))``),
    as the port's parameters on ``device`` (as in ``init_model``): each
    stage's stacked ``layers`` (one stack per pattern position, the
    leading axis the repeats) is unstacked into per-layer dicts in
    execution order."""
    check_ported(cfg)
    device = resolve_device(device)

    def tensors(t):
        if isinstance(t, dict):
            return {k: tensors(v) for k, v in t.items()}
        return _tensor(t)

    def unstack(t, r):
        if isinstance(t, dict):
            return {k: unstack(v, r) for k, v in t.items()}
        return np.asarray(t)[r]

    p = {k: tensors(v) for k, v in tree.items() if k != "stages"}
    p["stages"] = [{"layers": [tensors(unstack(stacks[j], r))
                               for r in range(stage.repeats)
                               for j in range(len(stage.pattern))]}
                   for stage, stacks in zip(cfg.stages,
                                            (s["layers"]
                                             for s in tree["stages"]))]
    return params_to(p, device)


def init_cache(cfg: ModelConfig, batch, cache_len, dtype=None, device=None):
    """Zeroed ring caches, one per layer, on ``device`` (None: ``cuda``)."""
    check_ported(cfg)
    device = resolve_device(device)
    dtype = layers.torch_dtype(dtype or cfg.dtype)
    return [{"caches": [{"mixer": attention.init_attention_cache(
                             cfg, spec, batch, cache_len, dtype, device),
                         "ffn": {}}
                        for _ in range(s.repeats) for spec in s.pattern]}
            for s in cfg.stages]


def _embed_inputs(p, cfg: ModelConfig, batch_in):
    if cfg.modality == "audio":
        h = batch_in["features"] @ p["frontend"]["w"]
    elif cfg.modality == "vlm" and "image_embeds" in batch_in:
        img = batch_in["image_embeds"] @ p["frontend"]["w"]
        txt = layers.apply_embedding(p["embed"], batch_in["tokens"])
        h = torch.cat([img, txt], dim=1)
    else:
        h = layers.apply_embedding(p["embed"], batch_in["tokens"])
    return h.to(layers.torch_dtype(cfg.dtype))


def _unembed(p, cfg: ModelConfig, h):
    if cfg.tie_embeddings:
        logits = h @ p["embed"]["table"].T
    else:
        logits = layers.apply_unembed(p["unembed"], h)
    padded = logits.shape[-1]
    if padded != cfg.vocab_size:  # mask pad slots out of the softmax
        valid = torch.arange(padded, device=logits.device) < cfg.vocab_size
        logits = torch.where(valid, logits, torch.finfo(logits.dtype).min)
    return logits


def logits_fn(p, cfg: ModelConfig, h):
    h = layers.apply_rms_norm(p["final_norm"], h, cfg.norm_eps)
    return _unembed(p, cfg, h)


@ieee_float32()
def model_apply(p, cfg: ModelConfig, batch_in: Dict[str, Any],
                mode: str = "train", cache: Optional[List] = None,
                decode_pos: Optional[int] = None):
    """Returns (logits, new_cache, aux).  ``decode_pos`` is the position
    of the one new token in decode mode.  Float32 products run in IEEE
    float32 whatever the process-wide TF32 settings say
    (``device.ieee_float32``)."""
    check_ported(cfg)
    h = _embed_inputs(p, cfg, batch_in)
    B, S, _ = h.shape
    if mode == "decode":
        positions = torch.full((B, 1), int(decode_pos), dtype=torch.int64,
                               device=h.device)
    else:
        positions = torch.arange(S, device=h.device)[None].expand(B, S)

    new_caches = []
    for i, stage in enumerate(cfg.stages):
        lps = p["stages"][i]["layers"]
        lcs = (cache[i]["caches"] if cache is not None
               else [None] * len(lps))
        specs = list(stage.pattern) * stage.repeats
        ncs = []
        for lp, lc, spec in zip(lps, lcs, specs):
            h, nc = apply_layer(lp, cfg, spec, h, positions, mode=mode,
                                cache=lc, decode_pos=decode_pos)
            ncs.append(nc)
        new_caches.append({"caches": ncs})

    logits = logits_fn(p, cfg, h)
    # no moe ffn is ported, so every auxiliary loss is zero
    return (logits, (new_caches if cache is not None else None),
            dict(ZERO_AUX))
