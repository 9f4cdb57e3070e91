"""Composable model: stages of layer periods over any mixer/ffn mix (the
port of the reference package's ``models/transformer.py``).

One code path serves all ten architectures of ``configs.ARCH_IDS`` in
all three execution modes (train / prefill / decode): the mixers
``attn`` (GQA, or multi-head latent attention where ``cfg.mla``),
``mamba`` and ``rwkv``, the ffns ``dense``, ``moe`` and ``rwkv_cmix``,
and DeepSeek's multi-token-prediction head.  The reference runs each
stage under ``jax.lax.scan`` over stacked period parameters; the port
runs the layers one by one in Python, over a flat list of per-layer
parameter dicts in execution order (``params["stages"][i]["layers"]``,
and likewise ``cache[i]["caches"]``).  Activations carry the
reference's sharding constraints (``sharding.context.constrain``): the
identity off a mesh, a resolved spec on one.
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..device import ieee_float32, params_to, resolve_device
from ..sharding.context import constrain
from . import attention, layers, mamba, moe, rwkv
from .config import LayerSpec, ModelConfig

ZERO_AUX = {"aux_loss": 0.0, "load_balance": 0.0, "router_z": 0.0}


# ------------------------------------------------------------------ layers
def init_layer(generator, cfg: ModelConfig, spec: LayerSpec):
    dt = layers.torch_dtype(cfg.param_dtype)
    dev = generator.device
    p: Dict[str, Any] = {"mixer_norm": layers.init_rms_norm(cfg.d_model, dt,
                                                            dev)}
    if spec.mixer == "attn":
        p["mixer"] = attention.init_attention(generator, cfg)
    elif spec.mixer == "mamba":
        p["mixer"] = mamba.init_mamba(generator, cfg)
    elif spec.mixer == "rwkv":
        p["mixer"] = rwkv.init_rwkv(generator, cfg)
    else:
        raise ValueError(spec.mixer)
    if spec.ffn != "none":
        p["ffn_norm"] = layers.init_rms_norm(cfg.d_model, dt, dev)
    if spec.ffn == "dense":
        p["ffn"] = layers.init_mlp(generator, cfg.d_model, cfg.d_ff, dt)
    elif spec.ffn == "moe":
        p["ffn"] = moe.init_moe(generator, cfg)
    elif spec.ffn == "rwkv_cmix":
        p["ffn"] = rwkv.init_rwkv_cmix(generator, cfg)
    return p


def init_layer_cache(cfg: ModelConfig, spec: LayerSpec, batch, cache_len,
                     dtype, device):
    c: Dict[str, Any] = {}
    if spec.mixer == "attn":
        c["mixer"] = attention.init_attention_cache(cfg, spec, batch,
                                                    cache_len, dtype, device)
    elif spec.mixer == "mamba":
        c["mixer"] = mamba.init_mamba_cache(cfg, batch, dtype, device)
    elif spec.mixer == "rwkv":
        c["mixer"] = rwkv.init_rwkv_cache(cfg, batch, dtype, device)
    c["ffn"] = (rwkv.init_cmix_cache(cfg, batch, dtype, device)
                if spec.ffn == "rwkv_cmix" else {})
    return c


def apply_layer(p, cfg: ModelConfig, spec: LayerSpec, h, positions,
                mode="train", cache=None, decode_pos=None):
    """One layer: (h, its new cache, its auxiliary losses)."""
    cache = cache or {}
    h_norm = layers.apply_rms_norm(p["mixer_norm"], h, cfg.norm_eps)
    if spec.mixer == "attn":
        y, mc = attention.apply_attention(p["mixer"], cfg, spec, h_norm,
                                          positions, mode=mode,
                                          cache=cache.get("mixer"),
                                          decode_pos=decode_pos)
    elif spec.mixer == "mamba":
        y, mc = mamba.apply_mamba(p["mixer"], cfg, h_norm, mode=mode,
                                  cache=cache.get("mixer"))
    else:
        y, mc = rwkv.apply_rwkv(p["mixer"], cfg, h_norm, mode=mode,
                                cache=cache.get("mixer"))
    h = h + y
    h = constrain(h, "batch", "seq", None)

    aux = dict(ZERO_AUX)
    fc: Any = {}
    if spec.ffn != "none":
        f_norm = layers.apply_rms_norm(p["ffn_norm"], h, cfg.norm_eps)
        if spec.ffn == "dense":
            f = layers.apply_mlp(p["ffn"], f_norm)
        elif spec.ffn == "moe":
            f, moe_aux = moe.apply_moe(p["ffn"], cfg, f_norm)
            aux.update(moe_aux)
        else:
            f, fc = rwkv.apply_rwkv_cmix(p["ffn"], cfg, f_norm, mode=mode,
                                         cache=cache.get("ffn"))
            fc = fc or {}
        h = h + f
        h = constrain(h, "batch", "seq", None)
    new_cache = {"mixer": mc if mc is not None else {}, "ffn": fc}
    return h, new_cache, aux


# ------------------------------------------------------------------ model
def init_model(cfg: ModelConfig, generator: torch.Generator, device=None):
    """Random parameters drawn from ``generator`` (on its device), placed
    on ``device`` (None: ``cuda``, raising where no CUDA device exists).
    They do not reproduce the reference's ``jax.random`` draws; to run
    the reference's weights use ``params_from_numpy``."""
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
    if cfg.mtp:
        dev = generator.device
        p["mtp"] = {
            "proj": layers.dense_init(generator, 2 * cfg.d_model,
                                      cfg.d_model, dt),
            "norm_h": layers.init_rms_norm(cfg.d_model, dt, dev),
            "norm_e": layers.init_rms_norm(cfg.d_model, dt, dev),
            "layer": init_layer(generator, cfg, LayerSpec("attn", "dense")),
            "final_norm": layers.init_rms_norm(cfg.d_model, dt, dev),
        }
    return params_to(p, device)


class _ShapeOnly(torch.Generator):
    """A generator whose device is ``meta``: every draw of ``init_model``
    lands on a ``meta`` tensor, which has a shape and a dtype and no
    data, so nothing is drawn or allocated."""

    @property
    def device(self):
        return torch.device("meta")


def param_shapes(cfg: ModelConfig):
    """``init_model``'s parameter tree as ``meta`` tensors (the
    counterpart of the reference's ``jax.eval_shape(init_model)``): every
    leaf's shape and dtype, no data, so a 671B configuration builds in
    host memory.  ``init_model``'s draws for any real device are
    unchanged."""
    return init_model(cfg, _ShapeOnly(), device="meta")


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
    execution order.  Every leaf keeps its dtype: the float32 leaves of
    a bf16 model (router weights, ``A_log``, ``w0``, ...) stay float32,
    and a stacked expert tensor (repeats, E, d, f) unstacks to (E, d,
    f)."""
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


def train_state_from_numpy(cfg: ModelConfig, state, device=None):
    """The reference's train state ``{"params", "opt": {"m", "v",
    "step"}}`` (``jax.tree.map(np.array, state)``) as the port's, on
    ``device`` (as in ``init_model``): the parameters and both moments
    through ``params_from_numpy`` (the moments have the parameters'
    tree, each leaf in its own dtype), the step a 0-d int32 tensor."""
    device = resolve_device(device)
    opt = state["opt"]
    return {"params": params_from_numpy(cfg, state["params"], device),
            "opt": {"m": params_from_numpy(cfg, opt["m"], device),
                    "v": params_from_numpy(cfg, opt["v"], device),
                    "step": _tensor(opt["step"]).to(device)}}


def init_cache(cfg: ModelConfig, batch, cache_len, dtype=None, device=None):
    """Zeroed caches, one per layer, on ``device`` (None: ``cuda``): ring
    caches for attention, conv window and state for Mamba, token shifts
    and state for RWKV (the states float32)."""
    device = resolve_device(device)
    dtype = layers.torch_dtype(dtype or cfg.dtype)
    return [{"caches": [init_layer_cache(cfg, spec, batch, cache_len, dtype,
                                         device)
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


def _repetition(lps, lcs, pattern, cfg, h, positions, mode, decode_pos):
    """One repetition of a stage's pattern (the reference's scan body):
    (h, the layers' new caches, their auxiliary losses summed)."""
    ncs, aux_tot = [], dict(ZERO_AUX)
    for lp, lc, spec in zip(lps, lcs, pattern):
        h, nc, aux = apply_layer(lp, cfg, spec, h, positions, mode=mode,
                                 cache=lc, decode_pos=decode_pos)
        ncs.append(nc)
        aux_tot = {k: aux_tot[k] + aux[k] for k in aux_tot}
    return h, ncs, aux_tot


@ieee_float32()
def model_apply(p, cfg: ModelConfig, batch_in: Dict[str, Any],
                mode: str = "train", cache: Optional[List] = None,
                decode_pos: Optional[int] = None, remat: bool = False):
    """Returns (logits, new_cache, aux).  ``decode_pos`` is the position
    of the one new token in decode mode.  Float32 products run in IEEE
    float32 whatever the process-wide TF32 settings say
    (``device.ieee_float32``).  ``aux`` holds the auxiliary losses of
    the MoE layers, summed over layers (zero without one), and in train
    mode, for a model with the multi-token-prediction head,
    ``mtp_logits``.  With ``remat`` and grad enabled, each repetition of
    a stage's pattern is recomputed in backward
    (``torch.utils.checkpoint``, as the reference checkpoints its scan
    body): autograd keeps the stage's input to each repetition, not the
    activations inside it.  Values are the same either way; with grad
    disabled ``remat`` changes nothing."""
    h = _embed_inputs(p, cfg, batch_in)
    B, S, _ = h.shape
    h = constrain(h, "batch", "seq", None)
    if mode == "decode":
        positions = torch.full((B, 1), int(decode_pos), dtype=torch.int64,
                               device=h.device)
    else:
        positions = torch.arange(S, device=h.device)[None].expand(B, S)
    rep = _repetition
    if remat and torch.is_grad_enabled():
        rep = functools.partial(checkpoint, _repetition, use_reentrant=False,
                                preserve_rng_state=False)  # draws nothing

    new_caches, aux_tot = [], dict(ZERO_AUX)
    for i, stage in enumerate(cfg.stages):
        lps = p["stages"][i]["layers"]
        lcs = (cache[i]["caches"] if cache is not None
               else [None] * len(lps))
        P = len(stage.pattern)
        ncs, aux_stage = [], dict(ZERO_AUX)
        for r in range(0, len(lps), P):
            h, nc, aux = rep(lps[r:r + P], lcs[r:r + P], stage.pattern, cfg,
                             h, positions, mode, decode_pos)
            ncs.extend(nc)
            aux_stage = {k: aux_stage[k] + aux[k] for k in aux_stage}
        new_caches.append({"caches": ncs})
        aux_tot = {k: aux_tot[k] + aux_stage[k] for k in aux_tot}

    logits = logits_fn(p, cfg, h)
    logits = constrain(logits, "batch", "seq", "tensor")
    if cfg.mtp and mode == "train":
        aux_tot["mtp_logits"] = _mtp_logits(p, cfg, h, batch_in, positions)
    return logits, (new_caches if cache is not None else None), aux_tot


def _mtp_logits(p, cfg, h, batch_in, positions):
    """DeepSeek-V3 multi-token prediction: one extra block predicting t+2
    from (h_t, emb(token_{t+1}))."""
    mp = p["mtp"]
    nxt = torch.roll(batch_in["tokens"], -1, dims=1)
    emb = layers.apply_embedding(p["embed"], nxt).to(h.dtype)
    hn = layers.apply_rms_norm(mp["norm_h"], h, cfg.norm_eps)
    en = layers.apply_rms_norm(mp["norm_e"], emb, cfg.norm_eps)
    x = torch.cat([hn, en], dim=-1) @ mp["proj"]
    x, _, _ = apply_layer(mp["layer"], cfg, LayerSpec("attn", "dense"), x,
                          positions, mode="train")
    x = layers.apply_rms_norm(mp["final_norm"], x, cfg.norm_eps)
    return _unembed(p, cfg, x)
