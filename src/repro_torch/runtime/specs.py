"""Input specs and concrete batches for every (architecture x input
shape) pair (the port of the reference package's ``runtime/specs.py``):
``input_specs`` gives ``meta`` tensors for the dry run (the reference's
``jax.ShapeDtypeStruct`` stand-ins), ``concrete_batch`` small batches
for smoke tests and examples with the reference's numpy draws."""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..configs.base import SHAPES, InputShape
from ..device import resolve_device
from ..models import init_cache
from ..models.config import ModelConfig
from ..models.layers import torch_dtype


def make_positions(B, S, device=None):
    return torch.arange(S, dtype=torch.int32,
                        device=resolve_device(device))[None].expand(B, S)


def _train_tree(cfg: ModelConfig, B, S, make):
    act = torch_dtype(cfg.dtype)
    tree: Dict = {}
    if cfg.modality == "audio":
        tree["features"] = make((B, S, cfg.frontend_dim), act)
        tree["labels"] = make((B, S), torch.int32)
        tree["loss_mask"] = make((B, S), torch.float32)
        return tree
    if cfg.modality == "vlm":
        n_img = cfg.n_frontend_tokens
        tree["tokens"] = make((B, S - n_img), torch.int32)
        tree["image_embeds"] = make((B, n_img, cfg.frontend_dim), act)
    else:
        tree["tokens"] = make((B, S), torch.int32)
    tree["labels"] = make((B, S), torch.int32)
    tree["loss_mask"] = make((B, S), torch.float32)
    return tree


def _prefill_tree(cfg: ModelConfig, B, S, make):
    act = torch_dtype(cfg.dtype)
    tree: Dict = {}
    if cfg.modality == "audio":
        tree["features"] = make((B, S, cfg.frontend_dim), act)
    elif cfg.modality == "vlm":
        n_img = cfg.n_frontend_tokens
        tree["tokens"] = make((B, S - n_img), torch.int32)
        tree["image_embeds"] = make((B, n_img, cfg.frontend_dim), act)
    else:
        tree["tokens"] = make((B, S), torch.int32)
    return tree


def input_specs(cfg: ModelConfig, shape: str | InputShape):
    """The step's inputs as ``meta`` tensors (shapes and dtypes, no
    data): the train and prefill batches, and for decode one new token,
    a cache of S positions (``init_cache(..., device="meta")``) and a
    0-d int32 ``decode_pos``."""
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    B, S = sh.global_batch, sh.seq_len
    make = lambda s, d: torch.empty(s, dtype=d, device="meta")
    if sh.kind == "train":
        return _train_tree(cfg, B, S, make)
    if sh.kind == "prefill":
        return _prefill_tree(cfg, B, S, make)
    # decode: one new token against a cache of S positions
    return {
        "tokens": make((B, 1), torch.int32),
        "cache": init_cache(cfg, B, S, device="meta"),
        "decode_pos": make((), torch.int32),
    }


def concrete_batch(cfg: ModelConfig, shape: str | InputShape, seed=0,
                   device=None):
    """Small concrete batch for smoke tests and CPU examples, drawn as the
    reference draws it, on ``device`` (None: ``cuda``)."""
    device = resolve_device(device)
    sh = SHAPES[shape] if isinstance(shape, str) else shape
    B, S = sh.global_batch, sh.seq_len
    rng = np.random.default_rng(seed)

    def make(s, d):
        if not d.is_floating_point:
            hi = max(2, cfg.vocab_size - 1)
            arr = rng.integers(0, hi, size=s)
        else:
            arr = rng.standard_normal(size=s).astype(np.float32)
        return torch.from_numpy(arr).to(device=device, dtype=d)

    if sh.kind == "train":
        tree = _train_tree(cfg, B, S, make)
        tree["loss_mask"] = torch.ones((B, S), dtype=torch.float32,
                                       device=device)
        return tree
    if sh.kind == "prefill":
        return _prefill_tree(cfg, B, S, make)
    return {
        "tokens": make((B, 1), torch.int32),
        "cache": init_cache(cfg, B, S, device=device),
        "decode_pos": S,
    }
