"""Shared building blocks: norms, projections, gated MLP, embeddings (the
port of the reference package's ``models/layers.py``).

Parameters are plain nested dicts of tensors.  Random initialisation
draws from an explicit ``torch.Generator`` on the generator's device; it
does not reproduce the reference's ``jax.random`` draws (to run the
reference's weights use ``models.params_from_numpy``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"``, ...)."""
    return getattr(torch, name)


def truncated_normal(generator: torch.Generator, shape, dtype, stddev):
    """``stddev`` times a standard normal truncated to [-2, 2], drawn in
    float32 on ``generator``'s device and cast to ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (t * stddev).to(dtype)


def dense_init(generator, d_in, d_out, dtype, scale: float = 1.0):
    """Fan-in scaled init for a (d_in, d_out) projection."""
    stddev = scale / np.sqrt(d_in)
    return truncated_normal(generator, (d_in, d_out), dtype, stddev)


def rms_norm(x, weight, eps):
    dt = x.dtype
    x = x.float()
    var = torch.mean(torch.square(x), dim=-1, keepdim=True)
    y = x * torch.rsqrt(var + eps)
    return (y * (1.0 + weight.float())).to(dt)


def init_rms_norm(d, dtype, device):
    # stored as zero-centred so (1 + w) is the effective gain
    return {"scale": torch.zeros((d,), dtype=dtype, device=device)}


def apply_rms_norm(params, x, eps):
    return rms_norm(x, params["scale"], eps)


# ---------------------------------------------------------------- gated MLP
def init_mlp(generator, d_model, d_ff, dtype):
    return {
        "wi_gate": dense_init(generator, d_model, d_ff, dtype),
        "wi_up": dense_init(generator, d_model, d_ff, dtype),
        "wo": dense_init(generator, d_ff, d_model, dtype),
    }


def apply_mlp(params, x):
    gate = F.silu(x @ params["wi_gate"])
    up = x @ params["wi_up"]
    return (gate * up) @ params["wo"]


# ------------------------------------------------------------- embeddings
def pad_vocab(vocab: int, multiple: int = 256) -> int:
    """Pad the vocabulary to a multiple of 256, as the reference does
    for its tensor-parallel unembedding (151936 -> 152064).

    >>> pad_vocab(151936), pad_vocab(122753)
    (152064, 122880)
    """
    return -(-vocab // multiple) * multiple


def init_embedding(generator, vocab, d_model, dtype):
    # 1/sqrt(d) keeps tied-embedding logits O(1) at init
    return {"table": truncated_normal(generator, (pad_vocab(vocab), d_model),
                                      dtype, d_model ** -0.5)}


def apply_embedding(params, ids):
    """Rows ``ids`` of the table.  ``F.embedding``, not indexing: the two
    gather alike, but indexing's backward (``index_put_`` accumulating)
    adds a repeated id's rows in an order that changes from run to run
    on the CPU, where the embedding's backward adds them in a fixed
    order."""
    return F.embedding(ids, params["table"])


def init_unembed(generator, d_model, vocab, dtype):
    return {"w": dense_init(generator, d_model, pad_vocab(vocab), dtype)}


def apply_unembed(params, x):
    return x @ params["w"]


def cross_entropy(logits, labels, mask=None):
    """Mean token cross-entropy in f32. labels: int ids, mask: optional
    0/1; the masked mean divides by ``max(sum(mask), 1)``."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return torch.mean(nll)
    mask = mask.float()
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
