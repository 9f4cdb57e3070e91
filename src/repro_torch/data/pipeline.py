"""Synthetic data pipeline (the port of the reference package's
``data/pipeline.py``): a deterministic, learnable token stream (a k-th
order Markov chain over a Zipf vocabulary, so a model with capacity can
drive its loss well below the unigram entropy), plus modality batches
(audio frames / vision patches) for the stub-frontend architectures.

The draws are numpy's, as in the reference, so the same seed gives the
same tokens, features and masks in both packages.  Token ids and labels
are int32, the reference's dtype: the model indexes its embedding with
them as they are, and ``models.layers.cross_entropy`` widens the labels
to int64 for ``torch.gather``.  Masks are float32; features take the
config's activation dtype.  Every batch is placed on ``device`` (None:
``cuda``, raising where no CUDA device exists).
"""
from __future__ import annotations

from typing import Dict, Iterator

import numpy as np
import torch

from ..device import resolve_device
from ..models.config import ModelConfig
from ..models.layers import torch_dtype


def synthetic_corpus(vocab: int, n_tokens: int, seed: int = 0,
                     order: int = 2) -> np.ndarray:
    """Markov chain: next token = f(prev tokens) with learnable structure
    (deterministic transitions 85% of the time, Zipf noise otherwise)."""
    rng = np.random.default_rng(seed)
    # deterministic transition table over the last `order` tokens, so a
    # model with >= order context can drive loss toward the 15% noise floor
    table = rng.integers(0, vocab, size=4096)
    zipf = rng.zipf(1.4, size=n_tokens).clip(1, vocab - 1)
    out = np.empty(n_tokens, np.int32)
    ctx = [1] * order
    for i in range(n_tokens):
        if rng.random() < 0.85:
            h = 0
            for t in ctx:
                h = h * 8191 + t
            out[i] = table[h % 4096]
        else:
            out[i] = zipf[i]
        ctx = ctx[1:] + [int(out[i])]
    return out


class LMBatchIterator:
    """Yields {tokens, labels, loss_mask} batches for causal LM training,
    on ``device``."""

    def __init__(self, cfg: ModelConfig, batch: int, seq: int,
                 seed: int = 0, n_tokens: int = 0, device=None):
        self.device = resolve_device(device)
        self.cfg, self.batch, self.seq = cfg, batch, seq
        need = n_tokens or (batch * (seq + 1) * 64)
        self.corpus = synthetic_corpus(min(cfg.vocab_size, 32768), need,
                                       seed=seed)
        self.rng = np.random.default_rng(seed + 1)

    def __iter__(self) -> Iterator[Dict]:
        while True:
            starts = self.rng.integers(
                0, len(self.corpus) - self.seq - 1, size=self.batch)
            tok = np.stack([self.corpus[s:s + self.seq] for s in starts])
            lab = np.stack([self.corpus[s + 1:s + self.seq + 1]
                            for s in starts])
            yield {
                "tokens": torch.from_numpy(tok).to(self.device),
                "labels": torch.from_numpy(lab).to(self.device),
                "loss_mask": torch.ones((self.batch, self.seq),
                                        dtype=torch.float32,
                                        device=self.device),
            }


def make_lm_batches(cfg, batch, seq, n, seed=0, device=None):
    it = iter(LMBatchIterator(cfg, batch, seq, seed, device=device))
    return [next(it) for _ in range(n)]


def make_modality_batch(cfg: ModelConfig, batch: int, seq: int,
                        seed: int = 0, device=None) -> Dict:
    """Train batch for audio (frame features) / vlm (patch embeddings)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    act = torch_dtype(cfg.dtype)

    def put(a, dtype):
        return torch.from_numpy(np.asarray(a)).to(device=device, dtype=dtype)

    out: Dict = {}
    if cfg.modality == "audio":
        out["features"] = put(
            rng.standard_normal((batch, seq, cfg.frontend_dim)), act)
        out["labels"] = put(
            rng.integers(0, cfg.vocab_size, (batch, seq)), torch.int32)
        mask = rng.random((batch, seq)) < 0.35        # masked-unit targets
        out["loss_mask"] = put(mask, torch.float32)
        return out
    if cfg.modality == "vlm":
        n_img = min(cfg.n_frontend_tokens, seq // 2)
        out["image_embeds"] = put(
            rng.standard_normal((batch, n_img, cfg.frontend_dim)), act)
        out["tokens"] = put(
            rng.integers(0, cfg.vocab_size, (batch, seq - n_img)),
            torch.int32)
        out["labels"] = put(
            rng.integers(0, cfg.vocab_size, (batch, seq)), torch.int32)
        mask = np.zeros((batch, seq), np.float32)
        mask[:, n_img:] = 1.0                         # loss on text only
        out["loss_mask"] = put(mask, torch.float32)
        return out
    raise ValueError(cfg.modality)
