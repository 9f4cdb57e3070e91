"""Attention mixers: GQA (full / sliding-window) with optional qk-norm,
and DeepSeek-style MLA (multi-head latent attention with a compressed KV
cache) (the port of the reference package's ``models/attention.py``).

Three execution modes share one code path:
  train   — full sequence, no cache
  prefill — full sequence, returns a populated KV cache
  decode  — single new token against an existing cache

Caches are position-indexed ring buffers of length ``cache_len`` (= the
sliding window for SWA variants, else the max sequence length).  As in
the reference, attention is plain tensor code here (``sdpa`` and the
chunked online softmax of ``_sdpa_chunked``), not the flash or decode
kernels of ``repro_torch.kernels``.  Scores are taken in float32 and the
probabilities cast back to the query dtype.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import checkpoint

from . import layers
from .config import LayerSpec, MLAConfig, ModelConfig
from .rope import apply_rope, yarn_mscale

NEG_INF = -1e30


# --------------------------------------------------------------------- core
Q_CHUNK, K_CHUNK = 512, 1024


def sdpa(q, k, v, mask, scale):
    """q:(B,T,H,D) k/v:(B,S,KV,D) mask:(B,1,T,S) bool -> (B,T,H,D).

    Plain scaled-dot-product attention.  With fewer KV heads than query
    heads the query heads are grouped; K/V are never repeated."""
    B, T, H, D = q.shape
    KV = k.shape[2]
    if KV != H:
        G = H // KV
        qg = q.reshape(B, T, KV, G, D)
        s = torch.einsum("btkgd,bskd->bkgts", qg, k).float()
        s = torch.where(mask[:, None], s * scale, NEG_INF)
        p = torch.softmax(s, dim=-1).to(q.dtype)
        out = torch.einsum("bkgts,bskd->btkgd", p, v)
        return out.reshape(B, T, H, D)
    scores = torch.einsum("bthd,bshd->bhts", q, k).float() * scale
    scores = torch.where(mask, scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("bhts,bshd->bthd", probs, v)


def sdpa_masked(q, k, v, q_pos, k_pos, causal, window, k_valid, scale):
    """Dispatch: the chunked online softmax (O(chunk^2) temporary memory
    instead of O(T*S)) for long sequences, ``sdpa`` for short sequences
    and decode.  The chunked path builds its masks per chunk from
    positions, never at (T, S)."""
    T, S = q.shape[1], k.shape[1]
    if (T >= 2 * Q_CHUNK and S >= 2 * K_CHUNK and T % Q_CHUNK == 0
            and S % K_CHUNK == 0 and k_valid is None):
        return _sdpa_chunked(q, k, v, q_pos, k_pos, causal, window, scale)
    mask = make_mask(q_pos, k_pos, causal, window, k_valid)
    return sdpa(q, k, v, mask, scale)


def _sdpa_chunked(q, k, v, q_pos, k_pos, causal, window, scale):
    """Online softmax over (Q_CHUNK, K_CHUNK) tiles, float32 running max,
    sum and accumulator, the query heads grouped over the KV heads.
    Where grad is enabled each key tile is recomputed in backward
    (``torch.utils.checkpoint``, as the reference's ``jax.checkpoint``
    on its ``kv_step``): autograd keeps a tile's inputs and the running
    (m, l, acc), never its (Q_CHUNK, K_CHUNK) scores, so backward holds
    O(chunk^2) of them at a time, not O(T*S).  Forward values are the
    same either way."""
    B, T, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    Dv = v.shape[-1]
    G = H // KV
    step = _kv_step
    if torch.is_grad_enabled():
        step = functools.partial(checkpoint, _kv_step, use_reentrant=False,
                                 preserve_rng_state=False)  # draws nothing
    outs = []
    for qs in range(0, T, Q_CHUNK):
        qb = q[:, qs:qs + Q_CHUNK].reshape(B, Q_CHUNK, KV, G, D)
        qpb = q_pos[:, qs:qs + Q_CHUNK]
        m = torch.full((B, KV, G, Q_CHUNK), NEG_INF, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros((B, KV, G, Q_CHUNK), dtype=torch.float32,
                        device=q.device)
        acc = torch.zeros((B, KV, G, Q_CHUNK, Dv), dtype=torch.float32,
                          device=q.device)
        for ks in range(0, S, K_CHUNK):
            m, l, acc = step(qb, k[:, ks:ks + K_CHUNK], v[:, ks:ks + K_CHUNK],
                             qpb, k_pos[:, ks:ks + K_CHUNK], m, l, acc,
                             causal, window, scale)
        out = acc / torch.clamp(l, min=1e-30)[..., None]
        # (B,KV,G,Tq,Dv) -> (B,Tq,KV,G,Dv)
        outs.append(out.permute(0, 3, 1, 2, 4).to(q.dtype))
    return torch.cat(outs, dim=1).reshape(B, T, H, Dv)


def _kv_step(qb, kb, vb, qpb, kpb, m, l, acc, causal, window, scale):
    """One key tile of the online softmax: the running (m, l, acc) after
    the scores of ``qb`` against ``kb``."""
    s = torch.einsum("btkgd,bskd->bkgts", qb, kb).float() * scale
    msk = make_mask(qpb, kpb, causal, window)
    s = torch.where(msk[:, None], s, NEG_INF)
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    corr = torch.exp(m - m_new)
    l = l * corr + p.sum(dim=-1)
    acc = acc * corr[..., None] + torch.einsum(
        "bkgts,bskd->bkgtd", p, vb.float())
    return m_new, l, acc


def make_mask(q_pos, k_pos, causal, window, k_valid=None):
    """q_pos:(B,T) k_pos:(B,S) -> bool (B,1,T,S)."""
    q = q_pos[:, None, :, None]
    k = k_pos[:, None, None, :]
    m = torch.ones(torch.broadcast_shapes(q.shape, k.shape), dtype=torch.bool,
                   device=q_pos.device)
    if causal:
        m = m & (k <= q)
    if window is not None:
        m = m & ((q - k) < window)
    if k_valid is not None:
        m = m & k_valid[:, None, None, :]
    return m


# ------------------------------------------------------------------ GQA
def init_gqa(generator, cfg: ModelConfig):
    H, KV, D, dm = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_model
    dt = layers.torch_dtype(cfg.param_dtype)
    p = {
        "wq": layers.dense_init(generator, dm, H * D, dt),
        "wk": layers.dense_init(generator, dm, KV * D, dt),
        "wv": layers.dense_init(generator, dm, KV * D, dt),
        "wo": layers.dense_init(generator, H * D, dm, dt),
    }
    if cfg.qk_norm:
        p["q_norm"] = layers.init_rms_norm(D, dt, generator.device)
        p["k_norm"] = layers.init_rms_norm(D, dt, generator.device)
    return p


def init_gqa_cache(cfg: ModelConfig, spec: LayerSpec, batch, cache_len,
                   dtype, device):
    KV, D = cfg.n_kv_heads, cfg.head_dim
    win = spec.window or cfg.decode_window
    L = min(cache_len, win) if win else cache_len
    return {
        "k": torch.zeros((batch, L, KV, D), dtype=dtype, device=device),
        "v": torch.zeros((batch, L, KV, D), dtype=dtype, device=device),
    }


def _ring_positions(cache_len, next_pos, device=None):
    """Positions stored at each ring slot after ``next_pos`` tokens have been
    written (token i lives at slot i % cache_len).  Slot s holds the largest
    position p < next_pos with p ≡ s (mod cache_len).  ``next_pos`` is an
    int or a 0-d tensor on ``device``."""
    slots = torch.arange(cache_len, dtype=torch.int64, device=device)
    last = next_pos - 1
    k_pos = last - torch.remainder(last - slots, cache_len)
    return k_pos, k_pos >= 0


def apply_gqa(p, cfg: ModelConfig, spec: LayerSpec, x, positions,
              mode="train", cache=None, decode_pos=None):
    B, T, _ = x.shape
    H, KV, D = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, T, H, D)
    k = (x @ p["wk"]).reshape(B, T, KV, D)
    v = (x @ p["wv"]).reshape(B, T, KV, D)
    if cfg.qk_norm:
        q = layers.rms_norm(q, p["q_norm"]["scale"], cfg.norm_eps)
        k = layers.rms_norm(k, p["k_norm"]["scale"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta, cfg.rope)
    k = apply_rope(k, positions, cfg.rope_theta, cfg.rope)
    scale = D ** -0.5
    window = spec.window or (cfg.decode_window if mode != "train"
                             else spec.window)

    new_cache = None
    if mode in ("train", "prefill"):
        out = sdpa_masked(q, k, v, positions, positions, cfg.causal,
                          window, None, scale)
        if mode == "prefill":
            new_cache = _fill_cache(cache, k, v, T)
    else:  # decode: T == 1, append at decode_pos then attend over the ring
        L = cache["k"].shape[1]
        new_cache = _write_ring(cache, k, v, decode_pos % L)
        ck, cv = new_cache["k"], new_cache["v"]
        k_pos, valid = _ring_positions(L, decode_pos + 1, x.device)
        k_pos = k_pos[None].expand(B, L)
        valid = valid[None].expand(B, L)
        out = sdpa_masked(q, ck, cv, positions, k_pos, cfg.causal, window,
                          valid, scale)

    y = out.reshape(B, T, H * D) @ p["wo"]
    return y, new_cache


def _write_ring(cache, k, v, slot):
    """A copy of the ring with the decode token's K/V at ``slot``."""
    return {"k": _put(cache["k"].clone(), k, slot),
            "v": _put(cache["v"].clone(), v, slot)}


def _put(ring, new, slot):
    """``ring`` with ``new`` (B, 1, ...) written at ``slot`` on axis 1: a
    slice for an int, ``index_copy_`` for a 0-d device tensor (no host
    read, so a CUDA graph can capture it)."""
    if isinstance(slot, torch.Tensor):
        return ring.index_copy_(1, slot.reshape(1), new)
    ring[:, slot:slot + 1] = new
    return ring


def _fill_cache(cache, k, v, T):
    """Write the last ``cache_len`` of the prefill K/V into the ring so that
    token i sits at slot i %% cache_len (matching decode's ring indexing)."""
    L = cache["k"].shape[1]
    if T <= L:
        ck, cv = cache["k"].clone(), cache["v"].clone()
        ck[:, :T] = k
        cv[:, :T] = v
        return {"k": ck, "v": cv}
    # keep the trailing window, placed at its ring slots
    shift = (T - L) % L
    return {"k": torch.roll(k[:, T - L:], shift, dims=1),
            "v": torch.roll(v[:, T - L:], shift, dims=1)}


# ------------------------------------------------------------------ MLA
def init_mla(generator, cfg: ModelConfig):
    m: MLAConfig = cfg.mla
    H, dm = cfg.n_heads, cfg.d_model
    dt = layers.torch_dtype(cfg.param_dtype)
    dev = generator.device
    qk_dim = m.qk_nope_dim + m.qk_rope_dim
    return {
        "wq_a": layers.dense_init(generator, dm, m.q_lora_rank, dt),
        "q_norm": layers.init_rms_norm(m.q_lora_rank, dt, dev),
        "wq_b": layers.dense_init(generator, m.q_lora_rank, H * qk_dim, dt),
        "wkv_a": layers.dense_init(generator, dm,
                                   m.kv_lora_rank + m.qk_rope_dim, dt),
        "kv_norm": layers.init_rms_norm(m.kv_lora_rank, dt, dev),
        "wk_b": layers.dense_init(generator, m.kv_lora_rank,
                                  H * m.qk_nope_dim, dt),
        "wv_b": layers.dense_init(generator, m.kv_lora_rank,
                                  H * m.v_head_dim, dt),
        "wo": layers.dense_init(generator, H * m.v_head_dim, dm, dt),
    }


def init_mla_cache(cfg: ModelConfig, spec: LayerSpec, batch, cache_len,
                   dtype, device):
    m = cfg.mla
    win = spec.window or cfg.decode_window
    L = min(cache_len, win) if win else cache_len
    return {
        "ckv": torch.zeros((batch, L, m.kv_lora_rank), dtype=dtype,
                           device=device),
        "kpe": torch.zeros((batch, L, m.qk_rope_dim), dtype=dtype,
                           device=device),
    }


def _mla_expand(p, cfg, ckv):
    """ckv:(B,S,r) -> k_nope:(B,S,H,nope), v:(B,S,H,v_dim)."""
    m, H = cfg.mla, cfg.n_heads
    B, S, _ = ckv.shape
    k_nope = (ckv @ p["wk_b"]).reshape(B, S, H, m.qk_nope_dim)
    v = (ckv @ p["wv_b"]).reshape(B, S, H, m.v_head_dim)
    return k_nope, v


def mla_softmax_scale(cfg: ModelConfig) -> float:
    """``qk_dim ** -0.5``, times YaRN's ``mscale ** 2`` where the
    configuration scales its rotary positions with ``mscale_all_dim``
    (DeepSeek-V3: ``192 ** -0.5 * (0.1 ln 40 + 1) ** 2``), in prefill and
    in the absorbed decode alike."""
    m, y = cfg.mla, cfg.rope_scaling
    scale = (m.qk_nope_dim + m.qk_rope_dim) ** -0.5
    if y is not None and y.mscale_all_dim:
        scale = scale * yarn_mscale(y.factor, y.mscale_all_dim) ** 2
    return scale


def apply_mla(p, cfg: ModelConfig, spec: LayerSpec, x, positions,
              mode="train", cache=None, decode_pos=None):
    m, H = cfg.mla, cfg.n_heads
    B, T, _ = x.shape
    qk_dim = m.qk_nope_dim + m.qk_rope_dim

    q_lat = layers.rms_norm(x @ p["wq_a"], p["q_norm"]["scale"],
                            cfg.norm_eps)
    q = (q_lat @ p["wq_b"]).reshape(B, T, H, qk_dim)
    q_nope, q_pe = q[..., :m.qk_nope_dim], q[..., m.qk_nope_dim:]
    q_pe = apply_rope(q_pe, positions, cfg.rope_theta, "full",
                      cfg.rope_scaling)
    q = torch.cat([q_nope, q_pe], dim=-1)

    kv = x @ p["wkv_a"]
    ckv = layers.rms_norm(kv[..., :m.kv_lora_rank], p["kv_norm"]["scale"],
                          cfg.norm_eps)
    kpe = kv[..., m.kv_lora_rank:][:, :, None, :]       # single shared head
    kpe = apply_rope(kpe, positions, cfg.rope_theta, "full",
                     cfg.rope_scaling)[:, :, 0]

    scale = mla_softmax_scale(cfg)
    window = spec.window or (cfg.decode_window if mode != "train" else None)

    new_cache = None
    if mode in ("train", "prefill"):
        k_nope, v = _mla_expand(p, cfg, ckv)
        k = torch.cat([k_nope, kpe[:, :, None].expand(B, T, H,
                                                      m.qk_rope_dim)],
                      dim=-1)
        out = sdpa_masked(q, k, v, positions, positions, cfg.causal,
                          window, None, scale)
        if mode == "prefill":
            new_cache = _fill_mla_cache(cache, ckv, kpe, T)
    else:
        # weight-absorbed MLA decode: attention runs in the compressed
        # kv_lora space (W_kb absorbed into the query, W_vb into the
        # output), so the (L, H, nope + v) expansion of the cache never
        # materializes.  Scores, probabilities and context in float32.
        L = cache["ckv"].shape[1]
        new_cache = _write_latent(cache, ckv, kpe, decode_pos % L)
        cckv, ckpe = new_cache["ckv"], new_cache["kpe"]
        wk_b = p["wk_b"].reshape(m.kv_lora_rank, H, m.qk_nope_dim)
        wv_b = p["wv_b"].reshape(m.kv_lora_rank, H, m.v_head_dim)
        q_abs = torch.einsum("bthn,rhn->bthr", q_nope, wk_b)   # (B,1,H,r)
        s = torch.einsum("bthr,bsr->bhts", q_abs.float(), cckv.float())
        s = s + torch.einsum("bthp,bsp->bhts", q_pe.float(), ckpe.float())
        s = s * scale
        k_pos, valid = _ring_positions(L, decode_pos + 1, x.device)
        k_pos = k_pos[None].expand(B, L)
        valid = valid[None].expand(B, L)
        mask = make_mask(positions, k_pos, cfg.causal, window, valid)
        s = torch.where(mask, s, NEG_INF)
        prob = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhts,bsr->bthr", prob, cckv.float())
        out = torch.einsum("bthr,rhv->bthv", ctx,
                           wv_b.float()).to(x.dtype)

    y = out.reshape(B, T, H * m.v_head_dim) @ p["wo"]
    return y, new_cache


def _write_latent(cache, ckv, kpe, slot):
    """A copy of the latent ring with the decode token's compressed KV
    and rope key at ``slot``."""
    return {"ckv": _put(cache["ckv"].clone(), ckv, slot),
            "kpe": _put(cache["kpe"].clone(), kpe, slot)}


def _fill_mla_cache(cache, ckv, kpe, T):
    L = cache["ckv"].shape[1]
    if T <= L:
        cckv, ckpe = cache["ckv"].clone(), cache["kpe"].clone()
        cckv[:, :T] = ckv
        ckpe[:, :T] = kpe
        return {"ckv": cckv, "kpe": ckpe}
    shift = (T - L) % L
    return {"ckv": torch.roll(ckv[:, T - L:], shift, dims=1),
            "kpe": torch.roll(kpe[:, T - L:], shift, dims=1)}


# ------------------------------------------------------------------ facade
def init_attention(generator, cfg: ModelConfig):
    return init_mla(generator, cfg) if cfg.mla else init_gqa(generator, cfg)


def init_attention_cache(cfg, spec, batch, cache_len, dtype, device):
    if cfg.mla:
        return init_mla_cache(cfg, spec, batch, cache_len, dtype, device)
    return init_gqa_cache(cfg, spec, batch, cache_len, dtype, device)


def apply_attention(p, cfg, spec, x, positions, mode="train", cache=None,
                    decode_pos=None):
    fn = apply_mla if cfg.mla else apply_gqa
    return fn(p, cfg, spec, x, positions, mode=mode, cache=cache,
              decode_pos=decode_pos)
