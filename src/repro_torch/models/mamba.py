"""Mamba (S6) mixer for the Jamba hybrid (the port of the reference
package's ``models/mamba.py``).

The recurrence ``h_t = Ā_t h_{t-1} + B̄_t x_t`` runs in fixed-size time
chunks of ``CHUNK`` steps (the reference's precondition
``T % min(CHUNK, T) == 0`` holds here too), the state carried from chunk
to chunk.  Inside a chunk it is a log-depth inclusive scan of the
reference's combine ``(a1, b1), (a2, b2) -> (a1 a2, b1 a2 + b2)``, in
float32 (Hillis–Steele: log2(chunk) passes over the chunk; the
reference's ``jax.lax.associative_scan`` takes another tree, so the two
round differently in the last bits).  The depthwise causal conv is
``F.conv1d`` with one group a channel, the reference's XLA conv.
``A_log`` and ``Dskip`` stay float32 in a bf16 model.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import layers
from .config import MambaConfig, ModelConfig

CHUNK = 256


def _dims(cfg: ModelConfig):
    m: MambaConfig = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = m.dt_rank or -(-cfg.d_model // 16)
    return m, d_inner, dt_rank


def init_mamba(generator, cfg: ModelConfig):
    m, di, dtr = _dims(cfg)
    dt = layers.torch_dtype(cfg.param_dtype)
    dev = generator.device
    A = torch.arange(1, m.d_state + 1, dtype=torch.float32,
                     device=dev)[None, :].repeat(di, 1)
    dt_init = 1e-3 + (1e-1 - 1e-3) * torch.rand(
        (di,), generator=generator, device=dev)
    return {
        "in_proj": layers.dense_init(generator, cfg.d_model, 2 * di, dt),
        "conv_w": layers.truncated_normal(generator, (m.d_conv, di), dt,
                                          1.0 / np.sqrt(m.d_conv)),
        "conv_b": torch.zeros((di,), dtype=dt, device=dev),
        "x_proj": layers.dense_init(generator, di, dtr + 2 * m.d_state, dt),
        "dt_w": layers.dense_init(generator, dtr, di, dt),
        "dt_b": torch.log(torch.expm1(dt_init)).to(dt),
        "A_log": torch.log(A),
        "Dskip": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": layers.dense_init(generator, di, cfg.d_model, dt),
    }


def init_mamba_cache(cfg: ModelConfig, batch, dtype, device):
    m, di, _ = _dims(cfg)
    return {
        "conv": torch.zeros((batch, m.d_conv - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, m.d_state), dtype=torch.float32,
                           device=device),
    }


def _causal_conv(x, w, b, d_conv):
    """x: (B,T,di) depthwise causal conv along T, in x's dtype."""
    di = x.shape[-1]
    kernel = w.to(x.dtype).T.reshape(di, 1, d_conv)
    y = F.conv1d(F.pad(x.transpose(1, 2), (d_conv - 1, 0)), kernel,
                 groups=di).transpose(1, 2)
    return y + b.to(y.dtype)


def _ssm_inputs(p, cfg, x_c):
    """x_c: (..., di) -> Ā, Bx, C  (f32)."""
    m, di, dtr = _dims(cfg)
    proj = x_c @ p["x_proj"]
    dt_in, B, C = torch.split(proj, [dtr, m.d_state, m.d_state], dim=-1)
    dt = F.softplus((dt_in @ p["dt_w"]).float()
                    + p["dt_b"].float())                  # (..., di)
    A = -torch.exp(p["A_log"])                            # (di, ds)
    A_bar = torch.exp(dt[..., None] * A)                  # (..., di, ds)
    Bx = (dt * x_c.float())[..., None] * \
        B.float()[..., None, :]                           # (..., di, ds)
    return A_bar, Bx, C.float()


def _scan_chunk(A_bar, Bx, h0):
    """Inclusive scan over axis 1 of (B, chunk, di, ds) given the entry
    state h0 (B, di, ds): every h_t and the last."""
    a, b = A_bar, Bx
    off = 1
    while off < a.shape[1]:
        # element t composed after element t - off: (a', b') o (a, b)
        # = (a' a, b' a + b)
        a_new = torch.cat([a[:, :off], a[:, :-off] * a[:, off:]], 1)
        b = torch.cat([b[:, :off], b[:, :-off] * a[:, off:] + b[:, off:]], 1)
        a = a_new
        off *= 2
    h = a * h0[:, None] + b                               # (B,chunk,di,ds)
    return h, h[:, -1]


def apply_mamba(p, cfg: ModelConfig, x, mode="train", cache=None):
    """x: (B,T,d). Returns (y, new_cache)."""
    m, di, _ = _dims(cfg)
    B, T, _ = x.shape
    if mode == "decode":
        return _decode_step(p, cfg, x, cache)

    xz = x @ p["in_proj"]
    x_in, z = torch.chunk(xz, 2, dim=-1)
    x_c = F.silu(_causal_conv(x_in, p["conv_w"], p["conv_b"], m.d_conv))

    chunk = min(CHUNK, T)
    if T % chunk:
        raise ValueError(f"mamba: T={T} is not a multiple of the chunk "
                         f"{chunk}")
    h = torch.zeros((B, di, m.d_state), dtype=torch.float32, device=x.device)
    ys = []
    for s in range(0, T, chunk):
        A_bar, Bx, C = _ssm_inputs(p, cfg, x_c[:, s:s + chunk])
        h_seq, h = _scan_chunk(A_bar, Bx, h)
        ys.append(torch.einsum("btds,bts->btd", h_seq, C).to(x.dtype))
    y = torch.cat(ys, 1)
    y = y + p["Dskip"].to(x.dtype) * x_c
    y = y * F.silu(z)
    out = y @ p["out_proj"]

    new_cache = None
    if mode == "prefill":
        pad = torch.zeros((B, max(0, m.d_conv - 1 - T), di),
                          dtype=x_in.dtype, device=x.device)
        conv_tail = torch.cat([pad, x_in[:, -(m.d_conv - 1):]], 1)
        new_cache = {"conv": conv_tail, "ssm": h}
    return out, new_cache


def _carry(cache, window, h):
    """The decode step's next cache: the conv window shifted by the new
    token, and the new SSM state (the seam chip_smoke's planted faults
    replace)."""
    return {"conv": window[:, 1:], "ssm": h}


def _decode_step(p, cfg, x, cache):
    m, di, _ = _dims(cfg)
    xz = x[:, 0] @ p["in_proj"]                           # (B, 2di)
    x_in, z = torch.chunk(xz, 2, dim=-1)
    window = torch.cat([cache["conv"], x_in[:, None]], 1)
    conv = torch.einsum("btd,td->bd", window.float(),
                        p["conv_w"].float()) + p["conv_b"]
    x_c = F.silu(conv).to(x.dtype)                        # (B, di)
    A_bar, Bx, C = _ssm_inputs(p, cfg, x_c)               # (B, di, ds)
    h = A_bar * cache["ssm"] + Bx
    y = torch.einsum("bds,bs->bd", h, C).to(x.dtype)
    y = y + p["Dskip"].to(x.dtype) * x_c
    y = y * F.silu(z)
    out = (y @ p["out_proj"])[:, None]
    return out, _carry(cache, window, h)
