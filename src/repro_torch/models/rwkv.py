"""RWKV-6 ("Finch") mixer and channel mix — data-dependent per-channel
decay, attention-free (the port of the reference package's
``models/rwkv.py``).

The recurrence per head (k/v head size ``hs``):

    out_t = r_t^T (S_{t-1} + diag(u) k_t v_t^T)
    S_t   = diag(w_t) S_{t-1} + k_t v_t^T        w_t = exp(-exp(w0 + lora(x)))

As in the reference, the model computes it with its own plain loop over
T in float32 (the reference's ``lax.scan``), not with the scan kernel of
``repro_torch.kernels``; the reference's chunk precondition
``T % min(CHUNK, T) == 0`` is kept.  ``w0`` and ``u`` stay float32
in a bf16 model.  Two reference behaviours are kept as they are: the
prefill's token shift starts from zero whatever ``cache["tm_shift"]``
holds, while its state starts from ``cache["wkv"]``; and the channel
mix seeds its shift from the cache only in decode.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from . import layers
from .config import ModelConfig, RWKVConfig

CHUNK = 64


def _dims(cfg: ModelConfig):
    r: RWKVConfig = cfg.rwkv
    H = cfg.d_model // r.head_size
    return r, H, r.head_size


def init_rwkv(generator, cfg: ModelConfig):
    r, H, hs = _dims(cfg)
    d = cfg.d_model
    dt = layers.torch_dtype(cfg.param_dtype)
    dev = generator.device

    def full(v, dtype=dt):
        return torch.full((d,), v, dtype=dtype, device=dev)

    return {
        "mu_r": full(0.5), "mu_k": full(0.5), "mu_v": full(0.5),
        "mu_w": full(0.5), "mu_g": full(0.5),
        "wr6": layers.dense_init(generator, d, d, dt),
        "wk6": layers.dense_init(generator, d, d, dt),
        "wv6": layers.dense_init(generator, d, d, dt),
        "wg6": layers.dense_init(generator, d, d, dt),
        "wo6": layers.dense_init(generator, d, d, dt),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x_w @ w1) @ w2))
        "w0": full(-1.0, torch.float32),
        "lora_w1": layers.dense_init(generator, d, r.decay_lora, dt),
        "lora_w2": layers.dense_init(generator, r.decay_lora, d, dt,
                                     scale=0.1),
        "u": layers.truncated_normal(generator, (H, hs), torch.float32, 0.5),
        "ln_scale": full(1.0), "ln_bias": full(0.0),
    }


def init_rwkv_cache(cfg: ModelConfig, batch, dtype, device):
    r, H, hs = _dims(cfg)
    return {
        "tm_shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                device=device),
        "wkv": torch.zeros((batch, H, hs, hs), dtype=torch.float32,
                           device=device),
    }


def _shift(x, last=None):
    """x: (B,T,d) -> previous-token tensor, optionally seeded by `last`."""
    first = torch.zeros_like(x[:, :1]) if last is None else last[:, None]
    return torch.cat([first, x[:, :-1]], 1)


def _mix(x, x_prev, mu):
    return x + (x_prev - x) * mu


def _decay(p, xw):
    logw = -torch.exp(p["w0"] + (torch.tanh(xw @ p["lora_w1"])
                                 @ p["lora_w2"]).float())
    return torch.exp(logw)                                # in (0, 1)


def _head_norm(p, out, B, T, d):
    out = out.reshape(B, T, d)
    mean = out.mean(-1, keepdim=True)
    var = out.var(-1, keepdim=True, correction=0)
    out = (out - mean) * torch.rsqrt(var + 1e-5)
    return out * p["ln_scale"] + p["ln_bias"]


def _projections(p, x, x_prev, shape):
    """r, k, v (float32), g and the decay w of the mixed inputs."""
    xr, xk, xv, xw, xg = (_mix(x, x_prev, p[f"mu_{c}"]) for c in "rkvwg")
    r = (xr @ p["wr6"]).reshape(shape).float()
    k = (xk @ p["wk6"]).reshape(shape).float()
    v = (xv @ p["wv6"]).reshape(shape).float()
    g = F.silu(xg @ p["wg6"])
    w = _decay(p, xw).reshape(shape)
    return r, k, v, g, w


def _step(S, r_t, k_t, v_t, w_t, u):
    """One step of the recurrence on (B,H,hs) inputs and the (B,H,hs,hs)
    state: (out_t, S_t)."""
    kv = k_t[..., :, None] * v_t[..., None, :]            # (B,H,hs,hs)
    out = torch.einsum("bhk,bhkv->bhv", r_t, S + u[None, :, :, None] * kv)
    return out, w_t[..., :, None] * S + kv


def _recurrence(r, k, v, w, u, S):
    """The recurrence over T, one ``_step`` a token: (B,T,H,hs) inputs
    and the entry state -> (out (B,T,H,hs) float32, the last state)."""
    outs = []
    for t in range(r.shape[1]):
        o, S = _step(S, r[:, t], k[:, t], v[:, t], w[:, t], u)
        outs.append(o)
    return torch.stack(outs, 1), S


def apply_rwkv(p, cfg: ModelConfig, x, mode="train", cache=None):
    r_cfg, H, hs = _dims(cfg)
    B, T, d = x.shape
    if mode == "decode":
        return _decode_step(p, cfg, x, cache)

    r, k, v, g, w = _projections(p, x, _shift(x), (B, T, H, hs))
    chunk = min(CHUNK, T)
    if T % chunk:
        raise ValueError(f"rwkv: T={T} is not a multiple of the chunk "
                         f"{chunk}")
    S = (torch.zeros((B, H, hs, hs), dtype=torch.float32, device=x.device)
         if cache is None else cache["wkv"])
    out, S = _recurrence(r, k, v, w, p["u"], S)
    out = out.reshape(B, T, H * hs)

    out = _head_norm(p, out.to(x.dtype), B, T, d) * g
    y = out @ p["wo6"]

    new_cache = None
    if mode == "prefill":
        new_cache = {"tm_shift": x[:, -1], "wkv": S}
    return y, new_cache


def _carry(cache, xt, S):
    """The decode step's next cache: the token for the next shift and the
    new state (the seam chip_smoke's planted faults replace)."""
    return {"tm_shift": xt, "wkv": S}


def _decode_step(p, cfg, x, cache):
    r_cfg, H, hs = _dims(cfg)
    B, _, d = x.shape
    xt = x[:, 0]
    r, k, v, g, w = _projections(p, xt, cache["tm_shift"], (B, H, hs))
    out, S = _step(cache["wkv"], r, k, v, w, p["u"])
    out = _head_norm(p, out.reshape(B, 1, d).to(x.dtype), B, 1, d) * \
        g[:, None]
    y = out @ p["wo6"]
    return y, _carry(cache, xt, S)


# ----------------------------------------------------------- channel mix
def init_rwkv_cmix(generator, cfg: ModelConfig):
    d, f = cfg.d_model, cfg.d_ff
    dt = layers.torch_dtype(cfg.param_dtype)
    dev = generator.device
    return {
        "mu_ck": torch.full((d,), 0.5, dtype=dt, device=dev),
        "mu_cr": torch.full((d,), 0.5, dtype=dt, device=dev),
        "wk_c": layers.dense_init(generator, d, f, dt),
        "wv_c": layers.dense_init(generator, f, d, dt),
        "wr_c": layers.dense_init(generator, d, d, dt),
    }


def init_cmix_cache(cfg: ModelConfig, batch, dtype, device):
    return {"cm_shift": torch.zeros((batch, cfg.d_model), dtype=dtype,
                                    device=device)}


def apply_rwkv_cmix(p, cfg: ModelConfig, x, mode="train", cache=None):
    if mode != "decode":
        x_prev = _shift(x)
    else:
        x_prev = cache["cm_shift"][:, None] if cache else torch.zeros_like(x)
    xk = _mix(x, x_prev, p["mu_ck"])
    xr = _mix(x, x_prev, p["mu_cr"])
    kk = torch.square(F.relu(xk @ p["wk_c"]))
    y = torch.sigmoid(xr @ p["wr_c"]) * (kk @ p["wv_c"])
    new_cache = None
    if mode == "prefill":
        new_cache = {"cm_shift": x[:, -1]}
    elif mode == "decode":
        new_cache = {"cm_shift": x[:, 0]}
    return y, new_cache
