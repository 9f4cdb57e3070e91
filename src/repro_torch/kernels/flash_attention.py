"""Blocked prefill attention: the plain PyTorch version and the wrapper of
the hand-written CUDA kernel (``csrc/flash_attention.cu``).

Both compute what the reference package's ``kernels/flash_attention.py``
``flash_attention`` (``_flash_kernel``, 128 x 128 blocks) computes for
q (B, H, T, D) and k, v (B, H, S, D): the queries scaled by ``scale``
(default ``D ** -0.5``) before the dot, a softmax in float32 and the
result in q's type.  With ``causal`` the mask is aligned to the bottom
right: query t sees key s when ``s <= t + (S - T)`` (a cached prefix of
S - T keys).  A query that sees no key (t < T - S, possible only when
S < T) gets 0: the reference kernel skips every key block for its query
block and divides a zero accumulator by ``max(0, 1e-30)``.  (The
reference's oracle returns the mean of v there instead.)  T and S must
be multiples of 128, the reference's block size.  ``LAUNCHES`` counts
the CUDA wrapper's kernel launches.

The CUDA kernel multiplies bf16 pieces of its operands on the tensor
cores (wgmma) in one order for both input types, so a bfloat16 result
is the float32 instance's result on the widened inputs, rounded once.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import ieee_float32
from . import build

BLOCK = 128
NEG_INF = -1e30
LAUNCHES = 0     # kernel launches made by flash_attention_cuda
MAX_D = 128


def _check_shapes(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3]:
        raise ValueError(f"flash_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "(B, H, T, D), (B, H, S, D), (B, H, S, D)")
    B, H, T, D = q.shape
    S = k.shape[2]
    if T % BLOCK or S % BLOCK:
        raise ValueError(f"flash_attention needs T and S multiples of "
                         f"{BLOCK}, got T={T}, S={S}")
    return B, H, T, S, D


def _scale(scale, D):
    return D ** -0.5 if scale is None else scale


@ieee_float32()
def flash_attention_torch(q, k, v, *, causal=True, scale=None):
    """Plain PyTorch version: q (B, H, T, D), k/v (B, H, S, D) -> (B, H,
    T, D) in q's dtype, computed in float32 (IEEE products, never TF32:
    ``device.ieee_float32``) and cast once at the end."""
    B, H, T, S, D = _check_shapes(q, k, v)
    qs = q.float() * _scale(scale, D)
    s = torch.einsum("bhtd,bhsd->bhts", qs, k.float())
    if causal:
        t = torch.arange(T, device=q.device)[:, None]
        seen = torch.arange(S, device=q.device)[None, :] <= t + (S - T)
        s = torch.where(seen, s, NEG_INF)
        p = torch.exp(s - s.amax(-1, keepdim=True)) * seen
    else:
        p = torch.exp(s - s.amax(-1, keepdim=True))
    out = torch.einsum("bhts,bhsd->bhtd", p, v.float())
    out = out / torch.clamp(p.sum(-1, keepdim=True), min=1e-30)
    return out.to(q.dtype)


_LAUNCH_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_cuda(q, k, v, *, causal=True, scale=None):
    """The CUDA kernel's wrapper: same arguments and result as
    ``flash_attention_torch``, for tensors on one CUDA device, all
    float32 or all bfloat16, D <= ``MAX_D``.  Raises on anything else,
    on a missing kernel library and on a failed launch."""
    global LAUNCHES
    launch = build.function("flash_attention", "flash_attention_launch",
                            _LAUNCH_ARGS)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("flash_attention_cuda takes CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    B, H, T, S, D = _check_shapes(q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attention_cuda takes q, k, v all float32 "
                         f"or all bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if D > MAX_D:
        raise ValueError(f"flash_attention_cuda: D {D} > {MAX_D}")
    q, k, v = (build.operand(x) for x in (q, k, v))
    out = torch.empty_like(q)
    if B * H * T and D:
        # ctypes rounds the scale to float32, as q.float() * scale does
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), B, H, T, S,
                     D, float(_scale(scale, D)), int(bool(causal)),
                     _DTYPES[q.dtype], out.data_ptr(),
                     build.stream(dev))
        build.check(err, "flash_attention_launch")
        LAUNCHES += 1
    return out
