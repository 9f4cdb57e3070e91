"""GQA single-token decode attention: the plain PyTorch version and the
wrapper of the hand-written CUDA kernel (``csrc/decode_attention.cu``).

Both compute what the reference package's ``kernels/decode_attention.py``
``decode_attention`` (``_decode_kernel``) computes: one new token's
queries q (B, H, D) against the whole cache k, v (B, S, KV, D), query
head h reading kv head ``h // (H // KV)``, with the queries scaled by
``scale`` (default ``D ** -0.5``) before the dot, a softmax over all S
positions in float32 (there is no length mask) and the result in q's
type.  The reference streams the cache in blocks of ``min(512, S)`` and
requires ``S`` to be a multiple of it; both versions keep that
precondition.  ``LAUNCHES`` counts the CUDA wrapper's kernel launches.

The CUDA kernel cuts the cache into ``split_rows`` splits, one CTA each
per (batch, kv head), and merges them in a fixed order in the same
launch; the cut depends on the shape alone, never on the type.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import ieee_float32
from . import build

BLOCK_S = 512
LAUNCHES = 0     # kernel launches made by decode_attention_cuda
MAX_D = 256
# the CUDA kernel's tiling (csrc/decode_attention.cu): 4 warps a CTA, a
# lane group of D / 8 lanes (4, 8, 16 or 32) a cache row, 4 rows a group
# per tile; and the CTAs to aim for, 4 on each of the H100's 132 SMs
WARPS = 4
ROWS_PER_GROUP = 4
TARGET_CTAS = 4 * 132


def lanes_per_row(D):
    """Lanes that hold one cache row: each owns 8 values of d."""
    return next(n for n in (4, 8, 16, 32) if 8 * n >= D)


def tile_rows(D):
    """Cache rows a CTA takes per tile."""
    return WARPS * (32 // lanes_per_row(D)) * ROWS_PER_GROUP


def split_rows(B, KV, S, D):
    """``(n_split, rows)``: the CUDA kernel's cut of the S cache rows
    into ``n_split`` splits of ``rows`` rows (a multiple of the tile; the
    last split may be shorter, none is empty), about ``TARGET_CTAS``
    CTAs over the B * KV (batch, kv head) pairs.  Reads the shape only,
    so a float32 call on widened bf16 inputs cuts the cache the same
    way."""
    tile = tile_rows(D)
    n = max(1, min(TARGET_CTAS // max(1, B * KV), -(-S // tile)))
    rows = -(-(-(-S // n)) // tile) * tile
    return -(-S // rows), rows


def _check_shapes(q, k, v):
    B, H, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or k.shape[0] != B \
            or k.shape[3] != D:
        raise ValueError(f"decode_attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} are not "
                         "(B, H, D), (B, S, KV, D), (B, S, KV, D)")
    S, KV = k.shape[1], k.shape[2]
    if KV < 1 or H % KV:
        raise ValueError(f"decode_attention: H={H} is not a multiple of "
                         f"KV={KV}")
    block_s = min(BLOCK_S, S)
    if block_s < 1 or S % block_s:
        raise ValueError(f"decode_attention needs S % min({BLOCK_S}, S) == "
                         f"0, got S={S}")
    return B, H, D, S, KV


def _scale(scale, D):
    return D ** -0.5 if scale is None else scale


@ieee_float32()
def decode_attention_torch(q, k, v, *, scale=None):
    """Plain PyTorch version: q (B, H, D), k/v (B, S, KV, D) -> (B, H, D)
    in q's dtype, computed in float32 (IEEE products, never TF32:
    ``device.ieee_float32``) and cast once at the end."""
    B, H, D, S, KV = _check_shapes(q, k, v)
    qg = q.float().reshape(B, KV, H // KV, D) * _scale(scale, D)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(B, H, D).to(q.dtype)


_LAUNCH_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [
    ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 4
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def decode_attention_cuda(q, k, v, *, scale=None):
    """The CUDA kernel's wrapper: same arguments and result as
    ``decode_attention_torch``, for tensors on one CUDA device, all
    float32 or all bfloat16, D <= ``MAX_D``.  Raises on anything else,
    on a missing kernel library and on a failed launch."""
    global LAUNCHES
    launch = build.function("decode_attention", "decode_attention_launch",
                            _LAUNCH_ARGS)
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("decode_attention_cuda takes CUDA tensors on one "
                         f"device, got {q.device}, {k.device}, {v.device}")
    B, H, D, S, KV = _check_shapes(q, k, v)
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"decode_attention_cuda takes q, k, v all float32 "
                         f"or all bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if D > MAX_D:
        raise ValueError(f"decode_attention_cuda: D {D} > {MAX_D}")
    q, k, v = (build.operand(x) for x in (q, k, v))
    out = torch.empty_like(q)
    if B * H and D:
        n_split, rows = split_rows(B, KV, S, D)
        part = torch.empty(B * H * n_split * (D + 2), dtype=torch.float32,
                           device=dev)
        tickets = torch.zeros(B * H, dtype=torch.int32, device=dev)
        # ctypes rounds the scale to float32, as q.float() * scale does
        err = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), B, H, KV, S,
                     D, float(_scale(scale, D)), _DTYPES[q.dtype], rows,
                     n_split, part.data_ptr(), tickets.data_ptr(),
                     out.data_ptr(),
                     build.stream(dev))
        build.check(err, "decode_attention_launch")
        LAUNCHES += 1
    return out
