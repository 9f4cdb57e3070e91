"""MLA's weight-absorbed decode attention: the plain PyTorch version and
the wrapper of the hand-written CUDA kernel (``csrc/mla_decode.cu``).

Both compute one new token's attention over the latent ring of a
DeepSeek-style multi-head latent attention layer, W_kb absorbed into the
query and W_vb into the output, so the ring is never expanded to heads.
For batch row b and head h, with ckv (B, L, r) and kpe (B, L, rope) the
ring after ``decode_pos + 1`` tokens were written (token i at slot i % L)
and wk_b (r, H, nope), wv_b (r, H, v) the absorbed weights::

    q_abs = q_nope[b, h] @ wk_b[:, h, :]^T     rounded to the inputs' type
    s[j]  = (q_abs . ckv[b, j] + q_pe[b, h] . kpe[b, j]) * scale
    p     = softmax(s over the slots j in the mask)
    out   = (sum_j p[j] ckv[b, j]) @ wv_b[:, h, :]

Scores, probabilities, the context and the output projection are
float32 sums of the inputs' values, and the output is rounded once to
their type.  The mask keeps a slot where the position it holds
(``models.attention._ring_positions``) is >= 0, <= decode_pos and, with a
``window``, inside it (``models.attention.make_mask``): the
``n = min(decode_pos + 1, L, window)`` newest tokens.  The ring holds no
position past ``decode_pos``, so the causal test never masks a slot.

The plain version is the layer's former einsum code: it widens the whole
ring and ``wv_b`` to float32 and masks the empty slots to -1e30.  The
CUDA kernel takes bf16 inputs only, widens them in registers, and reads
only the n filled slots: ``decode_pos`` is read from its 0-d device
tensor, so one CUDA graph serves every position.  Where the inputs are
finite the two agree but for the order of the float32 sums.
``models.attention.apply_mla`` calls the plain version wherever the
kernel is not taken (float32 among those).

The JAX package has no kernel here (it leaves the absorbed decode to XLA,
``models/attention.py:apply_mla``), so this one replaces none.
``LAUNCHES`` counts the CUDA wrapper's kernel launches: three a call, the
query's absorption, the attention over the ring's splits, and their
combination with the output projection.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import ieee_float32
from . import build

LAUNCHES = 0     # kernel launches made by mla_decode_cuda
# the CUDA kernel's attention pass (csrc/mla_decode.cu): a block takes
# HEAD_TILE heads of one batch row and one split of the filled slots, at
# least CHUNK slots a split; r at most MAX_R; up to MAX_SPLITS splits
HEAD_TILE = 16
CHUNK = 32
MAX_R = 512
MAX_SPLITS = 256
MAX_CLUSTER = 8
# (device index, r, rope, cluster size) -> (clusters of the attention pass
# that fit on the device at once, its SM count)
_FITS = {}


def cluster_size(H):
    """The attention pass's cluster: the blocks of 8, 4, 2 or 1 head
    tiles of one split, the most that divides the tiles, stage the ring
    together (each row leaves L2 once a cluster)."""
    tiles, cs = -(-H // HEAD_TILE), 1
    while cs < MAX_CLUSTER and tiles % (2 * cs) == 0:
        cs *= 2
    return cs


def splits(B, H, L, clusters, cs):
    """The attention pass's splits of the filled slots: as many as fill
    the ``clusters`` clusters of ``cs`` blocks that fit on the card at
    once, over the B x ceil(H / HEAD_TILE) head tiles (one wave), at
    least one and at most one a CHUNK of the ring.  Reads the shape
    only, never ``decode_pos``, so a graph's launch serves every
    position."""
    tiles = B * -(-H // HEAD_TILE)
    return max(1, min(MAX_SPLITS, clusters * cs // tiles, -(-L // CHUNK)))


def _check_shapes(q_nope, q_pe, ckv, kpe, wk_b, wv_b):
    if q_nope.dim() != 4 or q_nope.shape[1] != 1:
        raise ValueError(f"mla_decode: q_nope {tuple(q_nope.shape)} is not "
                         "(B, 1, H, nope)")
    B, _, H, N = q_nope.shape
    R, P = wk_b.shape[0], q_pe.shape[-1]
    L, V = ckv.shape[1] if ckv.dim() == 3 else 0, wv_b.shape[-1]
    if (q_pe.shape != (B, 1, H, P) or ckv.shape != (B, L, R)
            or kpe.shape != (B, L, P) or wk_b.shape != (R, H, N)
            or wv_b.shape != (R, H, V) or not L):
        raise ValueError(
            f"mla_decode: q_nope {tuple(q_nope.shape)}, q_pe "
            f"{tuple(q_pe.shape)}, ckv {tuple(ckv.shape)}, kpe "
            f"{tuple(kpe.shape)}, wk_b {tuple(wk_b.shape)}, wv_b "
            f"{tuple(wv_b.shape)} are not (B, 1, H, nope), (B, 1, H, rope), "
            "(B, L, r), (B, L, rope), (r, H, nope), (r, H, v) with L >= 1")
    return B, H, N, R, P, L, V


def mla_decode_torch(q_nope, q_pe, ckv, kpe, wk_b, wv_b, decode_pos, *,
                     scale, window=None):
    """Plain PyTorch version: q_nope (B, 1, H, nope), q_pe (B, 1, H, rope),
    the ring ckv (B, L, r), kpe (B, L, rope), wk_b (r, H, nope), wv_b (r,
    H, v), ``decode_pos`` an int or a 0-d int64 tensor on the ring's
    device -> (B, 1, H, v) in q_nope's type.  Every slot of the ring is
    read; float32 products in IEEE float32 (``device.ieee_float32``)."""
    from ..models.attention import NEG_INF, _ring_positions, make_mask
    B, H, N, R, P, L, V = _check_shapes(q_nope, q_pe, ckv, kpe, wk_b, wv_b)
    with ieee_float32():
        q_abs = torch.einsum("bthn,rhn->bthr", q_nope, wk_b)   # (B,1,H,r)
        s = torch.einsum("bthr,bsr->bhts", q_abs.float(), ckv.float())
        s = s + torch.einsum("bthp,bsp->bhts", q_pe.float(), kpe.float())
        s = s * scale
        k_pos, valid = _ring_positions(L, decode_pos + 1, ckv.device)
        q_pos = k_pos.new_zeros((B, 1)) + decode_pos
        k_pos = k_pos[None].expand(B, L)
        valid = valid[None].expand(B, L)
        mask = make_mask(q_pos, k_pos, True, window, valid)
        s = torch.where(mask, s, NEG_INF)
        prob = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhts,bsr->bthr", prob, ckv.float())
        return torch.einsum("bthr,rhv->bthv", ctx,
                            wv_b.float()).to(q_nope.dtype)


_LAUNCH_ARGS = [ctypes.c_void_p] * 7 + [ctypes.c_longlong] * 5 + [
    ctypes.c_int] * 11 + [ctypes.c_float] + [ctypes.c_void_p] * 5
VEC = 8         # bf16 values in 16 bytes


def mla_decode_cuda(q_nope, q_pe, ckv, kpe, wk_b, wv_b, decode_pos, *,
                    scale, window=None):
    """The CUDA kernel's wrapper: same arguments and result as
    ``mla_decode_torch``, for bfloat16 tensors on one CUDA device: q_nope
    and q_pe with unit last stride and 16-byte aligned rows, the ring and
    the weights contiguous on 16 bytes; r a multiple of 32 up to
    ``MAX_R``, r + rope a multiple of 16, rope a multiple of 8, nope and
    v whole 16-byte vectors (v at most 32 of them); ``decode_pos`` an int
    or a 0-d int64 tensor on that device (B = 0 launches nothing).
    Raises on anything else, on a missing kernel library and on a failed
    launch; allocates its output and scratch with torch (a CUDA graph's
    capture takes them from its pool) and reads no value of the data on
    the host."""
    global LAUNCHES
    launch = build.function("mla_decode", "mla_decode_launch", _LAUNCH_ARGS)
    pos_t = decode_pos if isinstance(decode_pos, torch.Tensor) else None
    dev = build.cuda_device("mla_decode_cuda", q_nope, q_pe, ckv, kpe, wk_b,
                            wv_b, *(() if pos_t is None else (pos_t,)))
    B, H, N, R, P, L, V = _check_shapes(q_nope, q_pe, ckv, kpe, wk_b, wv_b)
    dt = torch.bfloat16
    if any(t.dtype != dt for t in (q_nope, q_pe, ckv, kpe, wk_b, wv_b)):
        raise ValueError(
            "mla_decode_cuda takes q_nope, q_pe, the ring and the weights "
            "all bfloat16 (float32 takes mla_decode_torch), got "
            f"{[t.dtype for t in (q_nope, q_pe, ckv, kpe, wk_b, wv_b)]}")
    if (pos_t is None and decode_pos < 0) or (
            pos_t is not None and (pos_t.dim() or pos_t.dtype != torch.int64)):
        raise ValueError("mla_decode_cuda takes decode_pos as an int >= 0 "
                         "or a 0-d int64 tensor")
    n_v = V // VEC if V % VEC == 0 else 0
    if (R % 32 or R > MAX_R or (R + P) % 16 or P % 8 or N % VEC
            or not n_v or n_v > 32 or n_v & (n_v - 1)):
        raise ValueError(
            f"mla_decode_cuda: r={R}, rope={P}, nope={N}, v={V}; "
            f"needs r a multiple of 32 up to {MAX_R}, r + rope a multiple "
            "of 16, rope of 8, nope whole 16-byte vectors, v 1, 2, 4, 8, "
            "16 or 32 of them")
    if not B:                   # no batch row: nothing to launch
        return torch.empty((0, 1, H, V), dtype=dt, device=dev)
    q_strides = (q_nope.stride(0), q_nope.stride(2), q_pe.stride(0),
                 q_pe.stride(2))
    if (q_nope.stride(3) != 1 or q_pe.stride(3) != 1
            or any(s % VEC for s in q_strides)
            or q_nope.data_ptr() % 16 or q_pe.data_ptr() % 16):
        raise ValueError("mla_decode_cuda takes q_nope and q_pe with unit "
                         "last stride and rows on 16 bytes")
    if not all(t.is_contiguous() and t.data_ptr() % 16 == 0
               for t in (ckv, kpe, wk_b, wv_b)):
        raise ValueError("mla_decode_cuda takes the ring and the weights "
                         "contiguous, starting on 16 bytes")
    cs = cluster_size(H)
    key = (dev.index, R, P, cs)
    if key not in _FITS:       # once a shape: a host query, no launch
        fits = build.function("mla_decode", "mla_decode_clusters",
                              [ctypes.c_int] * 3)
        with torch.cuda.device(dev):
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            _FITS[key] = (fits(R, P, cs), sms)
    clusters, sms = _FITS[key]
    if clusters < 1:
        raise RuntimeError(f"mla_decode_clusters: no cluster of {cs} "
                           f"attention blocks fits on {dev} (CUDA error "
                           f"{-clusters})")
    S = splits(B, H, L, clusters, cs)
    q_abs = torch.empty((B, R, H), dtype=dt, device=dev)
    part = torch.empty(B * H * S * R, dtype=torch.float32, device=dev)
    part_ml = torch.empty(B * H * S * 2, dtype=torch.float32, device=dev)
    out = torch.empty((B, 1, H, V), dtype=dt, device=dev)
    err = launch(q_nope.data_ptr(), q_pe.data_ptr(), ckv.data_ptr(),
                 kpe.data_ptr(), wk_b.data_ptr(), wv_b.data_ptr(),
                 0 if pos_t is None else pos_t.data_ptr(), *q_strides,
                 0 if pos_t is not None else int(decode_pos),
                 B, H, N, R, P, V, L, S, window or 0, sms, cs,
                 float(scale), q_abs.data_ptr(),
                 part.data_ptr(), part_ml.data_ptr(), out.data_ptr(),
                 build.stream(dev))
    build.check(err, "mla_decode_launch")
    LAUNCHES += 3
    return out
