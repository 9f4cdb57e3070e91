"""RWKV-6 recurrence: the plain PyTorch version and the wrapper of the
hand-written CUDA kernel (``csrc/rwkv_scan.cu``).

Both compute what the reference package's ``kernels/rwkv_scan.py``
``rwkv_scan`` (``_rwkv_kernel``) computes.  Per (batch, head), with the
(hs, hs) state ``S`` starting at ``s0`` and, for every step t,

    kv      = k_t[:, None] * v_t[None, :]
    out_t   = sum_i r_t[i] * (S + u[:, None] * kv)[i, :]
    S       = w_t[:, None] * S + kv

in float32, whatever the inputs' type.  ``out`` is returned in r's type,
the final state in float32.  The state is never rounded between steps:
``chunk_t`` only sets the reference's precondition ``T % min(chunk_t,
T) == 0``.  ``LAUNCHES`` counts the CUDA wrapper's kernel launches.

The CUDA kernel cuts the state by ``scan_split``: a CTA per (batch,
head, block of columns), a thread per (column, slice of rows), each
thread's strip of the state in registers for the whole sequence, the
slices' partial sums of ``out`` added in slice order.  The cut depends
on hs alone, never on the type.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

CHUNK_T = 256
LAUNCHES = 0     # kernel launches made by rwkv_scan_cuda
ROWS = 8         # state rows a CUDA thread keeps (csrc/rwkv_scan.cu kRows)
MAX_HS = 512     # scan_split's widest cut: 8 columns x 64 slices of 8 rows


def scan_split(hs):
    """``(cols, rows)``: the CUDA kernel's cut of the (hs, hs) state,
    ``cols`` columns a CTA and ``rows`` rows a thread (a thread keeps one
    column of its slice of rows), so a CTA runs ``cols * ceil(hs /
    rows)`` threads (at most 512).  The partial sums of ``out``
    go by slices of ``rows`` rows, added in slice order.  Reads the width
    only, so a float32 call on widened bf16 inputs sums in the same
    order."""
    return (16 if hs <= 256 else 8), ROWS


def _check_shapes(r, k, v, w, u, s0, chunk_t):
    B, H, T, hs = r.shape
    for name, x in (("k", k), ("v", v), ("w", w)):
        if x.shape != r.shape:
            raise ValueError(f"rwkv_scan: {name} {tuple(x.shape)} != r "
                             f"{tuple(r.shape)}")
    if u.shape != (H, hs) or s0.shape != (B, H, hs, hs):
        raise ValueError(f"rwkv_scan: u {tuple(u.shape)} and s0 "
                         f"{tuple(s0.shape)} do not match r "
                         f"{tuple(r.shape)}")
    chunk = min(chunk_t, T)
    if chunk < 1 or T % chunk:
        raise ValueError(f"rwkv_scan needs T % min(chunk_t, T) == 0, got "
                         f"T={T}, chunk_t={chunk_t}")


def rwkv_scan_torch(r, k, v, w, u, s0, *, chunk_t: int = CHUNK_T):
    """Plain PyTorch version: r/k/v/w (B, H, T, hs), u (H, hs), s0 (B, H,
    hs, hs) -> (out (B, H, T, hs) in r's dtype, s_final (B, H, hs, hs)
    float32).  One step per time step, in the reference kernel's
    operation order."""
    _check_shapes(r, k, v, w, u, s0, chunk_t)
    S = s0.float()
    uf = u.float()[None, :, :, None]                  # (1, H, hs, 1)
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    outs = []
    for t in range(r.shape[2]):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        outs.append(torch.sum(rf[:, :, t, :, None] * (S + uf * kv), dim=2))
        S = wf[:, :, t, :, None] * S + kv
    return torch.stack(outs, 2).to(r.dtype), S


_LAUNCH_ARGS = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7 + [
    ctypes.c_void_p] * 3
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def rwkv_scan_cuda(r, k, v, w, u, s0, *, chunk_t: int = CHUNK_T):
    """The CUDA kernel's wrapper: same arguments and results as
    ``rwkv_scan_torch``, for tensors on one CUDA device, with r, k, v, w
    all float32 or all bfloat16 and hs <= ``MAX_HS``.  Raises on
    anything else, on a missing kernel library and on a failed
    launch."""
    global LAUNCHES
    launch = build.function("rwkv_scan", "rwkv_scan_launch", _LAUNCH_ARGS)
    dev = r.device
    if dev.type != "cuda" or any(x.device != dev for x in (k, v, w, u, s0)):
        raise ValueError("rwkv_scan_cuda takes CUDA tensors on one device, "
                         f"got {[str(x.device) for x in (r, k, v, w, u, s0)]}")
    _check_shapes(r, k, v, w, u, s0, chunk_t)
    if r.dtype not in _DTYPES or any(x.dtype != r.dtype for x in (k, v, w)):
        raise ValueError(f"rwkv_scan_cuda takes r, k, v, w all float32 or "
                         f"all bfloat16, got {[x.dtype for x in (r, k, v, w)]}")
    B, H, T, hs = r.shape
    if hs > MAX_HS:
        raise ValueError(f"rwkv_scan_cuda: hs {hs} > {MAX_HS}")
    r, k, v, w = (build.operand(x) for x in (r, k, v, w))
    uf = build.operand(u, torch.float32)
    sf = build.operand(s0, torch.float32)
    out = torch.empty_like(r)
    s_final = torch.empty((B, H, hs, hs), dtype=torch.float32, device=dev)
    if B * H and hs:
        cols, rows = scan_split(hs)
        err = launch(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                     uf.data_ptr(), sf.data_ptr(), B, H, T, hs, cols, rows,
                     _DTYPES[r.dtype], out.data_ptr(), s_final.data_ptr(),
                     build.stream(dev))
        build.check(err, "rwkv_scan_launch")
        LAUNCHES += 1
    return out, s_final
