"""Pairwise IoU matrix: the plain PyTorch version and the wrapper of the
hand-written CUDA kernel (``csrc/iou.cu``).

Both compute what the reference package's ``kernels/iou.py``
``iou_matrix`` (``_iou_kernel``) computes, in its operation order:

    inter = clip(ix1 - ix0, 0) * clip(iy1 - iy0, 0)
    union = area_a + area_b - inter
    iou   = inter / max(union, 1e-9)          (IEEE division)

for a (N, 4) and b (M, 4) xyxy boxes of any float type, read as float32,
giving a (N, M) float32 matrix; NaN is carried through every max and
min, as ``jnp.maximum``/``jnp.clip`` and ``torch.maximum``/
``torch.clamp`` carry it.  The reference carries the boxes as (4, N)
lane planes for the TPU's 128-wide vectors; on the card the boxes stay
(N, 4), a lane computes four adjacent columns of a row and a warp writes
a 128-column strip of it in 16-byte stores (``csrc/iou.cu``).
``LAUNCHES`` counts the CUDA wrapper's kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

LAUNCHES = 0     # kernel launches made by iou_matrix_cuda


def iou_matrix_torch(a, b):
    """Plain PyTorch version: a (N, 4), b (M, 4) xyxy -> (N, M) float32
    IoU, in the reference kernel's operation order."""
    a = a.float()
    b = b.float()
    ax0, ay0, ax1, ay1 = a.unbind(-1)
    bx0, by0, bx1, by1 = b.unbind(-1)
    ix0 = torch.maximum(ax0[:, None], bx0[None, :])
    iy0 = torch.maximum(ay0[:, None], by0[None, :])
    ix1 = torch.minimum(ax1[:, None], bx1[None, :])
    iy1 = torch.minimum(ay1[:, None], by1[None, :])
    inter = (torch.clamp(ix1 - ix0, min=0.0) *
             torch.clamp(iy1 - iy0, min=0.0))
    area_a = (ax1 - ax0) * (ay1 - ay0)
    area_b = (bx1 - bx0) * (by1 - by0)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / torch.clamp(union, min=1e-9)


_LAUNCH_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]


def iou_matrix_cuda(a, b):
    """The CUDA kernel's wrapper: same arguments and result as
    ``iou_matrix_torch``, for tensors on one CUDA device.  Raises on any
    other device, on a missing kernel library and on a failed launch."""
    global LAUNCHES
    launch = build.function("iou", "iou_matrix_launch", _LAUNCH_ARGS)
    dev = build.cuda_device("iou_matrix_cuda", a, b)
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != 4 or b.shape[1] != 4:
        raise ValueError(f"iou_matrix_cuda: a {tuple(a.shape)} and b "
                         f"{tuple(b.shape)} are not (N, 4) and (M, 4)")
    N, M = a.shape[0], b.shape[0]
    af = build.operand(a, torch.float32, align16=True)
    bf = build.operand(b, torch.float32, align16=True)
    out = torch.empty((N, M), dtype=torch.float32, device=dev)
    if N and M:
        err = launch(af.data_ptr(), bf.data_ptr(), N, M, out.data_ptr(),
                     build.stream(dev))
        build.check(err, "iou_matrix_launch")
        LAUNCHES += 1
    return out
