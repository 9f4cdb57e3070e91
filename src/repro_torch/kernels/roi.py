"""ROI crop / uncrop for the cascade's hierarchical second pass: the plain
PyTorch versions and the wrappers of the hand-written CUDA kernels
(``csrc/roi.cu``).

Both compute what the reference package's ``kernels/roi.py`` computes
(``crop_resize_pallas`` / ``uncrop_boxes_pallas`` and their XLA twins):

* **crop** — R normalized xyxy windows per frame, each resized to a
  (C, C) tile by nearest neighbour.  Output row ``i`` reads source row

      clip(floor((y0 + (i + 0.5) / C * (y1 - y0)) * H), 0, H - 1)

  and columns likewise, in float32 with that operation order.  The
  floor and clip quantize to integer indices, so every tier (oracle,
  XLA twin, Pallas, this plain version, the CUDA kernel) gives the
  same pixels.  A zero-area window gives a constant tile of pixel
  (0, 0) (callers mask invalid windows downstream).
* **uncrop** — second-pass boxes in crop pixels back to parent-frame
  coordinates, ``(x0 + b / C * (x1 - x0)) * W`` per coordinate, with
  the rois broadcast against the boxes.  The plain version and the
  kernel round after every operation, as the numpy oracle does, and
  equal it bit for bit; the reference's jitted tiers contract
  ``x0 + t * (x1 - x0)`` into a fused multiply-add and differ from
  both by at most one float32 ULP of the parent frame scale.

``CROP_LAUNCHES`` and ``UNCROP_LAUNCHES`` count the two CUDA wrappers'
kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

CROP_LAUNCHES = 0     # kernel launches made by crop_resize_cuda
UNCROP_LAUNCHES = 0   # kernel launches made by uncrop_boxes_cuda


def _f32(x: float, device) -> torch.Tensor:
    return torch.tensor(float(x), dtype=torch.float32, device=device)


def crop_indices(lo, hi, C: int, S: int):
    """Source indices of a C-pixel resize of the normalized span
    [lo, hi] of an S-pixel axis: lo, hi (...) float32 -> (..., C)
    int64, ``clip(floor((lo + f * (hi - lo)) * S), 0, S - 1)`` with
    ``f = (i + 0.5) / C``."""
    dev = lo.device
    f = ((torch.arange(C, dtype=torch.float32, device=dev) + 0.5)
         / _f32(C, dev))
    s = torch.floor((lo[..., None] + f * (hi - lo)[..., None])
                    * _f32(S, dev))
    return torch.clamp(s, 0.0, float(S - 1)).long()


def crop_resize_torch(images, rois, *, out_size: int):
    """Plain PyTorch version: images (B, H, W, ch), rois (B, R, 4)
    normalized xyxy -> crops (B, R, C, C, ch) float32, C = out_size."""
    B, H, W, ch = images.shape
    r = rois.float()
    ys = crop_indices(r[..., 1], r[..., 3], out_size, H)      # (B, R, C)
    xs = crop_indices(r[..., 0], r[..., 2], out_size, W)
    b = torch.arange(B, device=images.device)[:, None, None, None]
    return images.float()[b, ys[..., :, None], xs[..., None, :]]


def uncrop_boxes_torch(boxes, rois, *, bounds, crop_size: int):
    """Plain PyTorch version: boxes (..., 4) xyxy in crop pixels, rois
    broadcast against them, bounds = (W, H) -> float32 boxes in the
    parent frame."""
    b = boxes.float()
    r = rois.float().expand(b.shape)
    dev = b.device
    C = _f32(crop_size, dev)
    W, H = _f32(bounds[0], dev), _f32(bounds[1], dev)
    x0, y0, x1, y1 = r.unbind(-1)
    return torch.stack([
        (b[..., 0] / C * (x1 - x0) + x0) * W,
        (b[..., 1] / C * (y1 - y0) + y0) * H,
        (b[..., 2] / C * (x1 - x0) + x0) * W,
        (b[..., 3] / C * (y1 - y0) + y0) * H,
    ], -1)


def _aligned(t):
    """``t``, copied where its data does not start on 16 bytes (the
    kernels load float4)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _check_cuda(what, *tensors):
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise ValueError(f"{what} takes CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    return dev


_CROP_ARGS = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 6 + [
    ctypes.c_void_p, ctypes.c_void_p]


def crop_resize_cuda(images, rois, *, out_size: int):
    """The CUDA kernel's wrapper: same arguments and result as
    ``crop_resize_torch``, for tensors on one CUDA device.  Raises on
    any other device, on a missing kernel library and on a failed
    launch."""
    global CROP_LAUNCHES
    launch = build.function("roi", "crop_resize_launch", _CROP_ARGS)
    dev = _check_cuda("crop_resize_cuda", images, rois)
    B, H, W, ch = images.shape
    R = rois.shape[1]
    C = int(out_size)
    if (rois.shape != (B, R, 4) or min(H, W, ch, C) < 1
            or C * C * ch >= 2 ** 31):
        raise ValueError(f"crop_resize_cuda: images {tuple(images.shape)},"
                         f" rois {tuple(rois.shape)}, out_size {C}")
    img = images.float().contiguous()
    r = _aligned(rois.float().contiguous())
    out = torch.empty((B, R, C, C, ch), dtype=torch.float32, device=dev)
    if B * R:
        err = launch(img.data_ptr(), r.data_ptr(), B, R, H, W, ch, C,
                     out.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "crop_resize_launch")
        CROP_LAUNCHES += 1
    return out


_UNCROP_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_float, ctypes.c_float, ctypes.c_float,
                ctypes.c_void_p, ctypes.c_void_p]


def uncrop_boxes_cuda(boxes, rois, *, bounds, crop_size: int):
    """The CUDA kernel's wrapper: same arguments and result as
    ``uncrop_boxes_torch``, for tensors on one CUDA device.  The rois'
    broadcast against the boxes is materialized (4 floats a box) so the
    kernel reads one roi per box.  Raises on any other device, on a
    missing kernel library and on a failed launch."""
    global UNCROP_LAUNCHES
    launch = build.function("roi", "uncrop_boxes_launch", _UNCROP_ARGS)
    dev = _check_cuda("uncrop_boxes_cuda", boxes, rois)
    if boxes.shape[-1] != 4:
        raise ValueError(f"uncrop_boxes_cuda: boxes {tuple(boxes.shape)}"
                         " are not (..., 4)")
    b = _aligned(boxes.float().contiguous())
    r = _aligned(rois.float().expand(b.shape).contiguous())
    out = torch.empty_like(b)
    N = b.numel() // 4
    if N:
        # ctypes rounds each scale to float32, as the plain version does
        err = launch(b.data_ptr(), r.data_ptr(), N, float(crop_size),
                     float(bounds[0]), float(bounds[1]), out.data_ptr(),
                     torch.cuda.current_stream(dev).cuda_stream)
        build.check(err, "uncrop_boxes_launch")
        UNCROP_LAUNCHES += 1
    return out
