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

``crop_split`` and ``uncrop_layout`` are the kernels' cut of the crop's
output and view of the rois, worked out from shapes in Python so that
the CPU tests can hold them.  ``CROP_LAUNCHES`` and ``UNCROP_LAUNCHES``
count the two CUDA wrappers' kernel launches.
"""
from __future__ import annotations

import ctypes
import functools

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


CROP_MIN_CTAS = 128        # about one wave on the H100's 132 SMs
CROP_TILE_FLOATS = 4096    # 16 KB of output a CTA at most, unless one
                           # row is more
CROP_MAX_SMEM = 232448     # bytes of shared memory a CTA can opt into on
                           # the H100 (227 KB): one row's gather map and
                           # the tile's source rows, 4 bytes each
MAX_ROI_RANK = 8           # leading dims of the boxes (csrc/roi.cu)


@functools.lru_cache(maxsize=256)
def crop_split(B: int, R: int, C: int, ch: int):
    """``(rows, threads)``: the CUDA crop kernel's cut of its output.  A
    CTA takes ``rows`` consecutive output rows of one window (the grid
    is (B * R windows, ceil(C / rows) row tiles)) and runs ``threads``
    threads, a warp a row at a time.  ``rows`` is the largest power of
    two that keeps at least ``CROP_MIN_CTAS`` CTAs, at most
    ``CROP_TILE_FLOATS`` output floats a CTA and at most C rows; 1 where
    none does.  Reads the shape only."""
    windows = B * R
    rows = 1
    while (2 * rows <= C and 2 * rows * C * ch <= CROP_TILE_FLOATS
           and windows * -(-C // (2 * rows)) >= CROP_MIN_CTAS):
        rows *= 2
    return rows, 32 * min(rows, 8)


def uncrop_layout(boxes_shape, rois):
    """The uncrop kernel's view of the rois against boxes of shape
    ``boxes_shape`` (..., 4): ``(r, sizes, strides)``, where ``r`` is
    ``rois`` as float32 (the same tensor where it already is), ``sizes``
    the boxes' leading sizes and ``strides`` the strides of
    ``r.expand(boxes_shape)`` along them in floats, 0 along a broadcast
    dim, worked out from the shapes without building the view.  Where
    that view's last dim is not unit-stride, ``r`` is the broadcast
    made contiguous instead.  Raises ``ValueError`` on more than
    ``MAX_ROI_RANK`` leading dims and on rois that do not broadcast to
    the boxes."""
    shape = tuple(boxes_shape)
    if len(shape) - 1 > MAX_ROI_RANK:
        raise ValueError(f"uncrop_boxes_cuda: boxes {shape} have more "
                         f"than {MAX_ROI_RANK} leading dims")
    r = rois if rois.dtype == torch.float32 else rois.float()
    rshape, rstride = r.shape, r.stride()
    k = len(shape) - len(rshape)      # dims the broadcast puts in front
    if k < 0 or any(m != n and m != 1 for m, n in zip(rshape, shape[k:])):
        raise ValueError(f"uncrop_boxes_cuda: rois {tuple(rois.shape)} do "
                         f"not broadcast to boxes {shape}")
    strides = tuple(rstride[d - k] if d >= k and rshape[d - k] == n else 0
                    for d, n in enumerate(shape))
    if strides[-1] != 1:
        r = r.expand(shape).contiguous()
        strides = r.stride()
    return r, shape[:-1], strides[:-1]


_CROP_ARGS = [ctypes.c_void_p, ctypes.c_void_p] + [ctypes.c_int] * 8 + [
    ctypes.c_void_p, ctypes.c_void_p]


def crop_resize_cuda(images, rois, *, out_size: int):
    """The CUDA kernel's wrapper: same arguments and result as
    ``crop_resize_torch``, for tensors on one CUDA device, cut by
    ``crop_split``.  Raises on any other device, before any launch on a
    row whose gather map would pass ``CROP_MAX_SMEM``, on a missing
    kernel library and on a failed launch."""
    global CROP_LAUNCHES
    launch = build.function("roi", "crop_resize_launch", _CROP_ARGS)
    dev = build.cuda_device("crop_resize_cuda", images, rois)
    B, H, W, ch = images.shape
    R = rois.shape[1]
    C = int(out_size)
    if (rois.shape != (B, R, 4) or min(H, W, ch, C) < 1
            or C * C * ch >= 2 ** 31 or B * R >= 2 ** 31):
        raise ValueError(f"crop_resize_cuda: images {tuple(images.shape)},"
                         f" rois {tuple(rois.shape)}, out_size {C}")
    rows, threads = crop_split(B, R, C, ch)
    if 4 * (C * ch + rows) > CROP_MAX_SMEM:
        raise ValueError(f"crop_resize_cuda: a row of {C} x {ch} floats "
                         f"needs a gather map of more than {CROP_MAX_SMEM}"
                         " bytes of shared memory")
    img = build.operand(images, torch.float32)
    r = build.operand(rois, torch.float32, align16=True)
    out = torch.empty((B, R, C, C, ch), dtype=torch.float32, device=dev)
    if B * R:
        err = launch(img.data_ptr(), r.data_ptr(), B, R, H, W, ch, C, rows,
                     threads, out.data_ptr(), build.stream(dev))
        build.check(err, "crop_resize_launch")
        CROP_LAUNCHES += 1
    return out


# the uncrop launcher's layout: MAX_ROI_RANK leading sizes (1 past the
# rank), then as many roi strides (0 past it)
_LAYOUT = ctypes.c_int64 * (2 * MAX_ROI_RANK)
_LAYOUTS = {}   # (boxes shape, rois shape, rois strides) -> launch args
_UNCROP_ARGS = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                ctypes.c_int, ctypes.POINTER(ctypes.c_int64), ctypes.c_float,
                ctypes.c_float, ctypes.c_float, ctypes.c_void_p,
                ctypes.c_void_p]


def uncrop_launch_layout(sizes, strides):
    """``uncrop_layout``'s sizes and strides as the launcher's array."""
    pad = MAX_ROI_RANK - len(sizes)
    return _LAYOUT(*sizes, *(1,) * pad, *strides, *(0,) * pad)


def _uncrop_launch_args(shape, rois):
    """``(r, rank, layout)`` for the launcher: ``uncrop_layout`` and its
    array, kept per layout of float32 rois that need no copy, so a
    serve's repeated shapes skip the work (at most 64 layouts)."""
    key = (shape, rois.shape, rois.stride())
    hit = _LAYOUTS.get(key) if rois.dtype == torch.float32 else None
    if hit is not None:
        return rois, hit[0], hit[1]
    r, sizes, strides = uncrop_layout(shape, rois)
    args = len(sizes), uncrop_launch_layout(sizes, strides)
    if r is rois:
        if len(_LAYOUTS) >= 64:
            _LAYOUTS.clear()
        _LAYOUTS[key] = args
    return (r,) + args


def uncrop_boxes_cuda(boxes, rois, *, bounds, crop_size: int):
    """The CUDA kernel's wrapper: same arguments and result as
    ``uncrop_boxes_torch``, for tensors on one CUDA device.  The kernel
    reads the rois through their broadcast against the boxes
    (``uncrop_layout``): one launch a call, no copy of float32 rois.
    Raises on any other device, on a layout ``uncrop_layout`` refuses,
    on a missing kernel library and on a failed launch."""
    global UNCROP_LAUNCHES
    launch = build.function("roi", "uncrop_boxes_launch", _UNCROP_ARGS)
    dev = build.cuda_device("uncrop_boxes_cuda", boxes, rois)
    if boxes.shape[-1] != 4 or boxes.numel() // 4 >= 2 ** 31:
        raise ValueError(f"uncrop_boxes_cuda: boxes {tuple(boxes.shape)}"
                         " are not (..., 4) with fewer than 2**31 boxes")
    b = build.operand(boxes, torch.float32, align16=True)
    r, rank, layout = _uncrop_launch_args(b.shape, rois)
    out = torch.empty_like(b)
    N = b.numel() // 4
    if N:
        # ctypes rounds each scale to float32, as the plain version does
        err = launch(b.data_ptr(), r.data_ptr(), N, rank, layout,
                     float(crop_size), float(bounds[0]), float(bounds[1]),
                     out.data_ptr(), build.stream(dev))
        build.check(err, "uncrop_boxes_launch")
        UNCROP_LAUNCHES += 1
    return out
