"""What surrounds the two kernels of redesign 3, on the CPU.

``csrc/roi.cu``'s crop kernel now cuts each window's output rows into
tiles chosen by ``roi.crop_split`` (windows on the grid's x axis, row
tiles on y), builds a gather map of one output row in shared memory and
writes rows with a scalar head, 16-byte stores and a scalar tail.  Its
uncrop kernel reads the rois through their broadcast against the boxes,
from the sizes and strides ``roi.uncrop_layout`` gives.  Neither kernel
runs here, so these tests hold what the designs rest on:

* ``crop_split`` covers every output row of every window exactly once,
  within the launch limits, and fills about a wave of SMs at the
  serve's one-frame batches;
* a torch emulation of a CTA's gather map and store split writes each
  output element once, every vector store on 16 bytes, and equals
  ``crop_resize_torch`` bit for bit;
* a ``torch.as_strided`` emulation of the uncrop kernel's index split
  over ``uncrop_layout`` equals ``uncrop_boxes_torch`` bit for bit on
  broadcast, flat, sliced and offset rois, and the serve's float32 view
  goes through uncopied;
* the wrappers hand the launchers these cuts and layouts, refuse what
  ``uncrop_layout`` refuses and a crop row whose gather map passes the
  shared memory before any launch, ``build.function`` keeps each
  launcher with its argtypes set, and ``build.operand`` leaves a ready
  operand untouched.

The emulations live here, not in the package: the package's CPU path is
the plain version."""
import ctypes
import types

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import build
from repro_torch.kernels import roi as kroi
from repro_torch.kernels.roi import (crop_resize_torch, crop_split,
                                     uncrop_boxes_torch, uncrop_layout)

MAX_SMEM = 232448          # bytes of shared memory a CTA can opt into
MAX_GRID_Y = 65535


# ----------------------------------------------------------------- crop
def _windows(rng, B, R, span=0.5):
    a = rng.uniform(0.0, 0.6, (B, R, 2)).astype(np.float32)
    b = np.minimum(a + rng.uniform(0.05, span, (B, R, 2)), 1.0)
    return torch.from_numpy(np.concatenate([a, b.astype(np.float32)], -1))


SPLIT_SHAPES = {              # (B, R, C, ch)
    "serve B=1": (1, 4, 64, 3),
    "serve B=8": (8, 4, 64, 3),
    "C=13 ch=3": (2, 4, 13, 3),
    "48x80 ch=1": (3, 4, 64, 1),
    "C=96": (8, 4, 96, 3),
    "70000 windows C=4": (17500, 4, 4, 1),
}


@pytest.mark.parametrize("name", list(SPLIT_SHAPES))
def test_crop_split_covers_every_row_once(name):
    B, R, C, ch = SPLIT_SHAPES[name]
    rows, threads = crop_split(B, R, C, ch)
    tiles = -(-C // rows)
    assert 1 <= rows <= C and threads % 32 == 0 and 32 <= threads <= 1024
    assert B * R <= 2 ** 31 - 1 and tiles <= MAX_GRID_Y
    assert 4 * (C * ch + rows) <= MAX_SMEM
    hits = torch.zeros((B * R, C), dtype=torch.int32)
    for y in range(tiles):            # CTA (win, y): rows y*rows.. of win
        i0 = y * rows
        hits[:, i0:i0 + min(rows, C - i0)] += 1
    assert bool((hits == 1).all())


def test_crop_split_fills_a_wave_at_the_serve():
    """One-frame micro-batches (B=1, R=4, C=64): at least 128 CTAs on the
    132 SMs (the first port launched 4); B=8 gets no fewer."""
    def ctas(B):
        rows, _ = crop_split(B, 4, 64, 3)
        return B * 4 * -(-64 // rows)
    assert ctas(1) >= 128
    assert ctas(8) >= ctas(1)


@pytest.mark.parametrize("shape,split", [
    ((1, 4, 64, 3), (2, 64)),           # the serve: 128 CTAs
    ((8, 4, 64, 3), (16, 256)),         # 128 CTAs of 16 rows
    ((8, 4, 96, 3), (8, 256)),          # 16 rows would pass 16 KB a CTA
    ((2, 4, 13, 3), (1, 32)),           # 104 CTAs even at one row each
    ((17500, 4, 4, 1), (4, 128))])      # a whole window a CTA
def test_crop_split_values(shape, split):
    assert crop_split(*shape) == split


def _src_index(i, C, lo, hi, S):
    """``src_index`` in ``csrc/roi.cu``: float32, that operation order,
    clipped as floats and then cast."""
    f = (i.float() + 0.5) / float(C)
    d = hi - lo
    t = f * d
    u = lo + t
    v = torch.floor(u * float(S))
    return torch.clamp(v, 0.0, float(S - 1)).long()


def crop_emulated(images, rois, C, base=0):
    """The crop kernel's CTAs in torch: per (window, row tile) the
    gather map of one row and its rows' source rows, then per row a
    scalar head to the first 16-byte boundary of the output (its floats
    counted from an output base ``base`` floats past 16 bytes), float4
    stores and a scalar tail.  Returns (out, writes per element)."""
    B, H, W, ch = images.shape
    R = rois.shape[1]
    rows, _ = crop_split(B, R, C, ch)
    row = C * ch
    n = B * R * C * row
    flat = torch.full((base + n,), float("nan"))
    writes = torch.zeros(base + n, dtype=torch.int32)
    img = images.reshape(B, -1)
    rw = rois.reshape(-1, 4)
    col = torch.arange(row)
    for win in range(B * R):
        x0, y0, x1, y1 = rw[win]
        j = col // ch
        gmap = _src_index(j, C, x0, x1, W) * ch + (col - j * ch)
        for i0 in range(0, C, rows):
            nrows = min(rows, C - i0)
            ys = _src_index(torch.arange(i0, i0 + nrows), C, y0, y1, H)
            for il in range(nrows):
                src = img[win // R, ys[il] * W * ch:]
                s = base + (win * C + i0 + il) * row
                head = min(row, (-s) % 4)
                nvec = (row - head) // 4
                body = head + 4 * torch.arange(nvec)[:, None] + torch.arange(
                    4)
                assert bool(((s + body[:, 0]) % 4 == 0).all())
                parts = [torch.arange(head), body.reshape(-1),
                         torch.arange(head + 4 * nvec, row)]
                for c in parts:
                    flat[s + c] = src[gmap[c]]
                    writes[s + c] += 1
    return flat[base:].reshape(B, R, C, C, ch), writes[base:]


def _crop_case(name):
    rng = np.random.default_rng(len(name))
    if name == "48x80 ch=1":
        B, H, W, ch, C = 3, 48, 80, 1, 64
    elif name == "C=13 ch=3":
        B, H, W, ch, C = 2, 64, 64, 3, 13
    else:
        B, H, W, ch, C = (8 if "B=8" in name else 1), 64, 64, 3, 64
    images = torch.from_numpy(rng.random((B, H, W, ch)).astype(np.float32))
    rois = _windows(rng, B, 4)
    if name == "one source pixel":
        rois[0, 0] = torch.tensor([0.5, 0.5, 0.5 + 0.25 / W,
                                   0.5 + 0.25 / H])
        rois[0, 1] = 0.0                          # zero area: pixel (0, 0)
    return images, rois, C


@pytest.mark.parametrize("name,base", [
    ("serve B=1", 0), ("serve B=8", 0), ("C=13 ch=3", 0),
    ("48x80 ch=1", 0), ("one source pixel", 0), ("serve B=1", 1),
    ("C=13 ch=3", 2)])
def test_crop_emulation_writes_once_and_equals_plain(name, base):
    images, rois, C = _crop_case(name)
    out, writes = crop_emulated(images, rois, C, base)
    assert bool((writes == 1).all())
    assert torch.equal(out, crop_resize_torch(images, rois, out_size=C))


# --------------------------------------------------------------- uncrop
def uncrop_emulated(boxes, rois, *, bounds, crop_size):
    """The uncrop kernel in torch: box n of the (N, 4) boxes split into
    its leading indices (last dim fastest), its roi read at the storage
    offset of ``uncrop_layout``'s strides, then ((b / C) * (x1 - x0) +
    x0) * W, rounded after every operation."""
    r, sizes, strides = uncrop_layout(boxes.shape, rois)
    storage = r.as_strided((r.untyped_storage().nbytes() // 4,), (1,), 0)
    assert torch.equal(torch.as_strided(storage, tuple(sizes) + (4,),
                                        tuple(strides) + (1,),
                                        r.storage_offset()),
                       rois.float().expand(boxes.shape))
    b = boxes.float().reshape(-1, 4)
    rem = torch.arange(b.shape[0])
    off = torch.full_like(rem, r.storage_offset())
    for d in range(len(sizes) - 1, 0, -1):
        q = rem // sizes[d]
        off += (rem - q * sizes[d]) * strides[d]
        rem = q
    if sizes:
        off += rem * strides[0]
    x0, y0, x1, y1 = storage[off[:, None] + torch.arange(4)].unbind(-1)
    C = torch.tensor(float(crop_size))
    W, H = torch.tensor(float(bounds[0])), torch.tensor(float(bounds[1]))
    out = torch.stack([((b[:, 0] / C) * (x1 - x0) + x0) * W,
                       ((b[:, 1] / C) * (y1 - y0) + y0) * H,
                       ((b[:, 2] / C) * (x1 - x0) + x0) * W,
                       ((b[:, 3] / C) * (y1 - y0) + y0) * H], -1)
    return out.reshape(boxes.shape)


def _norm(rng, lead):
    return _windows(rng, 1, int(np.prod(lead))).reshape(lead + (4,))


def _uncrop_case(name):
    """(boxes, rois)."""
    rng = np.random.default_rng(len(name))
    lead = {"flat (1000,)": (1000,), "(1,5,1) against (3,5,7)": (3, 5, 7),
            "equal shapes": (3, 5, 7)}.get(name, (8, 4, 32))
    boxes = torch.from_numpy(rng.uniform(0, 64, lead + (4,)).astype(
        np.float32))
    if name == "(8,4,32) against (8,4,1)":
        return boxes, _norm(rng, (8, 4, 1))
    if name == "equal shapes":
        return boxes, _norm(rng, lead)
    if name == "flat (1000,)":
        return boxes, _norm(rng, lead)
    if name == "rois (4,)":
        return boxes, _norm(rng, (1,)).reshape(4)
    if name == "(1,5,1) against (3,5,7)":
        return boxes, _norm(rng, (1, 5, 1))
    if name == "serve view":
        return boxes, _norm(rng, (8, 4))[:, :, None, :]
    if name == "serve view sliced from a wider tensor":
        wide = torch.zeros((8, 4, 6))
        wide[:, :, 1:5] = _norm(rng, (8, 4))
        return boxes, wide[:, :, 1:5][:, :, None, :]
    raise KeyError(name)


UNCROP_CASES = ["(8,4,32) against (8,4,1)", "equal shapes", "flat (1000,)",
                "rois (4,)", "(1,5,1) against (3,5,7)", "serve view",
                "serve view sliced from a wider tensor"]


@pytest.mark.parametrize("bounds", [(1.0, 1.0), (123.4, 55.5)])
@pytest.mark.parametrize("name", UNCROP_CASES)
def test_uncrop_emulation_equals_plain(name, bounds):
    boxes, rois = _uncrop_case(name)
    got = uncrop_emulated(boxes, rois, bounds=bounds, crop_size=64)
    assert torch.equal(got, uncrop_boxes_torch(boxes, rois, bounds=bounds,
                                               crop_size=64))


@pytest.mark.parametrize("name", UNCROP_CASES)
def test_uncrop_layout_does_not_copy_float32_rois(name):
    """The layout is ``rois.expand(boxes.shape)``'s, worked out with no
    view and no copy."""
    boxes, rois = _uncrop_case(name)
    r, sizes, strides = uncrop_layout(boxes.shape, rois)
    assert r is rois
    assert sizes == tuple(boxes.shape[:-1])
    assert strides == rois.expand(boxes.shape).stride()[:-1]


def test_uncrop_layout_copies_only_where_it_must():
    boxes = torch.ones((2, 3, 4))
    wide = torch.arange(2 * 3 * 8, dtype=torch.float32).reshape(2, 3, 8)
    r, _, strides = uncrop_layout(boxes.shape, wide[..., ::2])
    assert r.stride(-1) == 1 and torch.equal(r, wide[..., ::2])
    r, _, _ = uncrop_layout(boxes.shape, wide[..., :4].double())
    assert r.dtype == torch.float32
    serve = wide[:, :, None, :4]
    r, _, strides = uncrop_layout((2, 3, 5, 4), serve)
    assert r.data_ptr() == serve.data_ptr() and strides == (24, 8, 0)


@pytest.mark.parametrize("boxes_shape,rois_shape", [
    ((1,) * 9 + (4,), (4,)),            # 9 leading dims: past the limit
    ((2, 4, 4), (3, 4)),                # 3 against 4
    ((4, 4), (2, 4, 4)),                # more dims than the boxes
    ((8, 4, 32, 4), (8, 3, 1, 4))])
def test_uncrop_layout_raises(boxes_shape, rois_shape):
    with pytest.raises(ValueError):
        uncrop_layout(boxes_shape, torch.zeros(rois_shape))


def test_uncrop_layout_takes_eight_leading_dims():
    boxes = torch.ones((1,) * 7 + (3,) + (4,))
    rois = _norm(np.random.default_rng(3), (3,))
    _, sizes, strides = uncrop_layout(boxes.shape, rois)
    assert len(sizes) == 8 and strides[-1] == 4
    got = uncrop_emulated(boxes, rois, bounds=(2.0, 3.0), crop_size=8)
    assert torch.equal(got, uncrop_boxes_torch(boxes, rois, bounds=(2.0, 3.0),
                                               crop_size=8))


# ------------------------------------------------------------- wrappers
class _Recorder:
    """Stands in for a launcher: records its arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def host_path(monkeypatch):
    """The wrappers' host path on CPU tensors: the device check passes,
    the stream is 0, the launcher records.  Launch counters restored."""
    rec = _Recorder()
    monkeypatch.setattr(build, "function", lambda *a, **k: rec)
    monkeypatch.setattr(build, "cuda_device", lambda what, *t: t[0].device)
    monkeypatch.setattr(build, "stream", lambda dev: 0)
    monkeypatch.setattr(kroi, "CROP_LAUNCHES", 0)
    monkeypatch.setattr(kroi, "UNCROP_LAUNCHES", 0)
    return rec


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket.__name__))
        return func(*args, **(kwargs or {}))


def test_crop_wrapper_launches_crop_split(host_path):
    images, rois, C = _crop_case("serve B=1")
    with _Ops() as seen:
        kroi.crop_resize_cuda(images, rois, out_size=C)
    (args,) = host_path.calls
    assert args[:2] == (images.data_ptr(), rois.data_ptr())
    assert args[2:10] == (1, 4, 64, 64, 3, 64) + crop_split(1, 4, 64, 3)
    assert seen.ops == ["empty"] and kroi.CROP_LAUNCHES == 1


def test_uncrop_wrapper_reads_the_serve_view_uncopied(host_path):
    boxes, rois = _uncrop_case("serve view")
    with _Ops() as seen:
        kroi.uncrop_boxes_cuda(boxes, rois, bounds=(1.0, 1.0), crop_size=64)
    (args,) = host_path.calls
    b, r, N, rank, layout = args[:5]
    assert (b, r, N, rank) == (boxes.data_ptr(), rois.data_ptr(), 1024, 3)
    assert list(layout) == [8, 4, 32] + [1] * 5 + [16, 4, 0] + [0] * 5
    assert args[5:8] == (64.0, 1.0, 1.0)
    assert seen.ops == ["empty_like"]
    kroi.uncrop_boxes_cuda(boxes, rois, bounds=(1.0, 1.0), crop_size=64)
    assert host_path.calls[1][4] is layout      # the shapes' cached layout
    assert kroi.UNCROP_LAUNCHES == 2


def test_uncrop_wrapper_copies_only_rois_it_must(host_path):
    """A roi layout the kernel cannot read (last dim not unit-stride) is
    copied, and such a copy is never cached as the rois' layout."""
    boxes = torch.ones((2, 3, 5, 4))
    wide = torch.rand(2, 3, 1, 8)
    for _ in range(2):
        kroi.uncrop_boxes_cuda(boxes, wide[..., ::2], bounds=(1.0, 1.0),
                               crop_size=64)
    for args in host_path.calls:
        assert args[1] != wide.data_ptr()
        assert list(args[4])[8:11] == [60, 20, 4]


@pytest.mark.parametrize("boxes_shape,rois_shape", [
    ((1,) * 9 + (4,), (4,)), ((8, 4, 32, 4), (8, 3, 1, 4))],
    ids=["rank 9", "no broadcast"])
def test_uncrop_wrapper_raises_before_launching(host_path, boxes_shape,
                                                rois_shape):
    with pytest.raises(ValueError):
        kroi.uncrop_boxes_cuda(torch.zeros(boxes_shape),
                               torch.zeros(rois_shape), bounds=(1, 1),
                               crop_size=64)
    assert not host_path.calls and kroi.UNCROP_LAUNCHES == 0


@pytest.mark.parametrize("C,ch", [(4000, 16), (1200, 64)])
def test_crop_wrapper_refuses_a_map_past_shared_memory(host_path, C, ch):
    """A row of C * ch floats needs a gather map of 4 * C * ch bytes in
    one CTA's shared memory: past what a CTA can opt into, the wrapper
    raises before any launch."""
    rows, _ = crop_split(1, 1, C, ch)
    assert 4 * (C * ch + rows) > kroi.CROP_MAX_SMEM and C * C * ch < 2 ** 31
    with pytest.raises(ValueError, match="shared memory"):
        kroi.crop_resize_cuda(torch.zeros((1, 8, 8, ch)),
                              torch.zeros((1, 1, 4)), out_size=C)
    assert not host_path.calls and kroi.CROP_LAUNCHES == 0


def test_build_operand_leaves_a_ready_operand_untouched():
    x = torch.rand(8, 4)
    with _Ops() as seen:
        assert build.operand(x, torch.float32, align16=True) is x
        assert build.operand(x) is x
    assert seen.ops == []
    y = build.operand(x.double(), torch.float32)
    assert y.dtype == torch.float32 and torch.equal(y, x)
    t = x.t()
    assert build.operand(t).is_contiguous() and torch.equal(
        build.operand(t), t)
    off = x.reshape(-1)[1:5]                    # 4 bytes past 16
    assert off.data_ptr() % 16 == 4
    assert build.operand(off) is off
    z = build.operand(off, torch.float32, align16=True)
    assert z.data_ptr() % 16 == 0 and torch.equal(z, off)
    m = build.operand(torch.tensor([1, 0, 2]), torch.bool)
    assert m.dtype == torch.bool and m.tolist() == [True, False, True]


def test_build_function_caches_the_launcher(monkeypatch):
    class Lib:
        def __init__(self):
            self.looked = []

        def __getattr__(self, symbol):
            self.looked.append(symbol)
            return types.SimpleNamespace()

    def no_build(*a, **k):
        raise build.KernelBuildError("no nvcc")

    lib = Lib()
    monkeypatch.setattr(build, "_libs", {"roi": lib})
    monkeypatch.setattr(build, "_fns", {})
    monkeypatch.setattr(build, "build", no_build)
    f1 = build.function("roi", "crop_resize_launch", kroi._CROP_ARGS)
    f2 = build.function("roi", "crop_resize_launch", kroi._CROP_ARGS)
    assert f1 is f2 and lib.looked == ["crop_resize_launch"]
    assert f1.argtypes == tuple(kroi._CROP_ARGS)
    assert f1.restype is ctypes.c_int
    with pytest.raises(ValueError, match="argtypes"):
        build.function("roi", "crop_resize_launch", kroi._CROP_ARGS[:-1])
    assert lib.looked == ["crop_resize_launch"]
    monkeypatch.setattr(build, "_libs", {})       # a reset drops it
    with pytest.raises(build.KernelBuildError):
        build.function("roi", "crop_resize_launch", kroi._CROP_ARGS)
    lib2 = Lib()
    build._libs["roi"] = lib2
    f3 = build.function("roi", "crop_resize_launch", kroi._CROP_ARGS)
    assert f3 is not f1 and lib2.looked == ["crop_resize_launch"]


# ------------------------------------------------------------ chip_smoke
def _smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_smoke_finds_the_op_before_each_uncrop_on_its_stream():
    """The profile's check that no copy runs beside the uncrop: the
    device op just before each ``uncrop_kernel`` on its own stream,
    whatever ran on another stream in between."""
    cuda = torch.autograd.DeviceType.CUDA

    def ev(name, t, stream=7):
        return types.SimpleNamespace(
            name=name, device_type=cuda, device_resource_id=stream,
            time_range=types.SimpleNamespace(start=t))
    copy = ("void at::native::unrolled_elementwise_kernel<at::native::"
            "direct_copy_kernel_cuda(at::TensorIteratorBase&)>(int)")
    prof = types.SimpleNamespace(events=lambda: [
        ev("(anonymous namespace)::crop_kernel(float const*)", 1),
        ev(copy, 2, stream=9),
        ev("(anonymous namespace)::uncrop_kernel(float4 const*)", 3),
        ev(copy, 4),
        ev("(anonymous namespace)::uncrop_kernel(float4 const*)", 5),
        ev("Memcpy DtoH (Device -> Pageable)", 6)])
    assert _smoke()._device_ops_before(prof, "::uncrop_kernel") == {
        "crop_kernel": 1, "direct_copy_kernel_cuda": 1}
