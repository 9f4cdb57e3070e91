"""Rules of the port that a parity test would not catch: it imports
neither JAX nor the reference package, its entry points never fall back
to the CPU by themselves, and its kernel wrappers never send a non-CPU
tensor to the plain version."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels import build, ops

REPO = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    for mod in _imported_modules(path):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib", "repro"), (path, mod)


def test_serving_imports_with_jax_blocked():
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "import repro_torch.serving, repro_torch.kernels.ops, "
            "repro_torch.detector, repro_torch.tracking, "
            "repro_torch.kernels.iou, repro_torch.kernels.flash_attention, "
            "repro_torch.kernels.decode_attention, "
            "repro_torch.kernels.rwkv_scan, repro_torch.kernels.ref, "
            "repro_torch.core.parallel, repro_torch.tracking.interpolate; "
            "assert 'jax' not in {m.split('.')[0] for m, v in "
            "sys.modules.items() if v is not None}; print('ok')")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_detection_engine_without_cuda_raises(monkeypatch):
    from repro_torch.serving import DetectionEngine
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetectionEngine()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DetectionEngine(device="cuda")
    assert DetectionEngine(device="cpu").device.type == "cpu"


def test_parallel_pipeline_without_cuda_raises(monkeypatch):
    """``ParallelDetector`` and ``fill_stream`` keep their track table on
    ``cuda`` unless the caller passes ``device="cpu"``."""
    from repro_torch.core import FrameStream, ParallelDetector, simulate
    from repro_torch.tracking import fill_stream
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParallelDetector("ETH-Sunnyday", "yolov3", ["ncs2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ParallelDetector("ETH-Sunnyday", "yolov3", ["ncs2"], device="cuda")
    det = ParallelDetector("ETH-Sunnyday", "yolov3", ["ncs2"], device="cpu")
    assert det.device.type == "cpu"
    paced = simulate(FrameStream(det.video), det.scheduler)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fill_stream(det.video, paced, det.detector)
    assert len(fill_stream(det.video, paced, det.detector,
                           device="cpu")) == paced.n_frames


def _entry_points():
    from repro_torch.detector import SSDConfig, init_ssd, params_from_numpy
    from repro_torch.serving import TickPipeline
    from repro_torch.serving.pipeline import build_tracker_state
    from repro_torch.tracking import TrackerConfig, init_state, rows_to_state
    from repro_torch.tracking.kalman import init_cov
    cfg = TrackerConfig(capacity=4)
    w = torch.zeros((1, 1, 1, 1)).numpy()
    tree = {"backbone": [{"w": w, "b": w[0, 0, 0]}],
            "head8": {"w": w, "b": w[0, 0, 0]},
            "head16": {"w": w, "b": w[0, 0, 0]}}
    return {
        "TickPipeline": lambda **kw: TickPipeline(cfg, **kw).device,
        "TickPipeline(fused=True)": lambda **kw: TickPipeline(
            cfg, fused=True, **kw).device,
        "build_tracker_state": lambda **kw: build_tracker_state(
            None, [0, 1], cfg, **kw).active.device,
        "init_state": lambda **kw: init_state(2, cfg, **kw).active.device,
        "rows_to_state": lambda **kw: rows_to_state(
            [None], cfg, **kw).active.device,
        "init_cov": lambda **kw: init_cov((2, 3, 4), 9.0, 25.0,
                                          **kw).device,
        "init_ssd": lambda **kw: init_ssd(
            SSDConfig(channels=(4, 4)), torch.Generator().manual_seed(0),
            **kw)["head8"]["w"].device,
        "params_from_numpy": lambda **kw: params_from_numpy(
            tree, **kw)["head8"]["w"].device,
    }


@pytest.mark.parametrize("name", sorted(_entry_points()))
def test_entry_points_default_to_cuda(monkeypatch, name):
    """Every entry point that places tensors runs on ``cuda`` unless the
    caller passes ``device="cpu"``; without CUDA the default raises."""
    make = _entry_points()[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make()
    assert make(device="cpu").type == "cpu"


def _nms_args(device):
    return (torch.zeros((2, 40, 4), device=device),
            torch.zeros((2, 40), device=device))


def _assign_args(device):
    return (torch.zeros((2, 6, 4), device=device),
            torch.zeros((2, 5, 4), device=device))


def _crop_args(device):
    return (torch.zeros((2, 16, 16, 3), device=device),
            torch.zeros((2, 4, 4), device=device))


def _uncrop_args(device):
    return (torch.zeros((2, 4, 32, 4), device=device),
            torch.zeros((2, 4, 1, 4), device=device))


def _iou_args(device):
    return (torch.zeros((5, 4), device=device),
            torch.zeros((3, 4), device=device))


def _flash_args(device):
    return tuple(torch.zeros((1, 2, 128, 32), device=device)
                 for _ in range(3))


def _decode_args(device):
    return (torch.zeros((2, 4, 32), device=device),
            torch.zeros((2, 64, 2, 32), device=device),
            torch.zeros((2, 64, 2, 32), device=device))


def _rwkv_args(device):
    x = torch.zeros((1, 2, 16, 8), device=device)
    return (x, x, x, x, torch.zeros((2, 8), device=device),
            torch.zeros((1, 2, 8, 8), device=device))


NEW_CALLS = {"iou_matrix": (_iou_args, {}),
             "flash_attention": (_flash_args, {}),
             "decode_attention": (_decode_args, {}),
             "rwkv_scan": (_rwkv_args, {}),
             "nms_serial": (lambda d: (torch.zeros((6, 4), device=d),
                                       torch.zeros((6,), device=d)),
                            {"max_out": 4})}


def _call(kernel, device):
    """One call of ``ops.<kernel>`` on small tensors on ``device``."""
    if kernel in NEW_CALLS:
        make, kw = NEW_CALLS[kernel]
        return getattr(ops, kernel)(*make(device), **kw)
    if kernel == "batched_nms":
        return ops.batched_nms(*_nms_args(device), score_thr=0.4)
    if kernel == "greedy_assign":
        return ops.greedy_assign(*_assign_args(device))
    if kernel == "crop_resize":
        return ops.crop_resize(*_crop_args(device), out_size=8)
    return ops.uncrop_boxes(*_uncrop_args(device), bounds=(1.0, 1.0),
                            crop_size=64)


KERNELS = ["batched_nms", "greedy_assign", "crop_resize", "uncrop_boxes",
           "iou_matrix", "flash_attention", "decode_attention", "rwkv_scan"]
PLAIN = ["batched_nms_torch", "greedy_assign_torch", "crop_resize_torch",
         "uncrop_boxes_torch", "iou_matrix_torch", "flash_attention_torch",
         "decode_attention_torch", "rwkv_scan_torch"]


@pytest.mark.parametrize("kernel", KERNELS + ["nms_serial"])
def test_wrappers_raise_when_library_missing(monkeypatch, kernel):
    """A non-CPU tensor goes to the kernel's wrapper and never to the
    plain version: with the library loader failing, the call raises and
    no launch is counted.  (A meta tensor stands in for a CUDA tensor.)"""
    def missing(*a, **k):
        raise build.KernelBuildError("kernel library missing")

    def plain(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(build, "function", missing)
    for name in PLAIN:
        monkeypatch.setattr(ops, name, plain)
    before = ops.launches()
    with pytest.raises(build.KernelBuildError):
        _call(kernel, "meta")
    assert ops.launches() == before


@pytest.mark.parametrize("kernel", ["crop_resize", "uncrop_boxes"])
def test_roi_wrappers_refuse_non_cuda_tensors(monkeypatch, kernel):
    """With the library loaded, a tensor that is neither on the CPU nor
    on a CUDA device (meta) reaches the CUDA wrapper, which raises
    before launching: no launch, no plain version, no count."""
    launched = []

    def loader(*a, **k):
        return lambda *args: launched.append(args) or 0

    def plain(*a, **k):
        raise AssertionError("plain version called for a meta tensor")

    monkeypatch.setattr(build, "function", loader)
    for name in PLAIN:
        monkeypatch.setattr(ops, name, plain)
    before = ops.launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        _call(kernel, "meta")
    assert not launched and ops.launches() == before


def test_reset_launches_zeroes_every_counter(monkeypatch):
    from repro_torch.kernels import (association, decode_attention,
                                     flash_attention, iou, nms, roi,
                                     rwkv_scan)
    for mod, attr in ((nms, "LAUNCHES"), (association, "LAUNCHES"),
                      (roi, "CROP_LAUNCHES"), (roi, "UNCROP_LAUNCHES"),
                      (iou, "LAUNCHES"), (flash_attention, "LAUNCHES"),
                      (decode_attention, "LAUNCHES"),
                      (rwkv_scan, "LAUNCHES")):
        monkeypatch.setattr(mod, attr, 7)
    assert set(ops.launches()) == set(KERNELS)
    assert set(ops.launches().values()) == {7}
    ops.reset_launches()
    assert ops.launches() == {k: 0 for k in KERNELS}


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    """Where no nvcc exists the build raises; nothing falls back."""
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(build, "DEFAULT_CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "_libs", {})
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        ops.batched_nms(*_nms_args("meta"))


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel loader")

    monkeypatch.setattr(build, "function", no_build)
    before = ops.launches()
    keep, valid = ops.batched_nms(*_nms_args("cpu"))
    match = ops.greedy_assign(*_assign_args("cpu"))
    crops = _call("crop_resize", "cpu")
    boxes = _call("uncrop_boxes", "cpu")
    assert keep.shape == (2, 64) and valid.shape == (2, 64)
    assert match.shape == (2, 6)
    assert crops.shape == (2, 4, 8, 8, 3) and boxes.shape == (2, 4, 32, 4)
    assert _call("iou_matrix", "cpu").shape == (5, 3)
    assert _call("flash_attention", "cpu").shape == (1, 2, 128, 32)
    assert _call("decode_attention", "cpu").shape == (2, 4, 32)
    out, state = _call("rwkv_scan", "cpu")
    assert out.shape == (1, 2, 16, 8) and state.shape == (1, 2, 8, 8)
    keep, valid = _call("nms_serial", "cpu")
    assert keep.shape == (4,) and valid.shape == (4,)
    assert ops.launches() == before


def test_library_names_track_source_and_flags():
    p = build.library_path("nms")
    assert p.parent == build.BUILD_DIR and p.suffix == ".so"
    for name in ("nms", "association", "roi", "iou", "rwkv_scan"):
        assert "-fmad=false" in build.flags(name), name
    for name in build.SOURCES:
        assert "--use_fast_math" not in build.flags(name), name
        assert any("sm_90a" in f for f in build.flags(name)), name
    assert (build.CSRC / "nms.cu").is_file()
    assert (build.CSRC / "association.cu").is_file()
    assert "roi" in build.SOURCES and (build.CSRC / "roi.cu").is_file()
    assert set(build.SOURCES) >= {"iou", "flash_attention",
                                  "decode_attention", "rwkv_scan"}
    assert all((build.CSRC / f"{n}.cu").is_file() for n in build.SOURCES)


WRAPPERS = {"iou_matrix_cuda": ("iou", _iou_args, {}),
            "flash_attention_cuda": ("flash_attention", _flash_args, {}),
            "decode_attention_cuda": ("decode_attention", _decode_args, {}),
            "rwkv_scan_cuda": ("rwkv_scan", _rwkv_args, {})}


@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_new_cuda_wrappers_refuse_non_cuda_tensors(monkeypatch, wrapper,
                                                   device):
    """With the library loaded, each new CUDA wrapper called on CPU (or
    meta) tensors raises before launching: nothing launched, nothing
    counted, no plain version."""
    import importlib
    module, make, kw = WRAPPERS[wrapper]
    mod = importlib.import_module(f"repro_torch.kernels.{module}")
    launched = []

    def loader(*a, **k):
        return lambda *args: launched.append(args) or 0

    monkeypatch.setattr(build, "function", loader)
    before = ops.launches()
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(mod, wrapper)(*make(device), **kw)
    assert not launched and ops.launches() == before


def test_library_names_track_each_sources_flags(monkeypatch):
    """Changing one source's flags renames that source's library and no
    other's."""
    before = {n: build.library_path(n) for n in build.SOURCES}
    base = build.flags
    monkeypatch.setattr(build, "flags", lambda n: base(n) + (
        ("-lineinfo",) if n == "decode_attention" else ()))
    after = {n: build.library_path(n) for n in build.SOURCES}
    assert [n for n in build.SOURCES if after[n] != before[n]] == [
        "decode_attention"]


def test_library_names_track_shared_headers(monkeypatch, tmp_path):
    """Editing a shared ``csrc/*.cuh`` header renames every library, so
    no library built against the old header loads."""
    (tmp_path / "a.cu").write_text('#include "common.cuh"\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = build.library_path("a")
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert build.library_path("a") != before
    assert (build.CSRC / "a.cu").is_file()
    assert (REPO / "src/repro_torch/kernels/csrc/common.cuh").is_file()
