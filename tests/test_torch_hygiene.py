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
            "repro_torch.detector, repro_torch.tracking; "
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


@pytest.mark.parametrize("kernel", ["batched_nms", "greedy_assign"])
def test_wrappers_raise_when_library_missing(monkeypatch, kernel):
    """A non-CPU tensor goes to the kernel's wrapper and never to the
    plain version: with the library loader failing, the call raises and
    no launch is counted.  (A meta tensor stands in for a CUDA tensor.)"""
    def missing(*a, **k):
        raise build.KernelBuildError("kernel library missing")

    def plain(*a, **k):
        raise AssertionError("plain version called for a non-CPU tensor")

    monkeypatch.setattr(build, "function", missing)
    monkeypatch.setattr(ops, "batched_nms_torch", plain)
    monkeypatch.setattr(ops, "greedy_assign_torch", plain)
    before = ops.launches()
    with pytest.raises(build.KernelBuildError):
        if kernel == "batched_nms":
            ops.batched_nms(*_nms_args("meta"), score_thr=0.4)
        else:
            ops.greedy_assign(*_assign_args("meta"))
    assert ops.launches() == before


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
    assert keep.shape == (2, 64) and valid.shape == (2, 64)
    assert match.shape == (2, 6)
    assert ops.launches() == before


def test_library_names_track_source_and_flags():
    p = build.library_path("nms")
    assert p.parent == build.BUILD_DIR and p.suffix == ".so"
    assert "-fmad=false" in build.NVCC_FLAGS
    assert "--use_fast_math" not in build.NVCC_FLAGS
    assert any("sm_90a" in f for f in build.NVCC_FLAGS)
    assert (build.CSRC / "nms.cu").is_file()
    assert (build.CSRC / "association.cu").is_file()
    assert all((build.CSRC / f"{n}.cu").is_file() for n in build.SOURCES)
