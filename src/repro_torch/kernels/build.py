"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` exports a plain C launcher.  It is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under the repo's
``build/kernels/`` directory and loaded with ``ctypes``; no PyTorch
header is compiled, so a build takes seconds.  All sources are compiled
together (one ``nvcc`` process each, started at once) the first time any
kernel is needed.  A library's file name carries a hash of its source
and flags, so an edited source is rebuilt and a stale one never loads.

``-fmad=false`` is part of the contract, not a tuning flag: without it
nvcc contracts ``area + area - inter`` and ``(x1 - x0) * (y1 - y0) + a``
into fused multiply-adds, and an IoU compared against a threshold then
flips on one ULP relative to the reference.  Division stays IEEE (no
``--use_fast_math``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("nms", "association")
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas=-v", "-shared",
              "-Xcompiler", "-fPIC")

_libs: Dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """A kernel library could not be built or loaded."""


def nvcc() -> str:
    """Path of the CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on ``PATH``."""
    for home in (os.environ.get("CUDA_HOME"), DEFAULT_CUDA_HOME):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise KernelBuildError(
            "nvcc not found (set CUDA_HOME or put nvcc on PATH): the CUDA "
            "kernels cannot be built on this host")
    return found


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    tag = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"{name}-{tag[:12]}.so"


def build(names: Sequence[str] = SOURCES) -> Dict[str, Path]:
    """Compile every named source that has no up-to-date library, all
    in parallel.  Returns ``{name: library path}``; raises
    ``KernelBuildError`` with the compiler's output if any build fails.
    ``build/kernels/<name>.log`` keeps each compiler's output (ptxas
    register and shared-memory counts included)."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.is_file()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        cc = nvcc()
        procs = {}
        for n, p in todo.items():
            tmp = p.with_suffix(f".{os.getpid()}.tmp")
            cmd = [cc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
            procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                         stderr=subprocess.STDOUT,
                                         text=True), tmp)
        failed = []
        for n, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            (BUILD_DIR / f"{n}.log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"{n}.cu (exit {proc.returncode}):\n{out}")
                continue
            os.replace(tmp, todo[n])
        if failed:
            raise KernelBuildError("nvcc failed for " + "\n".join(failed))
    return paths


def function(name: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C launcher ``symbol`` of kernel library ``name``, building
    the libraries first if needed.  Every launcher returns the CUDA
    error code of its launch (0 = success)."""
    if name not in _libs:
        for n, p in build().items():
            if n not in _libs:
                _libs[n] = ctypes.CDLL(str(p))
    fn = getattr(_libs[name], symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
