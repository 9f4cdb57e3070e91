"""Build the hand-written CUDA kernels at first use and load them.

Each ``csrc/<name>.cu`` exports a plain C launcher.  It is compiled by
``nvcc`` for ``sm_90a`` into its own shared library under the repo's
``build/kernels/`` directory and loaded with ``ctypes``; no PyTorch
header is compiled, so a build takes seconds.  All sources are compiled
together (one ``nvcc`` process each, started at once) the first time any
kernel is needed.  A library's file name carries a hash of its source,
the shared headers (``csrc/*.cuh``) and its flags, so an edited source
is rebuilt and a stale one never loads.

Flags are chosen per source (``flags``).  ``-fmad=false`` is part of
the contract of the threshold kernels (``EXACT_SOURCES``), not a tuning
flag: without it nvcc contracts ``area + area - inter`` and
``(x1 - x0) * (y1 - y0) + a`` into fused multiply-adds, and an IoU
compared against a threshold then flips on one ULP relative to the
reference.  The RWKV scan keeps it too: its state must equal the plain
version's bit for bit, each operation rounded once.  The two attention
kernels drop it: each compiles its float32 and bfloat16 instances from
one template and writes its hot sums with explicit ``__fmaf_rn`` /
``__fmul_rn`` / ``__fadd_rn``, so contraction cannot make the instances
differ.  The routed-experts and MLA decode kernels drop it too: their dot
products are fused multiply-adds (or tensor-core products) by design,
held to the plain versions by a tolerance.
Division and ``expf`` stay IEEE everywhere (no ``--use_fast_math``).

Every wrapper takes its launcher (``function``), its device
(``cuda_device``), its operands (``operand``) and the current stream's
handle (``stream``) from here, and hands the launcher's error code to
``check``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("nms", "association", "roi", "iou", "flash_attention",
           "decode_attention", "rwkv_scan", "routed_experts", "mla_decode")
DEFAULT_CUDA_HOME = "/usr/local/cuda"
BASE_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC")
# bit-exact against the reference's operation order (the scan: its
# state): no fused multiply-add
EXACT_SOURCES = ("nms", "association", "roi", "iou", "rwkv_scan")

_libs: Dict[str, ctypes.CDLL] = {}
# (library, symbol) -> (the library it came from, its argtypes, the
# launcher with them set); an entry counts only while _libs still holds
# that library
_fns: Dict[Tuple[str, str], Tuple[ctypes.CDLL, tuple, ctypes._CFuncPtr]] = {}


def flags(name: str) -> tuple:
    """nvcc flags of source ``name``: ``BASE_FLAGS``, plus
    ``-fmad=false`` for the ``EXACT_SOURCES``."""
    return BASE_FLAGS + (("-fmad=false",) if name in EXACT_SOURCES else ())


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
    """Where source ``name``'s library goes: the name carries a hash of
    the source, of every shared header in ``csrc/`` and of its flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(flags(name)).encode()).hexdigest()
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
            cmd = [cc, *flags(n), "-o", str(tmp), str(CSRC / f"{n}.cu")]
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
    error code of its launch (0 = success).  The launcher is looked up
    and given its ``argtypes`` once; later calls return it from a cache
    that a reset of ``_libs`` empties.  Raises ``ValueError`` when a
    later call asks for other ``argtypes`` than the first."""
    argtypes = tuple(argtypes)
    hit = _fns.get((name, symbol))
    if hit is not None and _libs.get(name) is hit[0]:
        if hit[1] != argtypes:
            raise ValueError(f"{symbol}: argtypes {argtypes} differ from "
                             f"the {hit[1]} it was loaded with")
        return hit[2]
    if name not in _libs:
        for n, p in build().items():
            if n not in _libs:
                _libs[n] = ctypes.CDLL(str(p))
    lib = _libs[name]
    fn = getattr(lib, symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    _fns[(name, symbol)] = (lib, argtypes, fn)
    return fn


def operand(t: torch.Tensor, dtype=None, align16: bool = False):
    """``t`` as a launcher's operand: of ``dtype`` (its own where None),
    contiguous, and starting on 16 bytes where ``align16`` (the kernel
    loads it in 16-byte words).  A tensor that already is goes through
    untouched, with no dispatcher call."""
    if dtype is not None and t.dtype != dtype:
        t = t.to(dtype)
    if not t.is_contiguous():
        t = t.contiguous()
    return t.clone() if align16 and t.data_ptr() % 16 else t


def cuda_device(what: str, *tensors: torch.Tensor) -> torch.device:
    """The one CUDA device that all ``tensors`` lie on; raises
    ``ValueError`` naming the wrapper ``what`` on any other device or on
    two devices.  Compares device indices (ints), which costs less host
    time than building a ``torch.device`` for each tensor."""
    idx = tensors[0].get_device()
    if not tensors[0].is_cuda or any(t.get_device() != idx
                                     for t in tensors[1:]):
        raise ValueError(f"{what} takes CUDA tensors on one device, got "
                         f"{[str(t.device) for t in tensors]}")
    return tensors[0].device


def stream(dev: torch.device) -> int:
    """The handle of PyTorch's current stream on CUDA device ``dev``,
    read without building a ``torch.cuda.Stream`` object (which takes
    longer on the host than the small kernels take on the card)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


def check(err: int, what: str) -> None:
    """Raise if a launcher reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
