"""Where the port's entry points run.

Every entry point takes ``device``; ``None`` means ``cuda``.  The port
never carries on on the CPU by itself: ``device="cpu"`` is the caller's
explicit choice (the tests make it).  ``ieee_float32`` keeps the port's
float32 convolutions and matrix products out of TF32.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch


def resolve_device(device=None) -> torch.device:
    """``device``, or ``cuda`` when it is None.  Raises when CUDA is
    asked for (explicitly or by default) and no CUDA device exists."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the GPU unless the caller "
            "passes device='cpu'")
    return dev


@contextmanager
def ieee_float32():
    """Run float32 convolutions and matrix products in IEEE float32
    inside, whatever the process-wide TF32 settings say, and restore
    every setting it changed on exit.  Usable as a decorator.

    PyTorch lets cuDNN convolutions use TF32 by default
    (``torch.backends.cudnn.allow_tf32`` is True), and since 2.9 it has
    a second control per operation (``torch.backends.cudnn.conv``,
    ``torch.backends.cuda.matmul``: ``fp32_precision``) that interacts
    with the first: setting the legacy flag rewrites the per-operation
    ones, and reading the legacy flag raises once the two disagree.  So
    both are held, the legacy flag first (skipped where it cannot be
    read), then the per-operation precision, which is what the kernels
    consult where it exists.  ``torch.backends.cudnn.flags`` is not used:
    it also turns cuDNN off unless every argument is passed."""
    cudnn, cuda = torch.backends.cudnn, torch.backends.cuda
    undo = []

    def hold(obj, attr, value):
        try:
            old = getattr(obj, attr)
        except RuntimeError:    # the two APIs disagree: leave the flag
            return
        if old != value:
            setattr(obj, attr, value)
            undo.append((obj, attr, old))

    hold(cudnn, "allow_tf32", False)
    hold(cuda.matmul, "allow_tf32", False)
    for op in (getattr(cudnn, "conv", None), cuda.matmul):
        if op is not None and hasattr(op, "fp32_precision"):
            hold(op, "fp32_precision", "ieee")
    try:
        yield
    finally:
        for obj, attr, old in reversed(undo):
            setattr(obj, attr, old)
