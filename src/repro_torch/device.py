"""Where the port's entry points run.

Every entry point takes ``device``; ``None`` means ``cuda``.  The port
never carries on on the CPU by itself: ``device="cpu"`` is the caller's
explicit choice (the tests make it).
"""
from __future__ import annotations

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
