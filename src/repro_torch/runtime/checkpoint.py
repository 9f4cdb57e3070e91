"""Dependency-free checkpointing (the port of the reference package's
``runtime/checkpoint.py``), with the reference's layout: one
``arrays.npz`` of every leaf under its path string (``jax``'s
``keystr``: ``['params']['embed']['table']``, ``[0]`` for a list index)
and a ``manifest.json`` with ``step`` and the sorted ``keys``, written to
``<path>.tmp`` (a stale one removed first) and renamed into place.

numpy has no bfloat16, so a bfloat16 leaf is stored as its 16-bit
pattern (``uint16``) and the manifest's ``dtypes`` names it; it restores
bit for bit.  The reference's ``np.savez`` writes a bfloat16 leaf as raw
two-byte records (``V2``), which its own restore cannot cast
(``ROADMAP.md`` section 3); here such a leaf restores into a bfloat16
``like`` by the same view of its bits.
"""
from __future__ import annotations

import json
import shutil
from pathlib import Path
from typing import Any

import numpy as np
import torch

from ..device import resolve_device


def _flatten(tree, prefix=""):
    """(path string, leaf) pairs in ``jax.tree_util`` order: dict keys
    sorted, list items in order."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flatten(tree[k], f"{prefix}[{k!r}]")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _flatten(v, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def _unflatten(like, leaves, prefix=""):
    if isinstance(like, dict):
        return {k: _unflatten(v, leaves, f"{prefix}[{k!r}]")
                for k, v in like.items()}
    if isinstance(like, list):
        return [_unflatten(v, leaves, f"{prefix}[{i}]")
                for i, v in enumerate(like)]
    return leaves[prefix]


def save_checkpoint(path: str | Path, tree: Any, step: int = 0):
    path = Path(path)
    tmp = path.with_name(path.name + ".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves, dtypes = {}, {}
    for key, x in _flatten(tree):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            dtypes[key] = "bfloat16"
            leaves[key] = x.view(torch.int16).numpy().view(np.uint16)
        else:
            leaves[key] = x.numpy()
    np.savez(tmp / "arrays.npz", **leaves)
    manifest = {"step": step, "keys": sorted(leaves), "dtypes": dtypes}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if path.exists():
        shutil.rmtree(path)
    tmp.rename(path)
    return path


def restore_checkpoint(path: str | Path, like: Any, device=None):
    """Restore into the structure and dtypes of ``like``, on ``device``
    (None: ``cuda``, raising where no CUDA device exists)."""
    device = resolve_device(device)
    path = Path(path)
    manifest = json.loads((path / "manifest.json").read_text())
    bf16 = {k for k, d in manifest.get("dtypes", {}).items()
            if d == "bfloat16"}
    out = {}
    with np.load(path / "arrays.npz") as data:
        for key, ref in _flatten(like):
            arr = data[key]
            if arr.shape != tuple(ref.shape):
                raise ValueError(f"{key}: stored shape {arr.shape}, "
                                 f"expected {tuple(ref.shape)}")
            if key in bf16 or (arr.dtype.kind == "V" and arr.itemsize == 2
                               and ref.dtype == torch.bfloat16):
                t = torch.from_numpy(arr.view(np.int16).copy()).view(
                    torch.bfloat16)
            else:
                t = torch.from_numpy(np.array(arr))
            out[key] = t.to(device=device, dtype=ref.dtype)
    return _unflatten(like, out)


def checkpoint_step(path: str | Path) -> int:
    return json.loads((Path(path) / "manifest.json").read_text())["step"]
