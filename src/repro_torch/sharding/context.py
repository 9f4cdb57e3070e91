"""Mesh-free sharding hooks (the port of the reference package's
``sharding/context.py``).

Model code annotates activations with *logical* axis names via
``constrain(x, "batch", None, "tensor")``.  Outside a mesh context this is
an identity; inside ``mesh_context(mesh)`` the names resolve to mesh axes
with the reference's divisibility fallbacks (``resolve_spec``).

A ``Mesh`` here is the port's own small type: axis names and sizes, and
optionally the torch devices laid out over them (a production mesh for
the dry run has sizes only).  A ``PartitionSpec`` is a tuple with one
entry per tensor dim: None, one mesh axis name, or a tuple of names, as
``jax.sharding.PartitionSpec`` holds them.
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Dict, Optional, Sequence, Tuple

import torch

_state = threading.local()

# logical axis -> preferred mesh axes (in order; filtered by mesh presence)
LOGICAL_AXES = {
    "batch": ("pod", "data"),        # global batch / token parallelism
    "fsdp": ("pod", "data"),         # parameter (ZeRO-3 style) sharding
    "tensor": ("model",),            # head / ff / vocab tensor parallelism
    "expert": ("model",),            # expert parallelism
    "kv_len": ("data", "model"),     # KV-cache length sharding (decode)
    "seq": ("model",),               # sequence-parallel activations (train)
    "replica": ("data",),            # paper's n parallel detection models
}


class PartitionSpec(tuple):
    """Per-dim mesh axes of a tensor: ``PartitionSpec("data", None)``."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


@dataclass(frozen=True)
class Mesh:
    """Named mesh axes with their sizes, and the torch devices over them
    (row-major over ``axis_names``), or None for a mesh of sizes only."""
    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"{self.axis_names} vs sizes {self.sizes}")
        if self.devices is not None and len(self.devices) != self.size:
            raise ValueError(f"{len(self.devices)} devices for a mesh of "
                             f"{self.size}")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def active_mesh() -> Optional[Mesh]:
    return getattr(_state, "mesh", None)


@contextlib.contextmanager
def mesh_context(mesh: Mesh):
    prev = getattr(_state, "mesh", None)
    _state.mesh = mesh
    try:
        yield mesh
    finally:
        _state.mesh = prev


def logical_to_mesh(name: Optional[str], mesh: Mesh) -> Tuple[str, ...]:
    if name is None:
        return ()
    return tuple(a for a in LOGICAL_AXES[name] if a in mesh.axis_names)


def resolve_spec(logical: Sequence[Optional[str]], shape,
                 mesh: Mesh) -> PartitionSpec:
    """Logical per-dim names -> PartitionSpec with divisibility fallback."""
    entries = []
    used = set()
    sizes = mesh.shape
    for dim, name in zip(shape, logical):
        axes = tuple(a for a in logical_to_mesh(name, mesh) if a not in used)
        size = 1
        for a in axes:
            size *= sizes[a]
        if axes and size > 1 and dim % size == 0:
            entries.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        else:
            # per-axis partial fallback: try the single largest dividing axis
            picked = None
            for a in axes:
                if dim % sizes[a] == 0 and sizes[a] > 1:
                    picked = a
                    break
            if picked is not None:
                entries.append(picked)
                used.add(picked)
            else:
                entries.append(None)
    return PartitionSpec(*entries)


def constrain(x, *logical: Optional[str]):
    """Annotate activation ``x`` with logical axes; identity off-mesh.

    On a mesh the spec is resolved (and a rank mismatch raises, as in
    the reference), but ``x`` comes back unchanged: eager PyTorch has no
    partitioner for such an annotation to steer, and the port runs each
    model on one device."""
    mesh = active_mesh()
    if mesh is None:
        return x
    if x.ndim != len(logical):
        raise ValueError(f"rank mismatch {tuple(x.shape)} vs {logical}")
    resolve_spec(logical, x.shape, mesh)
    return x
