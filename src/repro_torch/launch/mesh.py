"""Mesh definitions (the port of the reference package's
``launch/mesh.py``).

The production meshes are sizes only: the dry run needs the axis sizes
to resolve specs and per-device bytes, never the devices (the reference
fakes 512 host devices through ``XLA_FLAGS`` for its lowering; PyTorch
has no such switch, and nothing here is lowered).  The replica, host and
serving meshes hold real torch devices: ``cuda`` unless the caller asks
for ``cpu``.
"""
from __future__ import annotations

from typing import Tuple

import torch

from ..device import resolve_device
from ..sharding.context import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """16x16 = 256 chips per pod; 2 pods = 512 chips multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def visible_devices(device=None) -> Tuple[torch.device, ...]:
    """The devices of ``device``'s type this process sees: every CUDA
    card for ``cuda`` (None), the one host device for ``cpu``."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        return tuple(torch.device("cuda", i)
                     for i in range(torch.cuda.device_count()))
    return (dev,)


def _mesh(shape, axes, device) -> Mesh:
    avail = visible_devices(device)
    n = shape[0] * shape[1]
    if n > len(avail):
        raise ValueError(f"a {shape} mesh needs {n} devices but only "
                         f"{len(avail)} are visible")
    return Mesh(axes, shape, avail[:n])


def make_replica_mesh(n_replicas: int, chips_per_replica: int = 1,
                      device=None) -> Mesh:
    """Paper-mode mesh: n parallel detection-model replicas over the
    ``replica`` axis (the paper's n NCS2 sticks), each replica spanning
    ``chips_per_replica`` model-parallel devices."""
    return _mesh((n_replicas, chips_per_replica), ("data", "model"), device)


def make_host_mesh(device=None) -> Mesh:
    """Every visible device of ``device``'s type on the ``data`` axis."""
    n = len(visible_devices(device))
    return _mesh((n, 1), ("data", "model"), device)


def make_serving_mesh(n_shards: int | None = None,
                      device=None) -> Tuple[str, ...]:
    """Serve-mode mesh for sharded NVR detection: ``n_shards`` devices,
    one a shard, as the sequence of torch device names that
    ``sharding.serving_rules.mesh_devices`` takes (``("cuda:0",
    "cuda:1")``).

    Defaults to one shard per visible device.  Raises ``ValueError`` if
    fewer CUDA devices are visible than shards.  On the CPU every shard
    is the host device (``("cpu",) * n_shards``), as the reference fakes
    host devices for its CPU meshes."""
    dev = resolve_device(device)
    avail = len(visible_devices(dev))
    n = n_shards if n_shards is not None else avail
    if dev.type == "cpu":
        return ("cpu",) * n
    if n > avail:
        raise ValueError(
            f"make_serving_mesh({n}) needs {n} devices but only {avail} "
            "are visible")
    return tuple(f"cuda:{i}" for i in range(n))
