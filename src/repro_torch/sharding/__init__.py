"""Mesh-free sharding hooks: logical axis names and the port's mesh type
(``context``), path-based parameter/input rules for the model surface
(``rules``), and the frame/detection placement over a mesh of torch
devices plus the NVR camera partition for the serving surface
(``serving_rules``)."""
from .context import (LOGICAL_AXES, Mesh, PartitionSpec, active_mesh,
                      constrain, logical_to_mesh, mesh_context, resolve_spec)
from .rules import (batch_spec, constrain_like_params, input_shardings,
                    param_shardings, param_specs, sharded_bytes)
from .serving_rules import (constrain_detections, constrain_frames,
                            frame_blocks, mesh_devices, rebalance_streams,
                            shard_streams, streams_of_shard)

__all__ = [
    "LOGICAL_AXES", "Mesh", "PartitionSpec", "active_mesh", "batch_spec",
    "constrain", "constrain_detections", "constrain_frames",
    "constrain_like_params", "frame_blocks", "input_shardings",
    "logical_to_mesh", "mesh_context", "mesh_devices", "param_shardings",
    "param_specs", "rebalance_streams", "resolve_spec", "shard_streams",
    "sharded_bytes", "streams_of_shard",
]
