"""Sharding of the detection-serving surface: the NVR camera partition
over shards and the frame/detection placement over a mesh of torch
devices (``serving_rules``).  The model-side rules and the mesh context
of the reference package (``rules.py``, ``context.py``) are not ported
yet."""
from .serving_rules import (constrain_detections, constrain_frames,
                            frame_blocks, mesh_devices, rebalance_streams,
                            shard_streams, streams_of_shard)

__all__ = ["constrain_detections", "constrain_frames", "frame_blocks",
           "mesh_devices", "rebalance_streams", "shard_streams",
           "streams_of_shard"]
