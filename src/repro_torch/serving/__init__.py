"""Serving package of the port: the NVR detection path of the reference
package's ``serving`` — ``DetectionEngine`` over the incremental
``ServingRuntime``, the staged ``TickPipeline`` and the NVR workload
builder.  Every ``FrameRequest`` carries a ``stream_id`` naming its
camera (default 0); ``rid`` stays globally unique across cameras.  See
``serving.engine`` for the contract."""
from .engine import (DetectionEngine, DetectionResponse, FrameRequest,
                     ReplicaExecutor, resolve_device)
from .nvr import make_nvr_streams
from .pipeline import TickPipeline, TickState
from .runtime import ServingRuntime

__all__ = ["DetectionEngine", "DetectionResponse", "FrameRequest",
           "ReplicaExecutor", "ServingRuntime", "TickPipeline",
           "TickState", "make_nvr_streams", "resolve_device"]
