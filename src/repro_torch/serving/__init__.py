"""Serving package of the port: the NVR detection path of the reference
package's ``serving`` — ``DetectionEngine`` over the incremental
``ServingRuntime``, the ``TickPipeline`` (staged, or one fused tick
body a tick: a CUDA-graph replay on the card), the NVR workload
builder and the transprecise cascade (model catalog, ``ModelSelector``,
ROI second pass).  Every ``FrameRequest`` carries a ``stream_id`` naming its
camera (default 0); ``rid`` stays globally unique across cameras.  See
``serving.engine`` for the contract."""
from .cascade import ModelSelector
from .engine import (DetectionEngine, DetectionResponse, FrameRequest,
                     ReplicaExecutor, resolve_device)
from .models import (ModelCatalog, ModelProfile, make_cascade_detect_fn,
                     paper_catalog)
from .nvr import make_nvr_streams
from .pipeline import TickPipeline, TickState
from .runtime import ServingRuntime

__all__ = ["DetectionEngine", "DetectionResponse", "FrameRequest",
           "ModelCatalog", "ModelProfile", "ModelSelector",
           "ReplicaExecutor", "ServingRuntime", "TickPipeline",
           "TickState", "make_cascade_detect_fn", "make_nvr_streams",
           "paper_catalog", "resolve_device"]
