"""Serving package of the port: the NVR detection path of the reference
package's ``serving`` — ``DetectionEngine`` over the incremental
``ServingRuntime``, the ``TickPipeline`` (one fused tick body a tick:
a CUDA-graph replay on the card), the NVR workload
builders and the transprecise cascade (model catalog, ``ModelSelector``,
ROI second pass).  Every ``FrameRequest`` carries a ``stream_id`` naming its
camera (default 0); ``rid`` stays globally unique across cameras.  See
``serving.engine`` for the contract.

Sharded serving (``serving.sharded``): ``ShardedDetectionEngine``
partitions the camera set over shards, each a full ``DetectionEngine``,
optionally runs the detection over a mesh of devices
(``make_spmd_detect``), and merges the per-shard reports into one
(``merge_shard_reports``, ``merge_epoch_shard_reports``); with
``rebalance=True`` it steals whole camera streams between shards at
epoch boundaries.  Fault injection and supervision (``serving.faults``,
``serving.supervisor``): a ``FaultSchedule`` of virtual-time replica and
shard failures, detected by service timeout, and a ``Watchdog`` that
restarts dead shards, evacuates their cameras and lends replicas.

Always-on serving: ``serving.events`` derives a push-side event pipeline
from the same ``obs.TraceRecorder`` log (``EventBus`` / ``TapRecorder`` /
``JsonlSink``); ``launch.daemon`` drives ``ServingRuntime`` from a
clock.  Token payloads: ``ServingEngine`` serves ``Request``s of an LLM
(``models``, ``configs``) on the same replica and scheduler machinery."""
from .cascade import ModelSelector
from .engine import (DetectionEngine, DetectionResponse, FrameRequest,
                     ReplicaExecutor, Request, Response, ServingEngine,
                     resolve_device)
from .events import EventBus, JsonlSink, TapRecorder, topic_of
from .faults import (FaultEvent, FaultSchedule, ReplicaFaultView,
                     ShardFaultCursor)
from .models import (ModelCatalog, ModelProfile, make_cascade_detect_fn,
                     paper_catalog)
from .nvr import make_nvr_streams, make_skewed_streams
from .pipeline import TickPipeline, TickState, roi_second_pass
from .runtime import ServingRuntime
from .sharded import (ShardedDetectionEngine, make_spmd_detect,
                      merge_epoch_shard_reports, merge_shard_reports)
from .supervisor import Watchdog

__all__ = ["DetectionEngine", "DetectionResponse", "EventBus",
           "FaultEvent", "FaultSchedule", "FrameRequest", "JsonlSink",
           "ModelCatalog", "ModelProfile", "ModelSelector",
           "ReplicaFaultView", "Request", "Response", "ReplicaExecutor",
           "ServingEngine", "ServingRuntime", "ShardFaultCursor",
           "ShardedDetectionEngine", "TapRecorder", "TickPipeline",
           "TickState", "Watchdog", "make_cascade_detect_fn",
           "make_nvr_streams", "make_skewed_streams", "make_spmd_detect",
           "merge_epoch_shard_reports", "merge_shard_reports",
           "paper_catalog", "resolve_device", "roi_second_pass",
           "topic_of"]
