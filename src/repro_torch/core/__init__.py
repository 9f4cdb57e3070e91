"""The paper's pipeline pieces that carry no tensor code: streams,
executors, schedulers, the simulator, the sequence synchronizer and the
quality accounting.  Copies of the reference package's ``core`` modules
(``parallel`` is not carried over yet)."""
from .stream import (BENCHMARK_VIDEOS, ADL_RUNDLE_6, ETH_SUNNYDAY,
                     Frame, FrameStream, SyntheticVideo, VideoSpec)
from .executor import (DEVICE_PROFILES, MODEL_PROFILES, DetectorExecutor,
                       DeviceProfile, ModelProfile)
from .scheduler import (FCFSScheduler, LockstepRRScheduler,
                        ProportionalScheduler, WeightedRRScheduler,
                        make_scheduler)
from .simulator import SimResult, simulate
from .synchronizer import SequenceSynchronizer, SyncedFrame
from .quality import (ProxyDetector, evaluate_map, evaluate_map_dets,
                      evaluate_map_loop, evaluate_streams,
                      proxy_detect_fn_streams, track_quality)

__all__ = [
    "BENCHMARK_VIDEOS", "ADL_RUNDLE_6", "ETH_SUNNYDAY", "Frame",
    "FrameStream", "SyntheticVideo", "VideoSpec", "DEVICE_PROFILES",
    "MODEL_PROFILES", "DetectorExecutor", "DeviceProfile", "ModelProfile",
    "FCFSScheduler", "LockstepRRScheduler", "ProportionalScheduler",
    "WeightedRRScheduler", "make_scheduler", "SimResult", "simulate",
    "SequenceSynchronizer", "SyncedFrame", "ProxyDetector", "evaluate_map",
    "evaluate_map_dets", "evaluate_map_loop", "evaluate_streams",
    "proxy_detect_fn_streams", "track_quality",
]
