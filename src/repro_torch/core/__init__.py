"""The paper's pipeline: streams, executors, schedulers, the simulator,
the sequence synchronizer, the quality accounting and the parallel
detection controller (``parallel``: n-selection and ``ParallelDetector``,
whose tracked run keeps its track table on a device).  Copies of the
reference package's ``core`` modules."""
from .stream import (BENCHMARK_VIDEOS, ADL_RUNDLE_6, ETH_SUNNYDAY,
                     Frame, FrameStream, SyntheticVideo, VideoSpec)
from .executor import (DEVICE_PROFILES, MODEL_PROFILES, DetectorExecutor,
                       DeviceProfile, ModelProfile)
from .scheduler import (FCFSScheduler, LockstepRRScheduler,
                        ProportionalScheduler, WeightedRRScheduler,
                        make_scheduler)
from .simulator import SimResult, simulate
from .synchronizer import SequenceSynchronizer, SyncedFrame
from .parallel import (HUMAN_COMFORT_FPS, ParallelDetector, Report,
                       choose_n, n_range)
from .quality import (ProxyDetector, evaluate_map, evaluate_map_dets,
                      evaluate_map_loop, evaluate_streams,
                      proxy_detect_fn_streams, track_quality)

__all__ = [
    "BENCHMARK_VIDEOS", "ADL_RUNDLE_6", "ETH_SUNNYDAY", "Frame",
    "FrameStream", "SyntheticVideo", "VideoSpec", "DEVICE_PROFILES",
    "MODEL_PROFILES", "DetectorExecutor", "DeviceProfile", "ModelProfile",
    "FCFSScheduler", "LockstepRRScheduler", "ProportionalScheduler",
    "WeightedRRScheduler", "make_scheduler", "SimResult", "simulate",
    "SequenceSynchronizer", "SyncedFrame", "HUMAN_COMFORT_FPS",
    "ParallelDetector", "Report", "choose_n", "n_range", "ProxyDetector",
    "evaluate_map", "evaluate_map_dets", "evaluate_map_loop",
    "evaluate_streams", "proxy_detect_fn_streams", "track_quality",
]
