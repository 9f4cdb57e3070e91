"""Synthetic multi-camera (NVR) workload builder for the serving
engine's multi-stream path (the port of the reference package's
``serving/nvr.py``).  Pure Python and numpy: the same seeds give the
same trace as the reference."""
from __future__ import annotations

import numpy as np

from ..core.quality import ProxyDetector
from ..core.stream import ETH_SUNNYDAY, SyntheticVideo
from .engine import FrameRequest


def make_nvr_streams(n_streams: int, n_frames: int, rate: float,
                     video: SyntheticVideo | None = None,
                     model: str = "yolov3"):
    """``n_streams`` cameras each pacing ``n_frames`` at ``rate`` FPS
    with phase-staggered arrivals so the streams interleave, plus
    per-camera proxy detectors (distinct seeds) over the same
    benchmark scene.  Returns ``(frames, frame_of, videos,
    detectors)`` where ``frame_of`` maps the globally-unique rid back
    to ``(stream_id, per-stream frame index)`` — the tuple
    ``core.quality.proxy_detect_fn_streams`` consumes."""
    video = video if video is not None else SyntheticVideo(ETH_SUNNYDAY)
    name = video.spec.name
    frames, frame_of = [], {}
    rid = 0
    for k in range(n_frames):
        for s in range(n_streams):
            frames.append(FrameRequest(
                rid, np.zeros((4, 4, 3), np.float32),
                (k + s / n_streams) / rate, stream_id=s))
            frame_of[rid] = (s, k)
            rid += 1
    videos = {s: video for s in range(n_streams)}
    detectors = {s: ProxyDetector(model, name, seed=s)
                 for s in range(n_streams)}
    return frames, frame_of, videos, detectors
