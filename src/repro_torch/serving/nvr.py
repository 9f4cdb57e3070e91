"""Synthetic multi-camera (NVR) workload builders for the serving
engines' multi-stream path (the port of the reference package's
``serving/nvr.py``): evenly paced cameras (``make_nvr_streams``) and the
skewed trace of the work-stealing tests (``make_skewed_streams``).  Pure
Python and numpy: the same seeds give the same traces as the
reference."""
from __future__ import annotations

import numpy as np

from ..core.quality import ProxyDetector
from ..core.stream import ETH_SUNNYDAY, SyntheticVideo
from ..sharding.serving_rules import shard_streams
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


def make_skewed_streams(n_streams: int, n_frames: int, rate: float,
                        n_shards: int, skew: float = 2.0,
                        video: SyntheticVideo | None = None,
                        model: str = "yolov3"):
    """Skewed NVR trace for the work-stealing benchmark: the cameras the
    static round-robin partition (``shard_streams``) assigns to shard 0
    run at ``skew x rate`` — with ``skew x n_frames`` frames, so every
    camera spans the SAME ``n_frames / rate`` time horizon — while the
    rest pace ``n_frames`` at ``rate``.  This concentrates the paper's
    §III rate mismatch on one shard: under the static partition, shard
    0 drops frames while its neighbors idle; a work-stealing dispatcher
    should migrate one of shard 0's hot cameras away.

    Frame rids are assigned in global arrival order (ties broken by
    stream id), so they are globally unique and deterministic.  Returns
    the same ``(frames, frame_of, videos, detectors)`` tuple as
    ``make_nvr_streams``."""
    video = video if video is not None else SyntheticVideo(ETH_SUNNYDAY)
    name = video.spec.name
    shard_of = shard_streams(range(n_streams), n_shards)
    events = []
    for s in range(n_streams):
        factor = skew if shard_of[s] == 0 else 1.0
        r_s = rate * factor
        for k in range(int(round(n_frames * factor))):
            events.append(((k + s / n_streams) / r_s, s, k))
    events.sort()
    frames, frame_of = [], {}
    for rid, (t, s, k) in enumerate(events):
        frames.append(FrameRequest(rid, np.zeros((4, 4, 3), np.float32),
                                   t, stream_id=s))
        frame_of[rid] = (s, k)
    videos = {s: video for s in range(n_streams)}
    detectors = {s: ProxyDetector(model, name, seed=s)
                 for s in range(n_streams)}
    return frames, frame_of, videos, detectors
