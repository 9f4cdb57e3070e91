"""Dropped-frame interpolation (the port of the reference package's
``tracking/interpolate.py``): run the tracker over a simulated run's
processed frames and synthesize tracker-predicted boxes for every frame
the executors never saw.

Where the synchronizer's stale-reuse fill replays the last processed
frame's boxes verbatim (a zero-velocity prediction, the mechanism behind
the paper's mAP collapse), ``fill_stream`` coasts every confirmed track
through the gap, so a dropped frame gets motion-compensated boxes.  The
track table (B=1, T=``cfg.capacity``) lives on ``device``; its
association step runs the assignment kernel on ``cuda``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.synchronizer import SequenceSynchronizer
from ..device import resolve_device
from . import tracker as trk
from .tracker import TrackerConfig


@dataclass
class TrackedFrame:
    """Per-arrival-frame output of the tracked stream.  Processed frames
    carry their own (fresh) detections; dropped frames carry the
    tracker-predicted boxes and are tagged ``interpolated``."""
    index: int
    boxes: np.ndarray        # (N, 4) xyxy
    scores: np.ndarray       # (N,)
    classes: np.ndarray      # (N,)
    track_ids: np.ndarray    # (N,) int32, -1 if the detection joined no track
    interpolated: bool


def _detect_all(video, processed: Sequence[int], detector, det_by_frame):
    """Proxy detections for every processed frame, batched per detector
    (one vectorized noise-synthesis call per model)."""
    groups: Dict[int, tuple] = {}
    for i in processed:
        det = (det_by_frame or {}).get(i, detector)
        groups.setdefault(id(det), (det, []))[1].append(i)
    out = {}
    for det, idxs in groups.values():
        if hasattr(det, "detect_many"):
            det.detect_many(video, idxs)
        for i in idxs:
            out[i] = det.detect(video, i)
    return out


def fill_stream(video, result, detector, det_by_frame=None,
                cfg: Optional[TrackerConfig] = None,
                device=None) -> List[TrackedFrame]:
    """Tracked output stream for a ``SimResult``: every arrival frame
    yields a TrackedFrame, processed frames feeding the tracker and
    dropped frames coasting it.  The sequence synchronizer decides the
    emission order and the interpolated tagging (``order_tracked``);
    this function fills in the boxes.  The tracker runs on ``device``
    (None: ``cuda``, raising where no CUDA device exists), staged:
    ``step`` per processed frame, ``coast`` and ``output`` per dropped
    one, with the detection width padded to a multiple of 8."""
    device = resolve_device(device)
    cfg = cfg or TrackerConfig()
    ordered = SequenceSynchronizer().order_tracked(result)
    processed = sorted(sf.index for sf in ordered if not sf.stale)
    dets = _detect_all(video, processed, detector, det_by_frame)
    d_cap = max([len(d.boxes) for d in dets.values()] + [1])
    d_cap += -d_cap % 8          # one detection width for the whole run
    state = trk.init_state(1, cfg, device=device)
    out: List[TrackedFrame] = []
    for sf in ordered:
        i = sf.index
        if not sf.interpolated:
            d = dets[i]
            n = len(d.boxes)
            boxes = np.zeros((1, d_cap, 4), np.float32)
            scores = np.zeros((1, d_cap), np.float32)
            classes = np.zeros((1, d_cap), np.int32)
            valid = np.zeros((1, d_cap), bool)
            boxes[0, :n] = d.boxes
            scores[0, :n] = d.scores
            classes[0, :n] = d.classes
            valid[0, :n] = True
            state, det_tid = trk.step(
                state, *(torch.from_numpy(a).to(device)
                         for a in (boxes, scores, classes, valid)), cfg)
            out.append(TrackedFrame(i, d.boxes, d.scores, d.classes,
                                    det_tid.cpu().numpy()[0, :n], False))
        else:
            state = trk.coast(state, cfg)
            b, s, c, tid, emit = (a.cpu().numpy() for a in
                                  trk.output(state, cfg))
            m = emit[0]
            out.append(TrackedFrame(i, b[0][m], s[0][m], c[0][m],
                                    tid[0][m], True))
    return out
