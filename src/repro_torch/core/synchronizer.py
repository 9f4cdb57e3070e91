"""Model-parallel sequence synchronizer (paper §III-A/III-C).

Parallel executors complete frames out of temporal order; the synchronizer
is a reorder buffer that (a) re-establishes the original stream order on
the detection-processed frames, and (b) fills every randomly-dropped frame
with the detection output of the latest processed frame before it (the
paper's stale-reuse semantics — the mechanism behind the mAP drop under
frame dropping).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

from .simulator import SimResult


@dataclass
class SyncedFrame:
    index: int
    source_index: int        # which processed frame supplied the detection
    stale: bool              # True if filled from an earlier frame
    t_ready: float           # when the detection became available
    interpolated: bool = False   # True if a tracker synthesized the fill


class SequenceSynchronizer:
    """Offline-friendly implementation over a SimResult; the streaming
    variant (used by examples/video_analytics.py) exposes push/pop with a
    bounded reorder window."""

    def __init__(self, window: int = 64):
        self.window = window

    def order(self, result: SimResult) -> List[SyncedFrame]:
        done_at: Dict[int, float] = {a.frame_idx: a.t_done
                                     for a in result.assignments}
        out: List[SyncedFrame] = []
        last_processed: Optional[int] = None
        last_t = 0.0
        for i in range(result.n_frames):
            if i in done_at:
                last_processed, last_t = i, done_at[i]
                out.append(SyncedFrame(i, i, False, done_at[i]))
            elif last_processed is not None:
                out.append(SyncedFrame(i, last_processed, True, last_t))
            else:
                out.append(SyncedFrame(i, -1, True, 0.0))
        return out

    # ---- streaming interface ------------------------------------------
    def stream(self, result: SimResult, tracked: bool = False):
        """Yield SyncedFrames in order as their detections become ready,
        respecting a bounded reorder window (emits a stale fill if a frame
        hasn't completed by the time the window slides past it).

        ``tracked=True`` streams the ``order_tracked`` tagging (dropped
        frames marked ``interpolated``); either way the flag is carried
        through on the re-yielded frames instead of being reset."""
        ordered = self.order_tracked(result) if tracked else self.order(result)
        emit_t = 0.0
        for sf in ordered:
            emit_t = max(emit_t, sf.t_ready)
            yield SyncedFrame(sf.index, sf.source_index, sf.stale, emit_t,
                              interpolated=sf.interpolated)

    def order_tracked(self, result: SimResult) -> List[SyncedFrame]:
        """Arrival-order output for the track-and-interpolate mode:
        processed frames are emitted as usual; every dropped frame is
        tagged ``interpolated`` — its boxes come from the tracker's
        coasted prediction instead of replaying ``source_index``
        (which is kept as the last frame that fed the tracker, i.e.
        the prediction's information horizon; -1 before the first
        processed frame, where the coasted table is still empty)."""
        return [SyncedFrame(sf.index, sf.source_index, sf.stale,
                            sf.t_ready, interpolated=sf.stale)
                for sf in self.order(result)]

    # ---- multi-camera (NVR) interface ---------------------------------
    @staticmethod
    def order_per_stream(responses):
        """Per-stream arrival-order emit for multi-camera serving: group
        engine responses by ``stream_id``, re-establish each camera's
        arrival order (``seq``), and attach a monotonic per-stream emit
        clock (a frame is never released before an earlier frame of the
        SAME stream — the reorder buffer is per camera, so one slow
        camera never holds back another).

        Returns ``{stream_id: (ordered_responses, emit_times)}``.
        """
        by_stream: Dict[int, List] = {}
        for r in responses:
            by_stream.setdefault(getattr(r, "stream_id", 0), []).append(r)
        out = {}
        for sid, rs in by_stream.items():
            rs.sort(key=lambda r: (getattr(r, "seq", -1), r.rid))
            emit_t, emits = 0.0, []
            for r in rs:
                emit_t = max(emit_t, r.t_done)
                emits.append(emit_t)
            out[sid] = (rs, emits)
        return out

    def output_fps(self, result: SimResult) -> float:
        frames = self.order(result)
        if not frames:
            return 0.0
        t_last = max(f.t_ready for f in frames)
        return len([f for f in frames if not f.stale]) / max(t_last, 1e-9)
