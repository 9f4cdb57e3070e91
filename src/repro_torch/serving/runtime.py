"""Incremental serving core: the engine's virtual-time loop as a
long-lived runtime (the port of the reference package's
``serving/runtime.py``, single-engine part).

Frames are ``ingest``-ed in any chunking (one at a time, bursts, or the
whole trace), ``advance(to_t)`` runs every micro-batch whose membership
can no longer change, ``epoch_boundary()`` closes a reporting window
mid-serve, and ``drain()`` flushes the pipeline and returns the final
report.  ``DetectionEngine.serve`` is a one-shot ingest + drain.

Watermark contract
------------------
Across ``ingest`` calls the earliest arrival of each chunk must be >=
the latest arrival already ingested (ties allowed; within a chunk
frames are sorted stably).  ``advance(to_t)`` is the caller's promise
that every frame with ``t_arrival < to_t`` has been ingested; the core
then *seals* and runs precisely the micro-batches the one-shot path
would have formed:

* adaptive mode seals the head batch when ``t_now = max(head arrival,
  min replica busy_until) < to_t``;
* fixed ``micro_batch`` mode seals when ``micro_batch`` frames are
  queued and the last one arrived strictly before ``to_t``;
* ``drain()`` / ``advance(float("inf"))`` seals everything, including
  the partial tail batch.

The sharded cores, the cascade's ROI pass and the merge of several
epoch reports into one (``drain`` / ``report(rolling=False)`` after an
``epoch_boundary``) come with later slices.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..core.synchronizer import SequenceSynchronizer
from ..obs.metrics import detection_latency_keys
from ..obs.trace import NULL_RECORDER
from .engine import (DetectionEngine, DetectionResponse, FrameRequest,
                     _per_replica_counts)
from .models import cascade_report_keys
from .pipeline import sorted_chunk as _sorted_chunk

_INF = float("inf")


class _DetectionCore:
    """Incremental micro-batch loop of ONE ``DetectionEngine``.

    Holds the open *segment*: the frames since the last epoch boundary,
    the responses/drops produced so far, and the per-stream seq / emit
    floors that carry across segments."""

    def __init__(self, eng: DetectionEngine, *, reset: bool = True,
                 stream_seq0: Optional[Dict[int, int]] = None,
                 stream_emit0: Optional[Dict[int, float]] = None,
                 stream_tracks: Optional[Dict[int, dict]] = None):
        self.eng = eng
        if not eng._warm:
            eng.warmup()
        if reset:
            eng.reset()
        self._watermark = -_INF
        self._seq_next: Dict[int, int] = dict(stream_seq0 or {})
        self._emit0: Dict[int, float] = dict(stream_emit0 or {})
        # portable track rows carried across segments: stream_id -> row
        self._tracks0: Dict[int, dict] = dict(stream_tracks or {})
        self._seq_of: Dict[int, int] = {}
        self._epoch_reports: List[Dict] = []
        self._batch_no = 0
        self._new_segment()

    def _new_segment(self):
        self._queue: List[FrameRequest] = []
        self._qi = 0
        self._responses: List[DetectionResponse] = []
        self._dropped: List[FrameRequest] = []
        # warm-start stream set of THIS segment: every stream with a seq
        # floor appears in the segment report even with zero frames
        self._seg_warm = set(self._seq_next)
        self._fc0 = self.eng.scheduler.fault_counts()

    # ------------------------------------------------------------ ingest
    def ingest(self, frames):
        chunk = _sorted_chunk(frames)
        if not chunk:
            return
        if chunk[0].t_arrival < self._watermark:
            raise ValueError(
                f"ingest violates the watermark: frame rid={chunk[0].rid} "
                f"arrives at {chunk[0].t_arrival} < watermark "
                f"{self._watermark} — chunks must be non-decreasing in "
                "t_arrival across ingest calls")
        self._watermark = chunk[-1].t_arrival
        rec = self.eng.recorder
        for f in chunk:
            s = self._seq_next.get(f.stream_id, 0)
            self._seq_of[f.rid] = s
            self._seq_next[f.stream_id] = s + 1
            if rec.enabled:
                rec.record("arrive", f.t_arrival, rid=f.rid,
                           stream=f.stream_id, seq=s)
        self._queue.extend(chunk)

    # ----------------------------------------------------------- advance
    def _sealed(self, to_t: float) -> bool:
        q, i, eng = self._queue, self._qi, self.eng
        if i >= len(q):
            return False
        if to_t == _INF:
            return True
        if eng.micro_batch is not None:
            j = i + eng.micro_batch - 1
            return j < len(q) and q[j].t_arrival < to_t
        t_now = max(q[i].t_arrival,
                    min(r.busy_until for r in eng.replicas))
        return t_now < to_t

    def advance(self, to_t: float):
        while self._sealed(to_t):
            self._process_next_batch()

    def _process_next_batch(self):
        eng = self.eng
        frames = self._queue
        i = self._qi
        rec = eng.recorder
        seq_of = self._seq_of
        chunk = frames[i:i + eng._chunk_size(frames, i)]
        self._qi += len(chunk)
        if rec.enabled:
            if self._batch_no % 4 == 0:
                # queue depth + residual backlog sampled at the moment a
                # micro-batch forms, decimated 4:1
                t_q = max(chunk[0].t_arrival,
                          min(r.busy_until for r in eng.replicas))
                rec.sample("queue_depth", t_q, len(chunk))
                rec.sample("backlog_s", t_q, eng.scheduler.backlog(t_q))
            for f in chunk:
                rec.record("enqueue", f.t_arrival, rid=f.rid,
                           stream=f.stream_id, batch=self._batch_no)
        bno = self._batch_no
        self._batch_no += 1
        kept, assigns = [], []
        if eng.drop_when_busy:
            # the drop decision happens at arrival time, before this
            # batch's wall time exists: it uses the service estimate
            # from the previous batch
            for f in chunk:
                a = eng.scheduler.assign(f.rid, f.t_arrival)
                if a is None:
                    self._dropped.append(f)
                    if rec.enabled:
                        rec.record("drop", f.t_arrival, rid=f.rid,
                                   stream=f.stream_id, seq=seq_of[f.rid])
                    continue
                kept.append(f)
                assigns.append(a)
        else:
            kept = chunk
        if not kept:
            return
        images = np.stack([f.image for f in kept])
        b = eng.micro_batch or eng._bucket(len(kept))
        if len(kept) < b:                     # pad to the batch bucket
            pad = np.zeros((b - len(kept),) + images.shape[1:],
                           images.dtype)
            images = np.concatenate([images, pad], 0)
        (boxes, scores, classes, valid), wall = eng._detect_batch(
            images, rids=[f.rid for f in kept] + [-1] * (b - len(kept)))
        if rec.enabled:
            rec.record("stage", chunk[0].t_arrival, stage="detect",
                       batch=bno, frames=len(kept))
            rec.sample("stage_ms_detect", chunk[0].t_arrival,
                       wall * 1e3)
        per_frame = (wall / len(kept) if eng.service_time is None
                     else eng.service_time)
        for r in eng.replicas:
            r._last_wall = per_frame
        if not eng.drop_when_busy:
            # blocking mode assigns after the measurement, so this
            # batch's own wall time drives its virtual-clock slots; with
            # no healthy replica the frames take the drop-accounted path
            assigns = []
            for f in kept:
                if not eng.scheduler.any_healthy():
                    eng.scheduler.probe_health(f.t_arrival)
                if eng.scheduler.any_healthy():
                    assigns.append(eng.scheduler.blocking_assign(
                        f.rid, f.t_arrival))
                else:
                    assigns.append(None)
        for j, (f, a) in enumerate(zip(kept, assigns)):
            if a is None:
                self._dropped.append(f)
                if rec.enabled:
                    rec.record("drop", f.t_arrival, rid=f.rid,
                               stream=f.stream_id, seq=seq_of[f.rid])
                continue
            self._responses.append(DetectionResponse(
                f.rid, boxes[j], scores[j], classes[j], valid[j],
                a.executor_idx, a.t_start, a.t_done, per_frame,
                stream_id=f.stream_id, seq=seq_of[f.rid]))

    # ---------------------------------------------------------- finalize
    def _finalize_segment(self, *, record: bool = True) -> Dict:
        """Tracker interpolation, rid-order sort, per-stream reorder +
        emit events, per-stream stats, fault-count deltas and the latency
        block over the PROCESSED prefix of the open segment.
        ``record=False`` is the non-destructive peek ``report()`` uses."""
        eng = self.eng
        frames = self._queue[:self._qi]
        seq_of = self._seq_of
        dropped = self._dropped
        responses = self._responses if record else list(self._responses)
        rec = eng.recorder if record else NULL_RECORDER
        n_frames_stream: Dict[int, int] = {
            sid: 0 for sid in self._seg_warm}
        for f in frames:
            n_frames_stream[f.stream_id] = \
                n_frames_stream.get(f.stream_id, 0) + 1
        interpolated = 0
        eng._tracker_launches = eng._tracker_ticks = 0
        # a segment that never runs the tracker must not re-offer the
        # previous segment's table at the next boundary
        eng._exported_tracks = {}
        if eng.track_and_interpolate and (dropped or responses):
            responses = eng._interpolate(frames, responses, seq_of,
                                         self._emit0,
                                         tracks0=self._tracks0, rec=rec)
            interpolated = sum(r.interpolated for r in responses)
        responses.sort(key=lambda r: r.rid)   # sequence synchronizer
        makespan = max((r.t_done for r in responses), default=0.0)
        ordered = SequenceSynchronizer.order_per_stream(responses)
        streams, emit_t = {}, {}
        for sid, (rs, emits) in ordered.items():
            streams[sid], emit_t[sid] = rs, emits
        if rec.enabled:
            for sid in sorted(streams):
                clk = self._emit0.get(sid, 0.0)
                for r, e in zip(streams[sid], emit_t[sid]):
                    clk = max(clk, e)
                    rec.record("interp_emit" if r.interpolated else "emit",
                               clk, rid=r.rid, stream=sid, seq=r.seq)
        drop_stream: Dict[int, int] = {}
        for f in dropped:
            drop_stream[f.stream_id] = drop_stream.get(f.stream_id, 0) + 1
        per_stream = {}
        for sid, n in n_frames_stream.items():
            rs = streams.setdefault(sid, [])
            emits = emit_t.setdefault(sid, [])
            mk = emits[-1] if emits else 0.0   # per-stream emit makespan
            per_stream[sid] = {
                "frames": n,
                "dropped": drop_stream.get(sid, 0),
                "interpolated": sum(r.interpolated for r in rs),
                "coverage": len(rs) / max(n, 1),
                "throughput_fps": len(rs) / max(mk, 1e-9),
            }
        fc0, fc1 = self._fc0, eng.scheduler.fault_counts()
        fault_counts = {
            key: {i: fc1[key].get(i, 0) - fc0[key].get(i, 0)
                  for i in set(fc1[key]) | set(fc0[key])
                  if fc1[key].get(i, 0) - fc0[key].get(i, 0)}
            for key in ("retries", "failovers", "frames_lost")}
        return {
            "responses": responses,
            "dropped": [f.rid for f in dropped],
            "coverage": len(responses) / max(len(frames), 1),
            "interpolated": interpolated,
            "throughput_fps": len(responses) / max(makespan, 1e-9),
            "per_replica": _per_replica_counts(eng.replicas, responses),
            "n_streams": len(n_frames_stream),
            "streams": streams,
            "emit_t": emit_t,    # per-stream monotonic release clocks
            "per_stream": per_stream,
            "tracker_launches": eng._tracker_launches,
            "tracker_ticks": eng._tracker_ticks,
            "retries": fault_counts["retries"],
            "failovers": fault_counts["failovers"],
            "frames_lost": fault_counts["frames_lost"],
            # the cascade block, empty: the report schema matches the
            # reference engine's key for key
            **cascade_report_keys({}, {}, {}, 0,
                                  {"full": 0.0, "roi": 0.0, "passes": 0},
                                  len(frames)),
            **detection_latency_keys(
                responses, {f.rid: f.t_arrival for f in frames}),
        }

    # -------------------------------------------------------- boundaries
    def epoch_boundary(self) -> Dict:
        """Flush the open segment, close it into a per-epoch report, and
        start a new segment with the seq / emit floors (and, with
        ``carry_tracks``, the track rows) carried over."""
        self.advance(_INF)
        rep = self._finalize_segment(record=True)
        self._epoch_reports.append(rep)
        for sid, em in rep["emit_t"].items():
            if em:
                self._emit0[sid] = max(self._emit0.get(sid, 0.0), em[-1])
        if self.eng.carry_tracks:
            self._tracks0.update(self.eng._exported_tracks)
        self._new_segment()
        return rep

    def finalize_segments(self) -> List[Dict]:
        """Flush + close the open segment (if it has frames, or if it is
        the only one) and return every closed segment report."""
        self.advance(_INF)
        if self._queue or not self._epoch_reports:
            self.epoch_boundary()
        return list(self._epoch_reports)

    def drain(self) -> Dict:
        """Flush everything and return the final report (with no epoch
        boundaries, the batch ``serve`` report)."""
        segs = self.finalize_segments()
        if len(segs) == 1:
            return segs[0]
        raise NotImplementedError(
            "merging several epoch reports into one is not ported yet; "
            "read the per-epoch reports from epoch_boundary()")

    def report(self, rolling: bool = True):
        """Rolling view mid-serve: the closed per-epoch reports plus
        (when the open segment has frames) a non-destructive peek of it,
        tagged ``partial``.  ``rolling=False`` returns the single report
        when there is only one piece."""
        reps = list(self._epoch_reports)
        if self._queue or not reps:
            peek = self._finalize_segment(record=False)
            peek["partial"] = True
            reps.append(peek)
        if rolling:
            return reps
        if len(reps) == 1:
            return reps[0]
        raise NotImplementedError(
            "merging several epoch reports into one is not ported yet")

    @property
    def frames_pending(self) -> int:
        return len(self._queue) - self._qi


class ServingRuntime:
    """Always-on incremental serving core over a ``DetectionEngine``::

        rt = ServingRuntime(engine)
        rt.ingest(frames)        # any chunking: per-frame, bursts, all
        rt.advance(t)            # run work that can no longer change
        rt.report()              # rolling per-epoch reports, mid-serve
        rt.epoch_boundary()      # close a reporting window explicitly
        report = rt.drain()      # flush + final report

    One-shot ingest + drain reproduces the batch report, and so does
    any chunking under the watermark contract.  :meth:`reset_engines`
    is THE per-serve state reset; ``DetectionEngine.reset`` delegates to
    it."""

    def __init__(self, engine, *, reset: bool = True,
                 stream_seq0: Optional[Dict[int, int]] = None,
                 stream_emit0: Optional[Dict[int, float]] = None,
                 stream_tracks: Optional[Dict[int, dict]] = None,
                 streams=None):
        if not isinstance(engine, DetectionEngine):
            raise TypeError(
                f"ServingRuntime drives a DetectionEngine, got "
                f"{type(engine).__name__}")
        self.engine = engine
        if streams is not None and stream_seq0 is None:
            # declare the expected camera set: idle declared cameras
            # still appear (with zero frames) in every report
            stream_seq0 = {sid: 0 for sid in streams}
        self._core = _DetectionCore(engine, reset=reset,
                                    stream_seq0=stream_seq0,
                                    stream_emit0=stream_emit0,
                                    stream_tracks=stream_tracks)

    def ingest(self, frames):
        """Feed one ``FrameRequest`` or a sequence of them.  Chunks must
        be non-decreasing in ``t_arrival`` across calls (ties allowed)."""
        self._core.ingest(frames)

    def advance(self, to_t: Optional[float] = None):
        """Run every micro-batch that is *sealed* below ``to_t``.
        ``None`` uses the ingest watermark."""
        if to_t is None:
            to_t = self._core._watermark
        self._core.advance(to_t)

    def epoch_boundary(self):
        """Close the current reporting window and return its report."""
        return self._core.epoch_boundary()

    def report(self, rolling: bool = True):
        """Non-destructive mid-serve view (see ``_DetectionCore``)."""
        return self._core.report(rolling=rolling)

    def drain(self) -> Dict:
        """Flush all in-flight frames and return the final report."""
        return self._core.drain()

    @property
    def frames_pending(self) -> int:
        """Ingested frames not yet processed."""
        return self._core.frames_pending

    @property
    def watermark(self) -> float:
        """Latest ingested ``t_arrival`` (``-inf`` before any frame)."""
        return self._core._watermark

    def reset(self):
        """Reset the engine's per-serve state and restart this
        runtime's incremental state from scratch."""
        ServingRuntime.reset_engines(self.engine)
        self._core = _DetectionCore(self.engine, reset=False)

    @staticmethod
    def reset_engines(engine):
        """THE per-serve reset: clear replica virtual-clock state (warm
        ``_last_wall`` estimates survive) and the scheduler's round
        bookkeeping."""
        for r in engine.replicas:
            r.reset()
        engine.scheduler.reset()
