"""Incremental serving core: the engines' virtual-time loops as a
long-lived runtime (the port of the reference package's
``serving/runtime.py``).

Frames are ``ingest``-ed in any chunking (one at a time, bursts, or the
whole trace), ``advance(to_t)`` runs every micro-batch whose membership
can no longer change, ``epoch_boundary()`` closes a reporting window
mid-serve, and ``drain()`` flushes the pipeline and returns the final
report.  ``DetectionEngine.serve`` and ``ShardedDetectionEngine.serve``
are one-shot ingest + drain.

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

Each micro-batch runs: [cascade model selection] -> detect + NMS ->
[ROI second pass] -> [post-processor hook] -> virtual-clock assignment;
the tracker runs over the segment when it is finalized.  Several epoch
segments (``epoch_boundary`` before ``drain`` or ``report(rolling=
False)``) merge into one report through
``serving.sharded.merge_epoch_shard_reports``.

Sharded serving
---------------
For a ``ShardedDetectionEngine`` the runtime picks the matching core:
the static partition (``rebalance=False`` or one shard) fans ingest out
to one per-shard core; the rebalancing configuration replays the epoch
loop, serving each ``epoch_s`` window as soon as the watermark passes
its end, with the migration / watchdog boundary actions of window ``e``
run just before the next non-empty window is served.  The
deterministic ``shard_streams`` partition needs the full camera
universe, so *incremental* sharded ingest requires the stream set
declared up front (``ServingRuntime(engine, streams=...)``); without it
the core buffers and resolves everything at ``drain()``.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.synchronizer import SequenceSynchronizer
from ..obs.metrics import detection_latency_keys
from ..obs.trace import NULL_RECORDER, spanned
from ..sharding.serving_rules import rebalance_streams, shard_streams
from .engine import (DetectionEngine, DetectionResponse, FrameRequest,
                     _per_replica_counts)
from .faults import ShardFaultCursor
from .models import cascade_report_keys
from .pipeline import TickState, roi_second_pass
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
        self._all_frames: List[FrameRequest] = []   # closed segments'
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
        # per-segment transprecise-cascade counters
        self._model_counts: Dict[str, int] = {}
        self._model_of: Dict[int, str] = {}
        self._switches = 0
        self._roi_px = {"full": 0.0, "roi": 0.0, "passes": 0}

    # ------------------------------------------------------------ ingest
    @spanned("runtime.ingest")
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

    @spanned("runtime.batch")
    def _process_next_batch(self):
        eng = self.eng
        frames = self._queue
        i = self._qi
        rec = eng.recorder
        seq_of = self._seq_of
        chunk = frames[i:i + eng._chunk_size(frames, i)]
        self._qi += len(chunk)
        model = None
        if eng.cascade is not None:
            # model selection at the batch boundary, the only point a
            # switch may happen: a pure function of virtual-clock
            # signals, so it replays bit-identically
            t_sel = max(chunk[0].t_arrival,
                        min(r.busy_until for r in eng.replicas))
            model, switched = eng.cascade.decide(
                t_sel, len(chunk), eng.scheduler.backlog(t_sel),
                eng._model_caps())
            if switched:
                self._switches += 1
                if rec.enabled:
                    rec.record("model_switch", t_sel, batch=self._batch_no,
                               model=model)
            # pin service estimates before the drop-assign loop: drop
            # decisions price frames at the selected model's rate
            eng._apply_model(model)
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
        # no catalog => no `model=` kwarg
        mkw = {} if model is None else {"model": model}
        (boxes, scores, classes, valid), wall = eng._detect_batch(
            images, rids=[f.rid for f in kept] + [-1] * (b - len(kept)),
            **mkw)
        if rec.enabled:
            rec.record("stage", chunk[0].t_arrival, stage="detect",
                       batch=bno, frames=len(kept))
            rec.sample("stage_ms_detect", chunk[0].t_arrival,
                       wall * 1e3)
        # from here the batch travels as a TickState: [ROI second pass]
        # -> post-processor hook
        tick = TickState(boxes=boxes, scores=scores, classes=classes,
                         valid=valid, images=images, model=model)
        roi_frac = 0.0
        if (model is not None and eng.roi
                and model != eng.cascade.heaviest):
            tick, roi_frac, roi_wall, px = roi_second_pass(
                eng, tick, kept, b, rec)
            self._roi_px["full"] += px["full"]
            self._roi_px["roi"] += px["roi"]
            self._roi_px["passes"] += px["passes"]
            wall += roi_wall
        if eng.post_process is not None:
            tick = eng.post_process(tick)
        boxes, scores, classes, valid = (tick.boxes, tick.scores,
                                         tick.classes, tick.valid)
        per_frame = (wall / len(kept) if eng.service_time is None
                     else eng.service_time)
        roi_cost = 0.0
        if model is not None:
            prof = eng.catalog.get(model)
            if prof is not None and prof.service_s is not None:
                # virtual cost: the selected model's pinned service plus
                # the second pass priced at the pixel fraction it read
                # of the heavy model's full-frame service
                heavy_s = eng.catalog[eng.cascade.heaviest].service_s
                roi_cost = roi_frac * (heavy_s or 0.0)
                per_frame = prof.service_s + roi_cost
        for r in eng.replicas:
            r._last_wall = per_frame
        if model is not None:
            # re-pin from each replica's own catalog
            eng._apply_model(model, roi_cost)
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
            if model is not None:
                self._model_of[f.rid] = model
                self._model_counts[model] = \
                    self._model_counts.get(model, 0) + 1

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
            # the cascade block (all keys present, empty, without a
            # catalog), derived from the segment's raw counters
            **cascade_report_keys(
                self._model_counts, self._model_of,
                (eng.catalog.map_est_by_name()
                 if eng.catalog is not None else {}),
                self._switches, self._roi_px, len(frames)),
            **detection_latency_keys(
                responses, {f.rid: f.t_arrival for f in frames}),
        }

    # -------------------------------------------------------- boundaries
    @spanned("runtime.epoch")
    def epoch_boundary(self) -> Dict:
        """Flush the open segment, close it into a per-epoch report, and
        start a new segment with the seq / emit floors (and, with
        ``carry_tracks``, the track rows) carried over."""
        self.advance(_INF)
        rep = self._finalize_segment(record=True)
        self._epoch_reports.append(rep)
        self._all_frames.extend(self._queue)
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
        """Flush everything and return the final report: with no epoch
        boundaries, the batch ``serve`` report; with boundaries the
        per-epoch segments merge through ``merge_epoch_shard_reports``
        (histograms summed, quantiles recomputed — never averaged)."""
        segs = self.finalize_segments()
        if len(segs) == 1:
            return segs[0]
        from .sharded import merge_epoch_shard_reports
        return merge_epoch_shard_reports(
            self._all_frames, segs, [0] * len(segs),
            [len(self.eng.replicas)],
            report_epoch=list(range(len(segs))))

    def report(self, rolling: bool = True):
        """Rolling view mid-serve.  ``rolling=True``: the closed
        per-epoch reports plus (when the open segment has frames) a
        non-destructive peek of it, tagged ``partial``.  ``rolling=
        False``: one cumulative report merged over the same pieces."""
        reps = list(self._epoch_reports)
        if self._queue or not reps:
            peek = self._finalize_segment(record=False)
            peek["partial"] = True
            reps.append(peek)
        if rolling:
            return reps
        if len(reps) == 1:
            return reps[0]
        from .sharded import merge_epoch_shard_reports
        return merge_epoch_shard_reports(
            self._all_frames + self._queue, reps, [0] * len(reps),
            [len(self.eng.replicas)],
            report_epoch=list(range(len(reps))))

    @property
    def frames_pending(self) -> int:
        return len(self._queue) - self._qi


class _ShardedStaticCore:
    """Incremental front for the static-partition sharded path
    (``rebalance=False`` or one shard): one ``_DetectionCore`` per
    shard under the fixed ``shard_streams`` partition.

    With ``streams`` declared the partition is known up front and
    ingest fans out immediately; without it every frame buffers and
    ``drain()`` serves each shard's sub-trace to completion, in shard
    order."""

    def __init__(self, seng, streams=None):
        self._seng = seng
        if seng._shared_detect is not None:
            seng.warmup()
        self._frames: List[FrameRequest] = []
        self._watermark = -_INF
        self._cores: Optional[List[_DetectionCore]] = None
        self._shard_of: Optional[Dict[int, int]] = None
        self._n_boundaries = 0
        if streams is not None:
            self._shard_of = shard_streams(streams, seng.n_shards)
            self._cores = [_DetectionCore(eng) for eng in seng.engines]

    def ingest(self, frames):
        chunk = _sorted_chunk(frames)
        if not chunk:
            return
        if chunk[0].t_arrival < self._watermark:
            raise ValueError("ingest violates the watermark (chunks must "
                             "be non-decreasing in t_arrival)")
        self._watermark = chunk[-1].t_arrival
        self._frames.extend(chunk)
        if self._cores is not None:
            subs: List[List[FrameRequest]] = [
                [] for _ in range(self._seng.n_shards)]
            for f in chunk:
                subs[self._shard_of[f.stream_id]].append(f)
            for core, sub in zip(self._cores, subs):
                if sub:
                    core.ingest(sub)

    def advance(self, to_t: float):
        if self._cores is not None:
            for core in self._cores:
                core.advance(to_t)

    def epoch_boundary(self):
        if self._cores is None:
            raise RuntimeError(
                "incremental sharded serving needs the stream universe "
                "declared up front: ServingRuntime(engine, streams=...) "
                "(the deterministic shard_streams partition is a "
                "function of the full camera set)")
        reps = [core.epoch_boundary() for core in self._cores]
        self._n_boundaries += 1
        from .sharded import _epoch_rollup
        return _epoch_rollup(reps)

    def drain(self) -> Dict:
        from .sharded import merge_epoch_shard_reports, merge_shard_reports
        seng = self._seng
        frames = self._frames
        if self._cores is None:
            # partition now, then serve each shard to completion in
            # shard order
            shard_of = shard_streams((f.stream_id for f in frames),
                                     seng.n_shards)
            self._shard_of = shard_of
            subs: List[List[FrameRequest]] = [
                [] for _ in range(seng.n_shards)]
            for f in frames:
                subs[shard_of[f.stream_id]].append(f)
            reports = []
            for eng, sub in zip(seng.engines, subs):
                core = _DetectionCore(eng)
                core.ingest(sub)
                reports.append(core.drain())
            out = merge_shard_reports(
                frames, reports, [len(eng.replicas)
                                  for eng in seng.engines])
        else:
            pool_sizes = [len(eng.replicas) for eng in seng.engines]
            per_shard_segs = [core.finalize_segments()
                              for core in self._cores]
            if self._n_boundaries == 0:
                out = merge_shard_reports(
                    frames, [segs[0] for segs in per_shard_segs],
                    pool_sizes)
            else:
                reports, report_shard, report_epoch = [], [], []
                for h, segs in enumerate(per_shard_segs):
                    for e, rep in enumerate(segs):
                        reports.append(rep)
                        report_shard.append(h)
                        report_epoch.append(e)
                out = merge_epoch_shard_reports(
                    frames, reports, report_shard, pool_sizes,
                    report_epoch=report_epoch)
        out["shard_of_stream"] = self._shard_of
        if seng.faults is not None:
            seng._attach_fault_keys(
                out, frames, lost=[], restarts=[], loans=[],
                t_rec=seng.faults.last_event_t if frames else None)
        return out

    def report(self, rolling: bool = True):
        from .sharded import _epoch_rollup
        if self._cores is None:
            raise RuntimeError(
                "report() mid-serve needs streams= declared up front; "
                "without it the static sharded core resolves at drain()")
        per_shard = [core.report(rolling=True) for core in self._cores]
        if rolling:
            n = max(len(reps) for reps in per_shard)
            return [_epoch_rollup([reps[e] for reps in per_shard
                                   if e < len(reps)])
                    for e in range(n)]
        return _epoch_rollup([rep for reps in per_shard for rep in reps])

    @property
    def frames_pending(self) -> int:
        if self._cores is None:
            return len(self._frames)
        return sum(core.frames_pending for core in self._cores)


class _ShardedEpochCore:
    """Incremental replay of the rebalancing epoch loop (``rebalance=
    True`` and >= 2 shards): fixed ``epoch_s`` virtual-time windows
    anchored at the first arrival, served as soon as the watermark
    passes their end.

    A window's boundary actions (watchdog dead-shard handling,
    ``rebalance_streams`` migration, replica lending) run only when a
    LATER non-empty window exists: the boundary of window ``e`` is
    *pending* until the next non-empty window is about to be served,
    then runs first, with no knowledge of the future required.  The
    final pending boundary is discarded at ``drain()``.
    """

    def __init__(self, seng, streams=None):
        self._seng = seng
        if seng._shared_detect is not None:
            seng.warmup()
        self._frames: List[FrameRequest] = []
        self._watermark = -_INF
        self._t0: Optional[float] = None
        self._windows: List[List[FrameRequest]] = []
        self._next_raw = 0
        self._shard_of = (shard_streams(streams, seng.n_shards)
                          if streams is not None else None)
        self._seq0: Dict[int, int] = {}
        self._emit0: Dict[int, float] = {}
        # portable track rows by stream_id, updated after every shard
        # serve: migration hands a stream's row to its NEW shard, so
        # track identities survive rebalancing and evacuation
        self._tracks0: Dict[int, dict] = {}
        self._reports: List[Dict] = []
        self._report_shard: List[int] = []
        self._report_epoch: List[int] = []
        self._migrations: List[Dict] = []
        self._lost: List[FrameRequest] = []
        self._heartbeat = {h: -1 for h in range(seng.n_shards)}
        self._cursor = (ShardFaultCursor(seng.faults, seng.n_shards)
                        if seng.faults is not None
                        and seng.faults.has_shard_events else None)
        self._sup = seng.supervisor
        self._sup_begun = False
        self._first_served = False
        self._pending = None       # boundary context of the last window
        self._last_raw: Optional[int] = None

    def ingest(self, frames):
        chunk = _sorted_chunk(frames)
        if not chunk:
            return
        if chunk[0].t_arrival < self._watermark:
            raise ValueError("ingest violates the watermark (chunks must "
                             "be non-decreasing in t_arrival)")
        self._watermark = chunk[-1].t_arrival
        if self._t0 is None:
            self._t0 = chunk[0].t_arrival
        eps = self._seng.epoch_s
        for f in chunk:
            e = int((f.t_arrival - self._t0) // eps)
            while len(self._windows) <= e:
                self._windows.append([])
            self._windows[e].append(f)
        self._frames.extend(chunk)

    def advance(self, to_t: float):
        """Serve every materialized window whose end lies at or before
        ``to_t`` (the caller's promise that no frame below ``to_t`` is
        still outstanding makes such a window final).  No-op until the
        stream universe is known (``streams=`` declared, or resolved at
        ``drain()``)."""
        if self._t0 is None or self._shard_of is None:
            return
        eps = self._seng.epoch_s
        while self._next_raw < len(self._windows):
            w_end = self._t0 + (self._next_raw + 1) * eps
            if w_end > to_t:
                break
            ef = self._windows[self._next_raw]
            if ef:
                self._serve_window(self._next_raw, ef)
            self._next_raw += 1

    def _serve_window(self, raw_e: int, ef: List[FrameRequest]):
        """One non-empty epoch window: run the previous window's
        pending boundary, split the window
        over the current partition, apply shard-fault cuts, serve each
        shard warm-started, collect observations and advance the seq /
        emit floors."""
        if self._pending is not None:
            self._run_boundary(self._pending)
            self._pending = None
        seng = self._seng
        sup, cursor = self._sup, self._cursor
        if sup is not None and not self._sup_begun:
            sup.begin(seng.engines)
            self._sup_begun = True
        rec = seng.recorder
        seq0, emit0, shard_of = self._seq0, self._emit0, self._shard_of
        subs: List[List[FrameRequest]] = [[] for _ in range(seng.n_shards)]
        for f in ef:
            subs[shard_of[f.stream_id]].append(f)
        t_end = ef[-1].t_arrival
        w_start = self._t0 + raw_e * seng.epoch_s
        w_end = self._t0 + (raw_e + 1) * seng.epoch_s
        if rec.enabled:
            rec.record("epoch", w_start, epoch=raw_e)
        observations = []
        down: List[int] = []
        for h, (eng, sub) in enumerate(zip(seng.engines, subs)):
            lost_h: List[FrameRequest] = []
            if cursor is not None:
                cut = cursor.begin_epoch(h, w_start, w_end)
                if cut is not None:
                    lost_h = [f for f in sub if f.t_arrival >= cut]
                    sub = [f for f in sub if f.t_arrival < cut]
                if cursor.is_down(h):
                    down.append(h)          # no heartbeat this epoch
                    if rec.enabled:
                        rec.record("shard_down", w_start, shard=h,
                                   epoch=raw_e)
                else:
                    self._heartbeat[h] = raw_e
            else:
                self._heartbeat[h] = raw_e
            warm = {sid: seq0.get(sid, 0)
                    for sid, hh in shard_of.items() if hh == h}
            rep = eng.serve(sub, reset=not self._first_served,
                            stream_seq0=warm,
                            stream_emit0={sid: emit0[sid]
                                          for sid in warm
                                          if sid in emit0},
                            stream_tracks={sid: self._tracks0[sid]
                                           for sid in warm
                                           if sid in self._tracks0})
            self._reports.append(rep)
            self._report_shard.append(h)
            self._report_epoch.append(raw_e)
            obs_frames = {sid: v["frames"]
                          for sid, v in rep["per_stream"].items()}
            for f in lost_h:   # the policy sees true arrival rates
                obs_frames[f.stream_id] = \
                    obs_frames.get(f.stream_id, 0) + 1
            observations.append({
                # shard-lost frames are drops for the pressure signal:
                # a dead shard reads maximally pressured
                "drops": len(rep["dropped"]) + len(lost_h),
                "backlog_s": eng.backlog_snapshot(t_end)["backlog_s"],
                "frames": obs_frames,
            })
            for sid, v in rep["per_stream"].items():
                seq0[sid] = seq0.get(sid, 0) + v["frames"]
            for f in lost_h:
                # lost frames still advance the seq floor: later
                # epochs' frames must map to their true per-stream
                # arrival indices or quality accounting corrupts
                if rec.enabled:
                    # lost frames never reach an engine, so their
                    # arrive + terminal events record here (frame
                    # conservation holds over the whole trace)
                    rec.record("arrive", f.t_arrival, rid=f.rid,
                               stream=f.stream_id,
                               seq=seq0.get(f.stream_id, 0), shard=h)
                    rec.record("shard_lost", f.t_arrival, rid=f.rid,
                               stream=f.stream_id, shard=h)
                seq0[f.stream_id] = seq0.get(f.stream_id, 0) + 1
            for sid, em in rep["emit_t"].items():
                if em:
                    emit0[sid] = max(emit0.get(sid, 0.0), em[-1])
            if eng.carry_tracks:
                # pull the served streams' track rows back into the
                # epoch-level map — the rows a migrated stream carries
                # to its destination shard next window
                self._tracks0.update(eng._exported_tracks)
            self._lost += lost_h
        self._first_served = True
        self._last_raw = raw_e
        self._pending = {"raw_e": raw_e, "down": down,
                         "observations": observations, "w_end": w_end,
                         "had_frames": [bool(s) for s in subs]}

    def _run_boundary(self, p: Dict):
        """The inter-epoch block: watchdog dead-shard detection +
        restart/evacuation, deterministic stream migration, then replica
        lending — acting on the window recorded in ``p``, before the next
        non-empty window serves."""
        seng, sup, cursor = self._seng, self._sup, self._cursor
        rec = seng.recorder
        raw_e, down = p["raw_e"], p["down"]
        evac: List[int] = []
        if sup is not None and cursor is not None:
            dead = sup.detect_dead(self._heartbeat, raw_e,
                                   p["had_frames"])
            for h in dead:
                sup.handle_dead(seng.engines, h, cursor, raw_e,
                                p["w_end"])
            # every currently-down shard is excluded from the stealing
            # phase (and drained of streams), detected or not — a dead
            # host must never RECEIVE streams
            evac = sorted(set(down))
        self._shard_of, moves = rebalance_streams(
            self._shard_of, p["observations"],
            max_moves=seng.max_moves_per_epoch,
            evacuate=tuple(evac))
        self._migrations += [{"epoch": raw_e, "stream": sid,
                              "src": src, "dst": dst}
                             for sid, src, dst in moves]
        if rec.enabled:
            for sid, src, dst in moves:
                rec.record("migrate", p["w_end"], stream=sid,
                           src=src, dst=dst, epoch=raw_e)
        if sup is not None:
            stole = any(src not in set(evac) for _, src, _ in moves)
            sup.rebalance_loans(seng.engines, p["observations"],
                                moved=stole, down=down, epoch=raw_e,
                                epoch_s=seng.epoch_s, t=p["w_end"])

    def epoch_boundary(self):
        """Epoch windows are intrinsic here (the ``epoch_s`` grid), so
        this only returns the latest served window's rollup (or None
        before any window completed) — it cannot cut a window early."""
        if self._last_raw is None:
            return None
        from .sharded import _epoch_rollup
        return _epoch_rollup(
            [rep for rep, e in zip(self._reports, self._report_epoch)
             if e == self._last_raw])

    def drain(self) -> Dict:
        from .sharded import merge_epoch_shard_reports
        seng = self._seng
        frames = self._frames
        if not frames:
            # an empty trace is served by the static path
            return _ShardedStaticCore(seng).drain()
        if self._shard_of is None:
            self._shard_of = shard_streams(
                (f.stream_id for f in frames), seng.n_shards)
        self.advance(_INF)
        # the last window's pending boundary is discarded: nothing is
        # rebalanced after the final non-empty epoch
        self._pending = None
        sup = self._sup
        pool_sizes = [len(eng.replicas) for eng in seng.engines]
        if sup is not None:
            sup.finish(seng.engines, self._last_raw,
                       t=self._t0 + (self._last_raw + 1) * seng.epoch_s)
            pool_sizes = sup.pool_sizes(seng.engines)
        out = merge_epoch_shard_reports(frames, self._reports,
                                        self._report_shard, pool_sizes,
                                        report_epoch=self._report_epoch)
        out["shard_of_stream"] = self._shard_of
        out["migrations"] = self._migrations
        out["n_epochs"] = len(self._windows)
        lost = self._lost
        if lost:
            # fold the shard-lost frames into the drop accounting: they
            # never reached an engine, so no report counted them
            pos = {f.rid: k for k, f in enumerate(frames)}
            out["dropped"] = sorted(out["dropped"]
                                    + [f.rid for f in lost],
                                    key=pos.__getitem__)
            for f in lost:
                agg = out["per_stream"].setdefault(
                    f.stream_id, {"frames": 0, "dropped": 0,
                                  "interpolated": 0, "coverage": 0.0,
                                  "throughput_fps": 0.0})
                agg["frames"] += 1
                agg["dropped"] += 1
            for sid in sorted({f.stream_id for f in lost}):
                rs = out["streams"].setdefault(sid, [])
                out["emit_t"].setdefault(sid, [])
                agg = out["per_stream"][sid]
                agg["coverage"] = len(rs) / max(agg["frames"], 1)
            out["n_streams"] = len(out["per_stream"])
        if seng.faults is not None or sup is not None:
            restarts = list(sup.restart_log) if sup is not None else []
            loans = list(sup.loan_log) if sup is not None else []
            t_cands = []
            if seng.faults is not None:
                t_cands.append(seng.faults.last_event_t)
            t_cands += [r["t"] for r in restarts]
            for ln in loans:
                t_cands.append(
                    self._t0 + (ln["epoch"] + 1) * seng.epoch_s)
                if ln["returned_epoch"] is not None:
                    t_cands.append(
                        self._t0 + (ln["returned_epoch"] + 1)
                        * seng.epoch_s)
            t_rec = None
            if t_cands:
                # recovery acts at epoch boundaries: quantize the last
                # fault/action up to the next boundary
                k = int(np.ceil(max(max(t_cands) - self._t0, 0.0)
                                / seng.epoch_s - 1e-12))
                t_rec = self._t0 + k * seng.epoch_s
            seng._attach_fault_keys(out, frames, lost, restarts, loans,
                                    t_rec)
        return out

    def report(self, rolling: bool = True):
        from .sharded import _epoch_rollup
        by_epoch: Dict[int, List[Dict]] = {}
        for rep, e in zip(self._reports, self._report_epoch):
            by_epoch.setdefault(e, []).append(rep)
        if rolling:
            return [_epoch_rollup(by_epoch[e])
                    for e in sorted(by_epoch)]
        return _epoch_rollup(self._reports)

    @property
    def frames_pending(self) -> int:
        return sum(len(w) for w in self._windows[self._next_raw:])


class ServingRuntime:
    """Always-on incremental serving core over a ``DetectionEngine`` or
    ``ShardedDetectionEngine``.

    The batch ``serve(frames)`` entry points are now one-shot drivers
    over this class::

        rt = ServingRuntime(engine)
        rt.ingest(frames)        # any chunking: per-frame, bursts, all
        rt.advance(t)            # run work that can no longer change
        rt.report()              # rolling per-epoch reports, mid-serve
        rt.epoch_boundary()      # close a reporting window explicitly
        report = rt.drain()      # flush + final report

    **Bit-identity:** one-shot ingest + drain reproduces the batch
    report byte for byte, and — under the watermark contract (chunks
    non-decreasing in ``t_arrival``; ``advance(to_t)`` only after every
    frame below ``to_t`` is ingested) — so does ANY chunking.

    **Sharded engines:** the deterministic ``shard_streams`` partition
    is a function of the full camera set, so incremental processing
    needs the stream universe declared up front (``streams=``); without
    it ingest buffers and ``drain()`` replays the batch path.  The
    warm-start hooks (``reset=False`` / ``stream_seq0`` /
    ``stream_emit0`` / ``stream_tracks``) are single-engine
    trace-slicing plumbing and are rejected on sharded engines — the
    sharded cores manage their own epoch floors and carry each
    stream's portable track rows across windows (and migrations)
    themselves.

    **Reset semantics:** :meth:`reset_engines` is THE one definition of
    per-serve state reset (replica virtual clocks + scheduler round
    bookkeeping, shard-recursive); ``DetectionEngine.reset`` and
    ``ShardedDetectionEngine.reset`` delegate to it, and every fresh runtime (``reset=True``, the
    default) starts from it — so back-to-back serves are independent by
    construction."""

    def __init__(self, engine, *, reset: bool = True,
                 stream_seq0: Optional[Dict[int, int]] = None,
                 stream_emit0: Optional[Dict[int, float]] = None,
                 stream_tracks: Optional[Dict[int, dict]] = None,
                 streams: Optional[Sequence[int]] = None):
        self.engine = engine
        if isinstance(engine, DetectionEngine):
            if streams is not None and stream_seq0 is None:
                # declare the expected camera set: it pre-seeds the
                # per-stream accounting so idle declared cameras still
                # appear (with zero frames) in every report
                stream_seq0 = {sid: 0 for sid in streams}
            self._core = _DetectionCore(engine, reset=reset,
                                        stream_seq0=stream_seq0,
                                        stream_emit0=stream_emit0,
                                        stream_tracks=stream_tracks)
        elif hasattr(engine, "engines"):     # ShardedDetectionEngine
            if not reset or stream_seq0 or stream_emit0 or stream_tracks:
                raise ValueError(
                    "warm-start hooks (reset=False / stream_seq0 / "
                    "stream_emit0 / stream_tracks) are single-engine "
                    "trace-slicing plumbing; the sharded cores manage "
                    "their own epoch floors and track rows")
            if engine.rebalance and engine.n_shards > 1:
                self._core = _ShardedEpochCore(engine, streams=streams)
            else:
                self._core = _ShardedStaticCore(engine, streams=streams)
        else:
            raise TypeError(
                f"ServingRuntime drives frame-payload engines "
                f"(DetectionEngine / ShardedDetectionEngine), got "
                f"{type(engine).__name__}")

    # ------------------------------------------------------------- intake
    def ingest(self, frames):
        """Feed one ``FrameRequest`` or a sequence of them.  Chunks must
        be non-decreasing in ``t_arrival`` across calls (ties allowed);
        within a chunk frames are sorted stably, like the batch path."""
        self._core.ingest(frames)

    def advance(self, to_t: Optional[float] = None):
        """Run every micro-batch / epoch window that is *sealed* below
        ``to_t`` — the caller's promise that all frames with
        ``t_arrival < to_t`` have been ingested.  ``None`` uses the
        ingest watermark (process everything that can no longer
        change)."""
        if to_t is None:
            to_t = self._core._watermark
        self._core.advance(to_t)

    # ------------------------------------------------------------ windows
    def epoch_boundary(self):
        """Close the current reporting window: flush pending work, emit
        the window's report, carry seq/emit floors into the next one.
        On the rebalancing sharded core windows are intrinsic (the
        ``epoch_s`` grid) and this returns the latest window's rollup
        instead of cutting one."""
        return self._core.epoch_boundary()

    def report(self, rolling: bool = True):
        """Non-destructive mid-serve view.  ``rolling=True`` returns the
        per-epoch report list (full engine reports on a single-engine
        runtime — the open window peeked and tagged ``partial`` —
        volume/latency rollups on sharded runtimes); ``rolling=False``
        returns one cumulative report/rollup merged under the
        merge-never-average rule."""
        return self._core.report(rolling=rolling)

    def drain(self) -> Dict:
        """Flush all in-flight frames (seal everything, including the
        partial tail micro-batch) and return the final report — the
        graceful-shutdown path.  Bit-identical to batch ``serve()``
        when no mid-serve boundaries were cut."""
        return self._core.drain()

    # -------------------------------------------------------------- state
    @property
    def frames_pending(self) -> int:
        """Ingested frames not yet processed (in-flight on shutdown)."""
        return self._core.frames_pending

    @property
    def watermark(self) -> float:
        """Latest ingested ``t_arrival`` (``-inf`` before any frame)."""
        return self._core._watermark

    def reset(self):
        """Reset the engine's per-serve state (through
        :meth:`reset_engines`) and restart this runtime's incremental
        state from scratch: queues, segments, floors and reports are
        cleared.  Warm service estimates and compiled programs survive,
        exactly like the engines' own documented ``reset``."""
        ServingRuntime.reset_engines(self.engine)
        core = self._core
        if isinstance(core, (_ShardedStaticCore, _ShardedEpochCore)):
            streams = (sorted(core._shard_of) if core._shard_of is not None
                       else None)
            self._core = type(core)(self.engine, streams=streams)
        else:
            self._core = _DetectionCore(self.engine, reset=False)

    @staticmethod
    def reset_engines(engine):
        """THE per-serve reset semantic, shared by every engine: clear
        replica virtual-clock state (``busy_until`` / processed counts /
        EWMAs — warm ``_last_wall`` estimates survive) and the
        scheduler's round bookkeeping; recurse over a sharded engine's
        shard engines.  ``DetectionEngine.reset`` /
        ``ShardedDetectionEngine.reset`` route here."""
        subs = getattr(engine, "engines", None)
        if subs is not None:                 # sharded: recurse per shard
            for eng in subs:
                ServingRuntime.reset_engines(eng)
            return
        for r in engine.replicas:
            r.reset()
        engine.scheduler.reset()
