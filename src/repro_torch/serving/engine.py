"""NVR detection serving: the paper's multi-model parallelism as parallel
replica executors behind one scheduler (the port of the reference
package's ``serving/engine.py``).  ``DetectionEngine`` is the
video-frame payload path; ``ServingEngine`` carries the same replica
machinery for token (LLM prefill + decode) payloads.

Frames stream in, the paper's schedulers (FCFS / RR / weighted /
proportional) pick a replica, the detect + NMS fast path runs in
micro-batches on the device, measured wall times drive the virtual
timeline, and the sequence synchronizer returns responses in arrival
order.  ``serve()`` is a one-shot driver over the incremental core in
``serving.runtime``.

Multi-camera (NVR) contract
---------------------------
``FrameRequest.stream_id`` tags which camera a frame belongs to
(default 0).  ``rid`` stays globally unique across streams; a frame's
per-stream arrival index is derived by the engine and returned as
``DetectionResponse.seq``.  All cameras share the same replicas and
micro-batches and, under ``track_and_interpolate``, ONE batched tracker
with batch dim B = number of streams: the track table advances all
streams in lockstep, one tracker tick per arrival index.

Devices: the detector and the tracker run on ``device``; ``None`` means
``cuda`` and raises where no CUDA device exists.  ``device="cpu"`` runs
the plain PyTorch versions of the kernels (what the CPU tests do); on
``cuda`` the hand-written kernels run, never a plain version.
"""
from __future__ import annotations

import inspect
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.scheduler import make_scheduler
from ..device import resolve_device
from ..models import init_model
from ..models.config import ModelConfig
from ..obs.metrics import detection_latency_keys
from ..obs.trace import NULL_RECORDER, Timed, span
from ..runtime.steps import (GraphedDecode, make_decode_step,
                             make_prefill_step)
from .pipeline import TickPipeline, bucket, chunk_size, confirmed_ids


@dataclass
class Request:
    """Token-payload request for ``ServingEngine``: a prompt of
    ``tokens`` (``(prompt_len,)`` int32) arriving at virtual time
    ``t_arrival``, asking for ``max_new_tokens`` of greedy decode.
    ``rid`` is the caller-assigned unique request id that responses
    are matched and ordered by."""
    rid: int
    tokens: np.ndarray            # (prompt_len,)
    max_new_tokens: int = 8
    t_arrival: float = 0.0


@dataclass
class FrameRequest:
    """Video-frame request for ``DetectionEngine``: one camera frame
    (``image``: ``(S, S, 3)`` float32) arriving at virtual time
    ``t_arrival``.

    ``stream_id`` names the camera the frame belongs to (default 0,
    the single-stream case); ``rid`` must stay globally unique ACROSS
    cameras — the engine derives the frame's position within its own
    camera's stream and returns it as ``DetectionResponse.seq``."""
    rid: int
    image: np.ndarray             # (S, S, 3) float32
    t_arrival: float = 0.0
    stream_id: int = 0            # which camera this frame belongs to


@dataclass
class DetectionResponse:
    """Per-frame detection result from ``DetectionEngine.serve``.

    ``boxes``/``scores``/``classes`` are fixed-width ``max_out`` rows
    with ``valid`` masking the real detections.  ``replica`` is the
    executor that processed the frame, or ``-1`` for a frame the
    scheduler dropped and the tracker re-emitted (``interpolated=True``
    — boxes are the tracker's coasted prediction, ``track_ids`` carries
    the persistent track identities).  ``t_start``/``t_done`` are
    virtual-clock processing bounds and ``service_s`` the per-frame
    service share of the micro-batch.  ``stream_id``/``seq`` locate the
    frame in its camera's stream."""
    rid: int
    boxes: np.ndarray             # (max_out, 4)
    scores: np.ndarray            # (max_out,)
    classes: np.ndarray           # (max_out,)
    valid: np.ndarray             # (max_out,) bool
    replica: int                  # -1 for tracker-interpolated frames
    t_start: float
    t_done: float
    service_s: float
    interpolated: bool = False    # True: boxes coasted by the tracker
    track_ids: Optional[np.ndarray] = None
    stream_id: int = 0            # camera this frame belongs to
    seq: int = -1                 # per-stream arrival index of the frame


@dataclass
class Response:
    """Token-payload response from ``ServingEngine.serve``: the greedy
    decode ``tokens`` for request ``rid``, the ``replica`` that served
    it, its virtual-clock ``t_start``/``t_done`` window and the
    measured wall ``service_s``."""
    rid: int
    tokens: np.ndarray            # generated ids
    replica: int
    t_start: float
    t_done: float
    service_s: float


class ReplicaExecutor:
    """Scheduler-compatible executor backed by the real detector call."""

    def __init__(self, idx: int, speed: float = 1.0):
        self.idx = idx
        self.speed = speed            # heterogeneity: service multiplier
        self.busy_until = 0.0
        self.n_processed = 0
        self.ewma_service = None
        self._last_wall = 0.1
        self.faults = None            # optional faults.ReplicaFaultView
        # loadable-model catalog (serving.models.ModelCatalog), attached
        # by the owning engine.  It travels with the executor, so replica
        # lending can move a guest's home catalog into another pool.
        self.catalog = None

    @property
    def mu_effective(self) -> float:
        # explicit None check: a measured EWMA of exactly 0.0 is data
        t = (self._last_wall * self.speed if self.ewma_service is None
             else self.ewma_service)
        return 1.0 / max(t, 1e-6)

    def service_time(self, frame=None, t=None) -> float:
        """Virtual service seconds for one frame.  ``t`` is the virtual
        dispatch time the scheduler evaluates the work at; it only
        matters when a fault view is attached — an injected slowdown
        multiplies the base estimate and a dead replica reports
        infinity, which the scheduler's timeout rule turns into a
        suspect + retry (``core.scheduler``)."""
        s = self._last_wall * self.speed
        if self.faults is not None and t is not None:
            if not self.faults.alive(t):
                return float("inf")
            s *= self.faults.factor(t)
        return s

    def record(self, t_service: float):
        self.n_processed += 1
        a = 0.3
        self.ewma_service = (t_service if self.ewma_service is None
                             else (1 - a) * self.ewma_service + a * t_service)

    def reset(self):
        """Clear per-serve virtual-clock state; the warm service
        estimate ``_last_wall`` survives."""
        self.busy_until = 0.0
        self.n_processed = 0
        self.ewma_service = None


def _per_replica_counts(replicas, responses) -> Dict[int, int]:
    """Per-CALL placement counts (``replica == -1`` tracker-interpolated
    frames excluded)."""
    counts = {r.idx: 0 for r in replicas}
    for resp in responses:
        if resp.replica >= 0:
            counts[resp.replica] += 1
    return counts


class ServingEngine:
    """Token-payload serving: the paper's parallel-replica scheduling
    applied to an LLM decode loop.

    ``n_replicas`` logical replicas share one set of prefill/decode
    steps on ``device`` (None: ``cuda``, raising where no CUDA device
    exists); each request's REAL measured wall time, scaled by the
    replica's ``replica_speeds`` multiplier (heterogeneous pools),
    drives the same virtual-clock schedulers as the edge simulator
    (``scheduler`` in fcfs/rr/wrr/proportional).  ``drop_when_busy=True``
    reproduces the paper's load shedding: a request arriving with every
    replica busy is dropped instead of queued.  ``serve`` returns
    responses in arrival order plus throughput/latency/per-replica
    accounting.  ``params`` are the port's model parameters
    (``models.init_model`` or ``models.params_from_numpy``); None draws
    them from ``seed``."""

    def __init__(self, cfg: ModelConfig, params=None, n_replicas: int = 4,
                 scheduler: str = "fcfs", cache_len: int = 128,
                 replica_speeds: Optional[Sequence[float]] = None,
                 drop_when_busy: bool = False, seed: int = 0,
                 recorder=None, device=None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}: "
                             "an empty replica pool can never serve")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.params = params if params is not None else init_model(
            cfg, torch.Generator().manual_seed(seed), device=self.device)
        self.cache_len = cache_len
        self.prefill = make_prefill_step(cfg, cache_len=cache_len)
        self.decode = (GraphedDecode(cfg) if self.device.type == "cuda"
                       else make_decode_step(cfg))
        speeds = list(replica_speeds or [1.0] * n_replicas)
        self.replicas = [ReplicaExecutor(i, s) for i, s in enumerate(speeds)]
        self.scheduler = make_scheduler(scheduler, self.replicas,
                                        host_overhead=1e-4)
        # None -> the shared no-op recorder; the scheduler shares the
        # same recorder for dispatch events
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self.scheduler.recorder = self.recorder
        self.drop_when_busy = drop_when_busy
        self._warm = False

    # ------------------------------------------------------------- compute
    @torch.no_grad()
    def _generate(self, req: Request) -> tuple[np.ndarray, float]:
        """Prefill, then greedy decode.  The spans split the host's time:
        ``llm.prefill`` and each ``llm.decode`` enqueue their step and
        its argmax (no synchronize), ``llm.read`` is each blocking read
        of a token and the final synchronize.  On a card the decode step
        replays from CUDA graphs (``runtime.steps.GraphedDecode``, inside
        an ``llm.decode_graph`` span)."""
        t0 = time.perf_counter()
        with span("llm.prefill"):
            toks = torch.as_tensor(np.asarray(req.tokens, np.int64),
                                   device=self.device)[None]
            logits, cache = self.prefill(self.params, {"tokens": toks})
            nxt = torch.argmax(logits, -1)[:, None]
        out = []
        pos = toks.shape[1]
        for _ in range(req.max_new_tokens):
            with span("llm.read"):
                out.append(int(nxt[0, 0]))
            with span("llm.decode"):
                logits, cache = self.decode(self.params, {
                    "tokens": nxt, "cache": cache, "decode_pos": pos})
                nxt = torch.argmax(logits, -1)[:, None]
            pos += 1
        if self.device.type == "cuda":    # the wall covers the device work
            with span("llm.read"):
                torch.cuda.synchronize(self.device)
        return np.array(out, np.int32), time.perf_counter() - t0

    def warmup(self, prompt_len: int = 16):
        req = Request(-1, np.zeros(prompt_len, np.int32), 2)
        _, wall = self._generate(req)
        for r in self.replicas:
            r._last_wall = wall
        self._warm = True

    def reset(self):
        """Clear per-serve virtual-clock state (replica ``busy_until`` /
        processed counts / EWMAs and the scheduler's round bookkeeping)
        so repeated ``serve()`` calls are independent.  Delegates to
        ``ServingRuntime.reset_engines``."""
        from .runtime import ServingRuntime
        ServingRuntime.reset_engines(self)

    # ------------------------------------------------------------- serving
    def serve(self, requests: Sequence[Request]) -> Dict:
        """Run a batch of requests through the parallel-replica pipeline.
        Returns responses (arrival order), dropped ids, and throughput
        and latency metrics (``p50_latency``, ``p95_latency``,
        ``p99_latency``, ``latency_hist``), as the reference does.  Each
        call is independent: per-serve virtual-clock state is reset on
        entry, and ``per_replica`` counts this call's placements."""
        if not requests:                  # empty report, like DetectionEngine
            empty = detection_latency_keys([])
            return {"responses": [], "dropped": [], "throughput_rps": 0.0,
                    "p50_latency": 0.0, "p95_latency": 0.0,
                    "p99_latency": 0.0, "latency_hist": empty["latency_hist"],
                    "per_replica": {r.idx: 0 for r in self.replicas}}
        if not self._warm:
            self.warmup(max(len(r.tokens) for r in requests))
        self.reset()
        rec = self.recorder
        responses: List[Response] = []
        dropped: List[int] = []
        for req in sorted(requests, key=lambda r: r.t_arrival):
            if rec.enabled:
                rec.record("arrive", req.t_arrival, rid=req.rid,
                           stream=0, seq=req.rid)
            gen, wall = self._generate(req)       # real compute, measured
            for r in self.replicas:               # this request would cost
                r._last_wall = wall               # wall x speed on replica r
            if self.drop_when_busy:
                a = self.scheduler.assign(req.rid, req.t_arrival)
            else:
                # raises NoHealthyExecutorError when nothing can ever
                # take the request; None only when a fault kills the
                # bounded retry chain
                a = self.scheduler.blocking_assign(req.rid, req.t_arrival)
            if a is None:
                dropped.append(req.rid)
                if rec.enabled:
                    rec.record("drop", req.t_arrival, rid=req.rid,
                               stream=0, seq=req.rid)
                continue
            responses.append(Response(req.rid, gen, a.executor_idx,
                                      a.t_start, a.t_done, wall))
        responses.sort(key=lambda r: r.rid)       # sequence synchronizer
        if rec.enabled:
            clk = 0.0                   # rid-order release clock (one lane)
            for r in responses:
                clk = max(clk, r.t_done)
                rec.record("emit", clk, rid=r.rid, stream=0, seq=r.rid)
        makespan = max((r.t_done for r in responses), default=0.0)
        lk = detection_latency_keys(responses)
        return {
            "responses": responses,
            "dropped": dropped,
            "throughput_rps": len(responses) / max(makespan, 1e-9),
            "p50_latency": lk["p50_latency"],
            "p95_latency": lk["p95_latency"],
            "p99_latency": lk["p99_latency"],
            "latency_hist": lk["latency_hist"],
            "per_replica": _per_replica_counts(self.replicas, responses),
        }


class DetectionEngine:
    """Video-frame payload path: the paper's "n detection models" served
    from the scheduler/replica machinery, with frames routed through the
    detector in micro-batches so the whole batch is decoded and
    suppressed by ONE fused batched-NMS launch.

    * ``micro_batch=None`` (the default) sizes each micro-batch by the
      queue depth at dispatch time, capped at ``max_micro_batch`` and
      padded to a power-of-two bucket; an explicit int keeps the
      fixed-size behaviour.
    * ``drop_when_busy=True`` reproduces the paper's frame dropping: a
      frame arriving with every replica slot taken gets no detection.
    * ``track_and_interpolate=True`` closes that gap with the batched
      tracker: dropped frames are emitted in arrival order with
      tracker-coasted boxes, tagged ``interpolated``.
    * ``detect_fn`` swaps the mini-SSD for any ``(images, rids) ->
      (boxes, scores, classes, valid)`` numpy callable (oracle detectors
      in tests); ``service_time`` pins the virtual per-frame service
      time so paced runs are deterministic.
    * ``params`` are the port's SSD parameters (``detector.init_ssd`` or
      ``detector.params_from_numpy``); None draws them from ``seed``.
    * ``device``: where the detector and the tracker run (see the
      module docstring).
    * ``carry_tracks=False`` opts out of seeding the tracker from
      carried portable rows (``serve(stream_tracks=...)``).
    * ``catalog=`` gives every replica a ``serving.models.ModelCatalog``
      of loadable model profiles and turns on per-micro-batch model
      selection (``serving.cascade.ModelSelector``, tuned by
      ``selector_kw``): the heaviest model whose pooled ``mu`` sustains
      the arrival-rate estimate, degrade under backlog pressure,
      hysteretic upgrade when slack returns.  ``roi=True`` adds the
      hierarchical second pass (``pipeline.roi_second_pass``) whenever
      a lighter model was selected: the first pass's ``roi_max``
      top-scored boxes, padded by ``roi_pad`` and clamped to
      ``roi_bounds``, are cropped to ``roi_crop`` pixels (default: the
      frame height) by the crop kernel and detected by the heavy model.
      ``roi_bounds`` defaults to the frame's pixel size, as in the
      reference; the built-in mini-SSD's boxes are normalized to
      [0, 1], so its callers pass ``roi_bounds=(1.0, 1.0)``.  A
      single-entry catalog never switches and never runs the ROI pass.
    * ``post_process=`` installs a ``TickState -> TickState`` stage
      after detect/NMS/ROI and before the responses and the tracker
      (the state carries the batch's model).
    * Each tracker tick is one fused tick body
      (``pipeline.make_fused_tick``): on ``cuda`` one CUDA-graph replay
      a tick, with one copy of the detection rows in and one of the
      tick's outputs back; bit-identical to the ``tracking`` module's
      staged chain.  ``fused_tick`` accepts only True.
    * ``faults=`` takes a ``serving.faults.FaultSchedule`` of
      virtual-time replica slowdowns/deaths/revivals (``fault_shard``
      picks which shard's events apply — 0 standalone).  The scheduler
      detects failures by timeout (``timeout_k`` x expected service),
      retries the in-flight frame up to ``max_retries`` times on a
      healthy replica, and the report's ``retries`` / ``failovers`` /
      ``frames_lost`` keys count the outcomes per replica.  An empty
      schedule (or ``None``) leaves every path bit-identical to an
      engine built without one.
    """

    def __init__(self, cfg=None, params=None, n_replicas: int = 4,
                 scheduler: str = "fcfs", micro_batch: Optional[int] = None,
                 max_micro_batch: int = 8,
                 replica_speeds: Optional[Sequence[float]] = None,
                 score_thr: float = 0.4, iou_thr: float = 0.5,
                 max_out: int = 32, seed: int = 0,
                 drop_when_busy: bool = False,
                 track_and_interpolate: bool = False,
                 tracker_cfg=None, detect_fn=None,
                 service_time: Optional[float] = None,
                 faults=None, fault_shard: int = 0,
                 timeout_k: float = 4.0, max_retries: int = 1,
                 recorder=None, catalog=None, selector_kw=None,
                 roi: bool = False, roi_bounds=None, roi_max: int = 4,
                 roi_pad: float = 0.1, roi_crop: Optional[int] = None,
                 fused_tick: bool = True, post_process=None,
                 carry_tracks: bool = True, device=None):
        if n_replicas < 1:
            raise ValueError(f"n_replicas must be >= 1, got {n_replicas}: "
                             "an empty replica pool can never serve")
        if not fused_tick:
            raise ValueError("fused_tick=False: the staged tick path is "
                             "gone; every tick is the fused tick")
        self.device = resolve_device(device)
        self.micro_batch = micro_batch
        self.max_micro_batch = micro_batch or max_micro_batch
        self.drop_when_busy = drop_when_busy or track_and_interpolate
        self.track_and_interpolate = track_and_interpolate
        self.service_time = service_time
        self._detect_fn = detect_fn
        if track_and_interpolate:
            from ..tracking import TrackerConfig   # lazy: avoids cycles
            self.tracker_cfg = tracker_cfg or TrackerConfig()
        if detect_fn is None:
            from ..detector import (SSDConfig, decode_detections, init_ssd,
                                    make_anchors, params_to)
            self.cfg = cfg or SSDConfig()
            self.params = params_to(
                params if params is not None else init_ssd(
                    self.cfg, torch.Generator().manual_seed(seed),
                    device=self.device),
                self.device)
            self.anchors = torch.from_numpy(
                make_anchors(self.cfg)).to(self.device)
            self._infer = lambda imgs: decode_detections(
                self.params, self.cfg, imgs, self.anchors,
                score_thr=score_thr, iou_thr=iou_thr, max_out=max_out)
        else:
            self.cfg = cfg
        speeds = list(replica_speeds or [1.0] * n_replicas)
        self.replicas = [ReplicaExecutor(i, s) for i, s in enumerate(speeds)]
        # an EMPTY schedule normalizes to None, so the no-fault path
        # attaches no views and stays bit-identical
        self.faults = faults if faults else None
        if self.faults is not None:
            for r in self.replicas:
                r.faults = self.faults.view(fault_shard, r.idx)
        self.scheduler = make_scheduler(scheduler, self.replicas,
                                        host_overhead=1e-4,
                                        timeout_k=timeout_k,
                                        max_retries=max_retries)
        # observability: None -> the shared no-op recorder
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        self.scheduler.recorder = self.recorder
        # transprecise cascade: a missing or empty catalog normalizes to
        # None and leaves every other path untouched.  The selector lives
        # on the engine, so health probes never reset its hysteresis;
        # each replica carries the catalog object.
        from .models import as_catalog
        self.catalog = as_catalog(catalog)
        self.cascade = None
        if self.catalog is not None:
            from .cascade import ModelSelector
            self.cascade = ModelSelector(self.catalog,
                                         **(selector_kw or {}))
        for r in self.replicas:
            r.catalog = self.catalog
        self.roi = bool(roi)
        self.roi_bounds = (tuple(roi_bounds) if roi_bounds is not None
                           else None)
        self.roi_max = roi_max
        self.roi_pad = roi_pad
        self.roi_crop = roi_crop
        self.post_process = post_process
        self.carry_tracks = bool(carry_tracks)
        self._exported_tracks: Dict[int, dict] = {}
        # does a custom detect_fn accept the cascade's model= / rois=
        # keywords?  A plain oracle keeps its exact 2-argument call.
        self._fn_takes_model = self._fn_takes_rois = False
        if detect_fn is not None:
            try:
                ps = inspect.signature(detect_fn).parameters
                self._fn_takes_model = "model" in ps
                self._fn_takes_rois = "rois" in ps
            except (TypeError, ValueError):
                pass
        self._warm = False

    def _detect_batch(self, images: np.ndarray, rids=None, model=None,
                      rois=None):
        """One fused launch for a full micro-batch; returns numpy
        results + measured wall seconds (the ``detect`` span's).  The
        clock is read after the device has finished.  ``model``/``rois``
        are the cascade hooks, forwarded only to detect_fns that
        declare them."""
        wall = Timed("detect")
        if self._detect_fn is not None:
            kw = {}
            if model is not None and self._fn_takes_model:
                kw["model"] = model
            if rois is not None and self._fn_takes_rois:
                kw["rois"] = rois
            out = self._detect_fn(images, rids, **kw)
        else:
            out = self._infer(torch.from_numpy(
                np.ascontiguousarray(images, np.float32)).to(self.device))
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            out = tuple(o.cpu().numpy() for o in out)
        return tuple(np.asarray(o) for o in out), wall.stop()

    def _model_caps(self) -> Dict[str, float]:
        """Summed healthy-pool service rate (frames/s) per model name,
        the feasibility signal of ``ModelSelector.decide``.  Each
        healthy replica contributes from its own catalog."""
        caps: Dict[str, float] = {}
        for r, ok in zip(self.replicas, self.scheduler.healthy):
            if not ok:
                continue
            cat = r.catalog if r.catalog is not None else self.catalog
            if cat is None:
                continue
            for p in cat:
                caps[p.name] = caps.get(p.name, 0.0) + p.mu / r.speed
        return caps

    def _apply_model(self, model: str, extra_s: float = 0.0):
        """Pin each replica's service estimate to the selected model's
        profile (plus the ROI second-pass surcharge ``extra_s``).
        Profiles without ``service_s`` leave the measured-wall estimate
        in charge."""
        for r in self.replicas:
            cat = r.catalog if r.catalog is not None else self.catalog
            prof = cat.get(model) if cat is not None else None
            if prof is not None and prof.service_s is not None:
                r._last_wall = prof.service_s + extra_s

    def warmup(self):
        mb = self.max_micro_batch
        if self._detect_fn is None:
            size = self.cfg.image_size
            imgs = np.zeros((mb, size, size, 3), np.float32)
            _, wall = self._detect_batch(imgs, rids=[-1] * mb)
            per_frame = wall / mb
        else:
            per_frame = 1e-3
        # explicit None check: a pinned ``service_time=0.0`` pins the
        # virtual clock to zero
        if self.service_time is not None:
            per_frame = self.service_time
        for r in self.replicas:
            r._last_wall = per_frame
        self._warm = True

    def reset(self):
        """Clear per-serve virtual-clock state (replica clocks, counts,
        EWMAs and the scheduler's round bookkeeping); warm service
        estimates survive.  Delegates to
        ``ServingRuntime.reset_engines``."""
        from .runtime import ServingRuntime
        ServingRuntime.reset_engines(self)

    def backlog_snapshot(self, t: float) -> Dict:
        """Virtual-clock load observation at time ``t``: ``busy_until``
        per replica, ``backlog_s`` and ``horizon_s``."""
        busy = [r.busy_until for r in self.replicas]
        return {"t": t,
                "busy_until": busy,
                "horizon_s": max(max(busy, default=0.0) - t, 0.0),
                "backlog_s": self.scheduler.backlog(t)}

    def _chunk_size(self, frames, i: int) -> int:
        """Queue depth at dispatch time (``pipeline.chunk_size``)."""
        return chunk_size(frames, i, micro_batch=self.micro_batch,
                          max_micro_batch=self.max_micro_batch,
                          replicas=self.replicas)

    @staticmethod
    def _bucket(k: int) -> int:
        """Pad adaptive batches to power-of-two buckets
        (``pipeline.bucket``)."""
        return bucket(k)

    def serve(self, frames: Sequence[FrameRequest], *, reset: bool = True,
              stream_seq0: Optional[Dict[int, int]] = None,
              stream_emit0: Optional[Dict[int, float]] = None,
              stream_tracks: Optional[Dict[int, dict]] = None) -> Dict:
        """Micro-batched detection serving: frames are grouped in arrival
        order into micro-batches, each batch runs through the batched
        fast path once, and the per-frame share of the measured wall time
        drives the virtual-clock scheduler.  With ``drop_when_busy``,
        frames arriving into a full pipeline are dropped — and, with
        ``track_and_interpolate``, re-emitted with tracker-predicted
        boxes so the output stream covers every arrival frame.

        The warm-start hooks (``reset=False``, ``stream_seq0``,
        ``stream_emit0``, ``stream_tracks``) carry a sliced trace across
        calls exactly as in the reference engine.

        The report has the reference engine's keys: ``responses`` (rid
        order), ``dropped``, ``coverage``, ``interpolated``,
        ``throughput_fps``, ``per_replica``, ``n_streams``, ``streams``,
        ``emit_t``, ``per_stream``, ``tracker_launches`` /
        ``tracker_ticks``, ``retries`` / ``failovers`` / ``frames_lost``,
        the cascade block (``models``, ``model_of_frame``,
        ``model_map_est``, ``model_switches``, ``map_estimate``,
        ``roi_pixels``, ``roi_pixel_reduction``; empty without a
        catalog) and the latency block
        (``p50_latency``, ``p95_latency``, ``p99_latency``,
        ``latency_hist``, ``interp_latency``, ``latency_by_stream``,
        ``latency_by_replica``)."""
        from .runtime import ServingRuntime
        rt = ServingRuntime(self, reset=reset, stream_seq0=stream_seq0,
                            stream_emit0=stream_emit0,
                            stream_tracks=stream_tracks)
        rt.ingest(frames)
        return rt.drain()

    def _interpolate(self, frames, responses, seq_of, emit0,
                     tracks0: Optional[Dict[int, dict]] = None,
                     rec=None) -> List[DetectionResponse]:
        """ONE batched tracker over every camera stream, advanced in
        lockstep by the shared tick pipeline (the fused tick): tick k
        covers each stream's k-th arrival frame.
        Streams whose tick-k frame was processed feed the
        associate/update/birth path; streams whose frame was dropped —
        or that have no frame left — get an all-invalid detection row,
        which is bit-identical to coasting.  Dropped frames are
        re-emitted with the coasted prediction, tagged
        ``interpolated``, ready no earlier than the newest detection of
        the SAME stream.  ``tracks0`` seeds streams from carried
        portable rows; the final table is exported per stream into
        ``self._exported_tracks``.  The ``track`` span times the ticks
        and the export (``stage_ms_track``), a ``track.tick`` span each
        pipeline call."""
        rec = NULL_RECORDER if rec is None else rec
        cfg = self.tracker_cfg
        per: Dict[int, List[FrameRequest]] = {}
        for f in frames:                    # frames sorted by arrival
            per.setdefault(f.stream_id, []).append(f)
        sids = sorted(per)
        row = {s: b for b, s in enumerate(sids)}
        B = len(sids)
        pipe = TickPipeline(cfg, device=self.device)
        rows0 = dict(tracks0) if (self.carry_tracks and tracks0) else {}
        state = pipe.seed(sids, rows0)
        if rec.enabled:
            for s in sids:
                r0 = rows0.get(s)
                if r0 is not None:
                    rec.record("track_import", per[s][0].t_arrival,
                               stream=s, next_id=int(r0["next_id"]),
                               tids=confirmed_ids(r0, cfg))
        by_rid = {r.rid: r for r in responses}
        D = responses[0].boxes.shape[0] if responses else 1
        emit_t = {s: emit0.get(s, 0.0) for s in sids}
        ticks = max(len(v) for v in per.values())
        wall = Timed("track")
        out: List[DetectionResponse] = []
        for k in range(ticks):
            tick = [(s, per[s][k] if k < len(per[s]) else None)
                    for s in sids]
            resp = {s: by_rid.get(f.rid) if f is not None else None
                    for s, f in tick}
            if any(r is not None for r in resp.values()):
                boxes = np.zeros((B, D, 4), np.float32)
                scores = np.zeros((B, D), np.float32)
                classes = np.zeros((B, D), np.int32)
                valid = np.zeros((B, D), bool)
                for s, r in resp.items():
                    if r is not None:
                        b = row[s]
                        boxes[b], scores[b] = r.boxes, r.scores
                        classes[b], valid[b] = r.classes, r.valid
                with span("track.tick"):
                    state, det_tid, coasted = pipe.tick(
                        state, boxes, scores, classes, valid)
            else:                           # no stream saw a detection
                with span("track.tick"):
                    state, coasted = pipe.coast(state, det_width=D)
            for s, f in tick:
                if f is None:
                    continue
                r, b = resp[s], row[s]
                if r is not None:
                    r.track_ids = det_tid[b]
                    emit_t[s] = max(emit_t[s], r.t_done)
                    out.append(r)
                else:
                    tb, ts, tc, tid, emit = coasted
                    t_ready = max(emit_t[s], f.t_arrival)
                    out.append(DetectionResponse(
                        f.rid, tb[b], ts[b], tc[b], emit[b], -1, t_ready,
                        t_ready, 0.0, interpolated=True,
                        track_ids=tid[b], stream_id=s, seq=seq_of[f.rid]))
        self._tracker_launches = pipe.launches
        self._tracker_ticks = ticks
        self._exported_tracks = pipe.export(state, sids)
        if rec.enabled:
            for s in sids:
                rowd = self._exported_tracks[s]
                rec.record("track_export", per[s][-1].t_arrival,
                           stream=s, next_id=int(rowd["next_id"]),
                           tids=confirmed_ids(rowd, cfg))
            rec.record("stage", frames[-1].t_arrival, stage="track",
                       launches=pipe.launches, ticks=ticks)
        track_ms = wall.stop() * 1e3
        if rec.enabled:
            rec.sample("stage_ms_track", frames[-1].t_arrival, track_ms)
        return out
