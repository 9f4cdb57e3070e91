"""Sharded NVR serving (the port of the reference package's
``serving/sharded.py``).

``DetectionEngine`` multiplexes every camera of an NVR deployment onto
one replica pool.  This layer carries the same serving contract across
shards: the camera set is partitioned over shards
(``sharding.serving_rules.shard_streams`` — deterministic, so every host
agrees without communicating), each shard runs its own
``DetectionEngine`` — its own scheduler, interleaved micro-batches and
lockstep ``B = cameras-per-shard`` tracker — and the per-shard reports
are merged into ONE global engine report with the exact key set
``DetectionEngine.serve`` produces.

Two detection paths
-------------------
* **Mesh path** (``mesh=`` given, a sequence of torch devices): the
  batched detect + NMS runs through ``make_spmd_detect``, shared by
  every shard, its micro-batch split over the mesh's devices in
  contiguous blocks (``constrain_frames`` / ``constrain_detections``).
  On a one-device mesh it is the engine's own detect, bit for bit.
* **Scheduler path** (``mesh=None``): the shard engines share one
  ``_infer`` and one set of weights on the device (or the caller's
  ``detect_fn`` oracle).

Single-shard regression bar: ``ShardedDetectionEngine(n_shards=1,
**kw).serve(trace)`` is bit-identical to
``DetectionEngine(**kw).serve(trace)`` — the sharded layer adds keys
(``n_shards``, ``per_shard``, ``shard_of_stream``) but never changes
the base report.
"""
from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.synchronizer import SequenceSynchronizer
from ..device import resolve_device
from ..obs.metrics import merge_hist_dicts, quantile_of_dict
from ..obs.trace import NULL_RECORDER
from ..sharding.serving_rules import (constrain_detections, constrain_frames,
                                      mesh_devices)
from .engine import DetectionEngine, FrameRequest
from .models import cascade_report_keys


def make_spmd_detect(cfg, params, mesh, *, score_thr: float = 0.4,
                     iou_thr: float = 0.5, max_out: int = 32):
    """The batched detect + NMS over every device of ``mesh`` (a
    sequence of torch devices; None entries mean ``cuda``).

    Runs the unchanged ``detector.decode_detections`` on each block of
    the micro-batch that ``constrain_frames`` places (contiguous blocks
    of ``B / n`` frames when the mesh's ``n`` devices divide ``B``, else
    the whole batch on the first device), the weights copied once to
    each device, and gathers the detections back in block order.  On a
    one-device mesh this is ``DetectionEngine``'s own detect, bit for
    bit.

    Returns an ``(images, rids=None) -> (boxes, scores, classes,
    valid)`` callable matching the ``DetectionEngine.detect_fn``
    interface: numpy in, numpy out, returning after every device of the
    mesh has finished (so the engine's wall time brackets the device
    work)."""
    from ..detector import decode_detections, make_anchors, params_to
    devices = mesh_devices(mesh)
    anchors = make_anchors(cfg)
    on = {}                        # device -> (weights, anchors) there
    for d in devices:
        if d not in on:
            on[d] = (params_to(params, d), torch.from_numpy(anchors).to(d))

    def detect(images, rids=None):
        imgs = torch.from_numpy(np.ascontiguousarray(images, np.float32))
        outs = []
        for d, blk in zip(devices, constrain_frames(imgs, devices)):
            p, anc = on[d]
            outs.append(decode_detections(p, cfg, blk, anc,
                                          score_thr=score_thr,
                                          iou_thr=iou_thr, max_out=max_out))
        out = constrain_detections(outs)
        for d in on:
            if d.type == "cuda":
                torch.cuda.synchronize(d)
        return tuple(o.cpu().numpy() for o in out)

    return detect


def _offsets(pool_sizes: Sequence[int]) -> List[int]:
    """Each shard's first global replica id (cumsum of the pool sizes
    before it)."""
    offsets = [0] * len(pool_sizes)
    for h in range(1, len(pool_sizes)):
        offsets[h] = offsets[h - 1] + pool_sizes[h - 1]
    return offsets


def _renumber_and_collect(frames: Sequence[FrameRequest],
                          reports: Sequence[Dict],
                          report_shard: Sequence[int],
                          pool_sizes: Sequence[int]):
    """Shared merge scaffolding for ``merge_shard_reports`` (one report
    per shard) and ``merge_epoch_shard_reports`` (one per epoch x
    shard): renumber replica ids by the owning shard's pool offset (on
    COPIES — never the caller's responses; offset 0 reuses the original
    objects so single-shard reports stay bit-identical), collect
    responses in rid order and dropped rids in global arrival order
    (stable on ties, like the engine's own sort), sum the per-call
    ``per_replica`` counts into the globally-renumbered map, and
    rebuild the per-stream view from the merged responses with the
    engine's own reorder helper — so ``streams`` holds the SAME objects
    as ``responses``, the DetectionEngine contract.

    Returns ``(responses, dropped, makespan, per_replica, streams,
    emit_t)``."""
    offsets = _offsets(pool_sizes)
    per_replica: Dict[int, int] = {
        offsets[h] + i: 0 for h in range(len(pool_sizes))
        for i in range(pool_sizes[h])}
    responses = []
    for rep, h in zip(reports, report_shard):
        off = offsets[h]
        for idx, count in rep["per_replica"].items():
            per_replica[off + idx] += count
        for r in rep["responses"]:
            if off and r.replica >= 0:
                r = replace(r, replica=r.replica + off)
            responses.append(r)
    responses.sort(key=lambda r: r.rid)
    pos = {f.rid: i for i, f in
           enumerate(sorted(frames, key=lambda f: f.t_arrival))}
    dropped = sorted((rid for rep in reports for rid in rep["dropped"]),
                     key=pos.__getitem__)
    makespan = max((r.t_done for r in responses), default=0.0)
    ordered = SequenceSynchronizer.order_per_stream(responses)
    streams = {sid: rs for sid, (rs, _) in ordered.items()}
    emit_t = {sid: em for sid, (_, em) in ordered.items()}
    return responses, dropped, makespan, per_replica, streams, emit_t


def _merged_fault_counts(reports: Sequence[Dict],
                         report_shard: Sequence[int],
                         pool_sizes: Sequence[int]) -> Dict[str, Dict]:
    """Sum the per-replica failure counters (``retries`` / ``failovers``
    / ``frames_lost``) across shard reports, renumbering replica ids by
    the owning shard's pool offset exactly like ``per_replica``.  The
    keys stay sparse (all-empty on the fault-free path), mirroring the
    single-engine report."""
    offsets = _offsets(pool_sizes)
    out: Dict[str, Dict] = {"retries": {}, "failovers": {},
                            "frames_lost": {}}
    for rep, h in zip(reports, report_shard):
        for key, agg in out.items():
            for idx, c in rep.get(key, {}).items():
                g = offsets[h] + idx
                agg[g] = agg.get(g, 0) + c
    return out


def _merged_latency_keys(responses, reports: Sequence[Dict],
                         report_shard: Sequence[int],
                         pool_sizes: Sequence[int]) -> Dict:
    """Rebuild the latency block of a merged report: histograms SUM
    bucket-wise across shard reports and the quantiles are recomputed
    from the merged buckets — never averaged (an average of per-shard
    p99s is not a p99).  ``p50_latency`` is recomputed exactly (median
    over the merged detection latencies, the engine's formula), so a
    single-shard merge is bit-identical to the shard's own report.
    ``latency_by_replica`` keys renumber by the owning shard's pool
    offset like ``per_replica``."""
    det = merge_hist_dicts(rep.get("latency_hist") for rep in reports)
    interp = merge_hist_dicts(rep.get("interp_latency")
                              for rep in reports)
    by_stream: Dict[int, List] = {}
    by_replica: Dict[int, List] = {}
    offsets = _offsets(pool_sizes)
    for rep, h in zip(reports, report_shard):
        for sid, d in rep.get("latency_by_stream", {}).items():
            by_stream.setdefault(sid, []).append(d)
        for idx, d in rep.get("latency_by_replica", {}).items():
            by_replica.setdefault(offsets[h] + idx, []).append(d)
    lat = [r.t_done - r.t_start for r in responses if not r.interpolated]
    return {
        "p50_latency": float(np.median(lat)) if lat else 0.0,
        "p95_latency": quantile_of_dict(det, 0.95),
        "p99_latency": quantile_of_dict(det, 0.99),
        "latency_hist": det,
        "interp_latency": interp,
        "latency_by_stream": {sid: merge_hist_dicts(ds)
                              for sid, ds in sorted(by_stream.items())},
        "latency_by_replica": {g: merge_hist_dicts(ds)
                               for g, ds in sorted(by_replica.items())},
    }


def _epoch_rollup(reports: Sequence[Dict]) -> Dict:
    """One epoch's latency/volume rollup for the ``per_epoch`` key."""
    det = merge_hist_dicts(rep.get("latency_hist") for rep in reports)
    return {
        "responses": sum(len(rep["responses"]) for rep in reports),
        "dropped": sum(len(rep["dropped"]) for rep in reports),
        "interpolated": sum(rep["interpolated"] for rep in reports),
        "latency_hist": det,
        "p95_latency": quantile_of_dict(det, 0.95),
        "p99_latency": quantile_of_dict(det, 0.99),
    }


def _merged_cascade_keys(reports: Sequence[Dict], n_frames: int) -> Dict:
    """Merge the transprecise-cascade block: raw counters sum (model
    counts, switches, roi pixels) or union (``model_of_frame`` /
    ``model_map_est``), then the derived scalars are RECOMPUTED by the
    same ``cascade_report_keys`` the engines use — never averaged — so a
    single-shard merge is bit-identical to the shard's own report."""
    counts: Dict[str, int] = {}
    model_of: Dict[int, str] = {}
    map_est: Dict[str, float] = {}
    switches = 0
    roi_px = {"full": 0.0, "roi": 0.0, "passes": 0}
    for rep in reports:
        for m, c in rep.get("models", {}).items():
            counts[m] = counts.get(m, 0) + c
        model_of.update(rep.get("model_of_frame", {}))
        map_est.update(rep.get("model_map_est", {}))
        switches += rep.get("model_switches", 0)
        rp = rep.get("roi_pixels", {})
        roi_px["full"] += rp.get("full", 0.0)
        roi_px["roi"] += rp.get("roi", 0.0)
        roi_px["passes"] += rp.get("passes", 0)
    return cascade_report_keys(counts, model_of, map_est, switches,
                               roi_px, n_frames)


def merge_shard_reports(frames: Sequence[FrameRequest],
                        reports: Sequence[Dict],
                        pool_sizes: Sequence[int]) -> Dict:
    """Merge per-shard ``DetectionEngine.serve`` reports into one global
    engine report.

    Streams are disjoint across shards, so the per-stream maps
    (``streams`` / ``emit_t`` / ``per_stream``) merge by union; global
    scalars (``coverage``, ``throughput_fps``) are recomputed from the
    merged responses with the same formulas ``DetectionEngine`` uses;
    replica ids are renumbered globally (shard ``h``'s replica ``i``
    becomes ``offset(h) + i`` with ``offset = cumsum(pool_sizes)``) —
    both the ``per_replica`` map and every ``DetectionResponse.replica``
    field (the ``-1`` tracker-interpolated sentinel excepted).  With a
    single shard every merged key is bit-identical to the shard's own
    report.

    Adds the shard-level view on top: ``n_shards`` and ``per_shard``
    (per-shard frame/response/drop/tracker counts).  The caller attaches
    ``shard_of_stream``.  Each shard runs its OWN lockstep tracker, so
    the merged ``tracker_launches`` SUMS over shards while
    ``tracker_ticks`` is the MAX (the shards tick in parallel)."""
    responses, dropped, makespan, per_replica, streams, emit_t = \
        _renumber_and_collect(frames, reports, range(len(reports)),
                              pool_sizes)
    per_stream: Dict[int, Dict] = {}
    for rep in reports:
        per_stream.update(rep["per_stream"])
        for sid in rep["streams"]:
            streams.setdefault(sid, [])      # streams with 0 responses
            emit_t.setdefault(sid, [])
    return {
        "responses": responses,
        "dropped": dropped,
        "coverage": len(responses) / max(len(frames), 1),
        "interpolated": sum(rep["interpolated"] for rep in reports),
        "throughput_fps": len(responses) / max(makespan, 1e-9),
        "per_replica": per_replica,
        "n_streams": sum(rep["n_streams"] for rep in reports),
        "streams": streams,
        "emit_t": emit_t,
        "per_stream": per_stream,
        "tracker_launches": sum(rep["tracker_launches"]
                                for rep in reports),
        "tracker_ticks": max((rep["tracker_ticks"] for rep in reports),
                             default=0),
        **_merged_fault_counts(reports, range(len(reports)), pool_sizes),
        **_merged_latency_keys(responses, reports, range(len(reports)),
                               pool_sizes),
        **_merged_cascade_keys(reports, len(frames)),
        "per_epoch": {0: _epoch_rollup(reports)},
        "n_shards": len(reports),
        "per_shard": [{
            "streams": sorted(rep["per_stream"]),
            "frames": sum(v["frames"] for v in rep["per_stream"].values()),
            "responses": len(rep["responses"]),
            "dropped": len(rep["dropped"]),
            "interpolated": rep["interpolated"],
            "tracker_launches": rep["tracker_launches"],
            "tracker_ticks": rep["tracker_ticks"],
            "latency_hist": merge_hist_dicts([rep.get("latency_hist")]),
        } for rep in reports],
    }


def merge_epoch_shard_reports(frames: Sequence[FrameRequest],
                              reports: Sequence[Dict],
                              report_shard: Sequence[int],
                              pool_sizes: Sequence[int],
                              report_epoch: Optional[Sequence[int]] = None,
                              ) -> Dict:
    """Merge per-(epoch, shard) ``DetectionEngine.serve`` reports into
    one global engine report — the epoch-loop generalization of
    ``merge_shard_reports``.

    A stream may appear in SEVERAL reports (later epochs, and — after a
    migration — a different shard), so per-stream stats are SUMMED
    across reports instead of unioned, and the per-stream response order
    / emit clocks are rebuilt globally from the merged responses.
    Replica ids renumber by shard exactly as in ``merge_shard_reports``;
    per-call ``per_replica`` counts sum across epochs.  ``per_shard``
    aggregates each shard over its epochs (its ``streams`` names every
    stream the shard served at least one frame for).  Global
    ``tracker_launches`` sums over shards AND epochs; global
    ``tracker_ticks`` is the max over shards of each shard's summed
    epoch ticks (shards tick in parallel, epochs in series).  The caller
    attaches ``shard_of_stream`` / ``migrations`` / ``n_epochs``.

    Histograms sum bucket-wise across every (epoch, shard) report,
    quantiles are recomputed from the merged buckets (never averaged),
    and ``p50_latency`` is the exact median over the merged responses.
    ``report_epoch`` (the raw epoch index of each report, parallel to
    ``report_shard``) buckets the ``per_epoch`` rollup; when omitted
    every report lands in epoch 0."""
    n_shards = len(pool_sizes)
    epochs_of = (list(report_epoch) if report_epoch is not None
                 else [0] * len(reports))
    responses, dropped, makespan, per_replica, streams, emit_t = \
        _renumber_and_collect(frames, reports, report_shard, pool_sizes)
    per_stream: Dict[int, Dict] = {}
    per_shard = [{"streams": set(), "frames": 0, "responses": 0,
                  "dropped": 0, "interpolated": 0, "tracker_launches": 0,
                  "tracker_ticks": 0, "_hists": []}
                 for _ in range(n_shards)]
    for rep, h in zip(reports, report_shard):
        for sid, v in rep["per_stream"].items():
            agg = per_stream.setdefault(
                sid, {"frames": 0, "dropped": 0, "interpolated": 0})
            agg["frames"] += v["frames"]
            agg["dropped"] += v["dropped"]
            agg["interpolated"] += v["interpolated"]
            if v["frames"]:
                per_shard[h]["streams"].add(sid)
            per_shard[h]["frames"] += v["frames"]
        per_shard[h]["responses"] += len(rep["responses"])
        per_shard[h]["dropped"] += len(rep["dropped"])
        per_shard[h]["interpolated"] += rep["interpolated"]
        per_shard[h]["tracker_launches"] += rep["tracker_launches"]
        per_shard[h]["tracker_ticks"] += rep["tracker_ticks"]
        per_shard[h]["_hists"].append(rep.get("latency_hist"))
    for sh in per_shard:
        sh["streams"] = sorted(sh["streams"])
        sh["latency_hist"] = merge_hist_dicts(sh.pop("_hists"))
    for sid, agg in per_stream.items():
        rs = streams.setdefault(sid, [])
        em = emit_t.setdefault(sid, [])
        agg["coverage"] = len(rs) / max(agg["frames"], 1)
        agg["throughput_fps"] = len(rs) / max(em[-1] if em else 0.0, 1e-9)
    return {
        "responses": responses,
        "dropped": dropped,
        "coverage": len(responses) / max(len(frames), 1),
        "interpolated": sum(rep["interpolated"] for rep in reports),
        "throughput_fps": len(responses) / max(makespan, 1e-9),
        "per_replica": per_replica,
        "n_streams": len(per_stream),
        "streams": streams,
        "emit_t": emit_t,
        "per_stream": per_stream,
        "tracker_launches": sum(rep["tracker_launches"]
                                for rep in reports),
        "tracker_ticks": max((sh["tracker_ticks"] for sh in per_shard),
                             default=0),
        **_merged_fault_counts(reports, report_shard, pool_sizes),
        **_merged_latency_keys(responses, reports, report_shard,
                               pool_sizes),
        **_merged_cascade_keys(reports, len(frames)),
        "per_epoch": {
            e: _epoch_rollup([rep for rep, re_ in zip(reports, epochs_of)
                              if re_ == e])
            for e in sorted(set(epochs_of))},
        "n_shards": n_shards,
        "per_shard": per_shard,
    }


class ShardedDetectionEngine:
    """NVR detection serving partitioned over shards.

    ``n_shards`` shards each own a full ``DetectionEngine`` (replica
    pool, scheduler, micro-batching, lockstep tracker with ``B =
    cameras assigned to the shard``); the camera set is split by the
    deterministic ``shard_streams`` partition and the per-shard reports
    merge into one global report.  Every ``DetectionEngine`` keyword is
    accepted and forwarded verbatim to the shard engines, so
    ``n_shards=1`` is a transparent wrapper: same trace in,
    bit-identical report out (plus the ``n_shards`` / ``per_shard`` /
    ``shard_of_stream`` extras).

    ``device`` is where the shard engines run their trackers (and,
    without a mesh, the detector): None means ``cuda``, raising where no
    CUDA device exists.  ``mesh`` (a sequence of torch devices) runs the
    detection through one ``make_spmd_detect`` shared by all shards, its
    micro-batch split over the mesh's devices.  It requires the built-in
    mini-SSD (a numpy ``detect_fn`` oracle is an error beside it);
    ``replica_speeds`` keep working because speeds scale the *virtual*
    service clock.  Without a mesh the shard engines share one set of
    weights on the device and one ``_infer``.

    Cross-shard work stealing (``rebalance=True``): ``serve`` splits the
    trace into ``epoch_s``-second virtual-time epochs; after each epoch
    every shard's backlog/drop pressure is observed
    (``DetectionEngine.backlog_snapshot`` + the epoch report) and
    ``sharding.serving_rules.rebalance_streams`` migrates up to
    ``max_moves_per_epoch`` whole camera streams from the most pressured
    shard to the least pressured one, at epoch boundaries only.  Each
    stream's portable track rows, ``seq`` and emit clock carry to its
    new shard.  ``rebalance=False`` (the default) and ``n_shards=1``
    keep the static single-pass path.

    ``faults=`` (a ``serving.faults.FaultSchedule``) injects replica
    events into each shard's pool and folds shard events into the epoch
    loop; ``supervisor=`` (a ``serving.supervisor.Watchdog``) restarts
    dead shards, evacuates their cameras and lends replicas.  Shard
    events and the supervisor need ``rebalance=True`` and >= 2 shards.
    """

    def __init__(self, n_shards: int = 1, mesh=None, cfg=None, params=None,
                 seed: int = 0, detect_fn=None, score_thr: float = 0.4,
                 iou_thr: float = 0.5, max_out: int = 32,
                 rebalance: bool = False, epoch_s: float = 4.0,
                 max_moves_per_epoch: int = 1, faults=None,
                 supervisor=None, recorder=None, device=None,
                 **engine_kwargs):
        if n_shards < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        if epoch_s <= 0:
            raise ValueError(f"epoch_s must be > 0, got {epoch_s}")
        self.rebalance = rebalance
        self.epoch_s = epoch_s
        self.max_moves_per_epoch = max_moves_per_epoch
        # an empty schedule normalizes to None: fault-free paths stay
        # bit-identical
        self.faults = faults if faults else None
        self.supervisor = supervisor
        if self.faults is not None and self.faults.has_shard_events and (
                not rebalance or n_shards < 2):
            raise ValueError(
                "shard-level fault events are folded into the epoch "
                "loop: they require rebalance=True and n_shards >= 2 "
                "(replica-level events work on any configuration)")
        if supervisor is not None and (not rebalance or n_shards < 2):
            raise ValueError(
                "the watchdog supervises epoch boundaries: supervisor= "
                "requires rebalance=True and n_shards >= 2")
        if mesh is not None and detect_fn is not None:
            raise ValueError(
                "mesh= (the mesh detect) and detect_fn= (a host-side "
                "oracle) are mutually exclusive: drop mesh= to use the "
                "scheduler path")
        self.device = resolve_device(device)
        self.n_shards = n_shards
        self.mesh = mesh
        self._shared_detect = None
        self._spmd_warm = False
        if detect_fn is None:
            # the shards are replicas of ONE model: one set of weights
            from ..detector import SSDConfig, init_ssd
            cfg = cfg or SSDConfig()
            if params is None:
                params = init_ssd(cfg, torch.Generator().manual_seed(seed),
                                  device=self.device)
        self.cfg = cfg
        if mesh is not None:
            self._shared_detect = make_spmd_detect(
                cfg, params, mesh, score_thr=score_thr, iou_thr=iou_thr,
                max_out=max_out)
            shard_detect_kw = dict(detect_fn=self._shared_detect, cfg=cfg)
        else:
            shard_detect_kw = dict(detect_fn=detect_fn, cfg=cfg,
                                   params=params, seed=seed,
                                   score_thr=score_thr, iou_thr=iou_thr,
                                   max_out=max_out)
        # each shard engine traces through a shard_view(h) of the one
        # recorder; the watchdog shares it for loan/restart events
        self.recorder = recorder if recorder is not None else NULL_RECORDER
        if supervisor is not None:
            supervisor.recorder = self.recorder
        self.engines = [DetectionEngine(**shard_detect_kw, **engine_kwargs,
                                        faults=self.faults, fault_shard=h,
                                        recorder=self.recorder.shard_view(h),
                                        device=self.device)
                        for h in range(n_shards)]
        if mesh is None and detect_fn is None:
            # one detector for all shards (the weights above, on the
            # device once): the first engine's _infer
            for eng in self.engines[1:]:
                eng._infer = self.engines[0]._infer

    # ------------------------------------------------------------- warmup
    def warmup(self):
        """Warm every shard engine, plus — on the mesh path — run the
        shared detect once at every micro-batch bucket the engines can
        emit (fixed ``micro_batch``, or the powers of two up to the one
        covering ``max_micro_batch``), so no served batch's measured wall
        time includes a first call's set-up."""
        for eng in self.engines:
            if not eng._warm:
                eng.warmup()
        if self._shared_detect is not None and not self._spmd_warm:
            size = self.cfg.image_size
            eng = self.engines[0]
            if eng.micro_batch is not None:
                shapes = [eng.micro_batch]
            else:
                shapes, b = [], 1
                while b < DetectionEngine._bucket(eng.max_micro_batch):
                    shapes.append(b)
                    b <<= 1
                shapes.append(b)
            for b in shapes:
                self._shared_detect(
                    np.zeros((b, size, size, 3), np.float32))
            self._spmd_warm = True

    # ------------------------------------------------------------- serving
    def serve(self, frames: Sequence[FrameRequest]) -> Dict:
        """Partition the trace's cameras over the shards, serve each
        shard's sub-trace through its own engine, and merge the
        per-shard reports into one global report (same keys as
        ``DetectionEngine.serve`` plus ``n_shards`` / ``per_shard`` /
        ``shard_of_stream``).

        With ``rebalance=True`` (and more than one shard) the trace is
        served in ``epoch_s`` virtual-second epochs with cross-shard
        work stealing between them; the report gains ``migrations`` (one
        ``{"epoch", "stream", "src", "dst"}`` record per move) and
        ``n_epochs``, and ``shard_of_stream`` is the FINAL partition.
        With ``faults=`` (or ``supervisor=``) the report also gains
        ``faults`` (``{"n_events", "frames_lost_shard", "restarts",
        "loans"}``) and ``recovered_coverage`` (the minimum per-stream
        coverage over frames arriving after the last fault / recovery
        action took effect)."""
        from .runtime import ServingRuntime
        rt = ServingRuntime(self)
        rt.ingest(frames)
        return rt.drain()

    def reset(self):
        """Clear per-serve virtual-clock state on EVERY shard engine
        (``ServingRuntime.reset_engines``)."""
        from .runtime import ServingRuntime
        ServingRuntime.reset_engines(self)

    # -------------------------------------------------------- fault report
    def _attach_fault_keys(self, out: Dict, frames, lost, restarts,
                           loans, t_rec):
        """Attach ``faults`` (what happened and what the supervision did
        about it) and ``recovered_coverage``."""
        out["faults"] = {
            "n_events": len(self.faults) if self.faults is not None else 0,
            "frames_lost_shard": len(lost),
            "restarts": restarts,
            "loans": loans,
        }
        out["recovered_coverage"] = self._recovered_coverage(
            out, frames, t_rec)

    @staticmethod
    def _recovered_coverage(out: Dict, frames, t_rec) -> float:
        """Minimum per-stream coverage over frames arriving at or after
        ``t_rec`` (the first epoch boundary after the last fault or
        recovery action).  ``None`` (no fault ever fired) reads 1.0."""
        if t_rec is None:
            return 1.0
        total: Dict[int, int] = {}
        by_rid: Dict[int, FrameRequest] = {}
        for f in frames:
            by_rid[f.rid] = f
            if f.t_arrival >= t_rec:
                total[f.stream_id] = total.get(f.stream_id, 0) + 1
        if not total:
            return 1.0            # the trace ended before recovery did
        got: Dict[int, int] = {}
        for r in out["responses"]:
            f = by_rid.get(r.rid)
            if f is not None and f.t_arrival >= t_rec:
                got[f.stream_id] = got.get(f.stream_id, 0) + 1
        return min(got.get(sid, 0) / n for sid, n in sorted(total.items()))
