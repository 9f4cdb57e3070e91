"""Per-tick stage pipeline of the serving data plane (the port of the
reference package's ``serving/pipeline.py``, staged mode only).

* ``TickState``   — the value threaded through the stages: the
  micro-batch ``images``, the decoded, NMS-suppressed detections
  (``boxes``/``scores``/``classes``/``valid``), the lockstep ``tracker``
  table and the per-detection ``det_tid`` assignment.
* ``TickPipeline`` — the tracker tick driver: ``tracking.step`` /
  ``tracking.coast`` per tick, ``tracking.output`` on demand, on the
  pipeline's device.
* ``export_track_rows`` / ``build_tracker_state`` — the portable
  track-state contract: the (B, T) table splits into per-stream numpy
  rows keyed by ``stream_id`` and rebuilds with any stream subset/order.
* ``sorted_chunk`` / ``chunk_size`` / ``bucket`` / ``dispatch_time`` —
  the chunking/ordering helpers of the micro-batch loop.
* ``roi_second_pass`` — the cascade's hierarchical second pass as a
  stage over a ``TickState``: ROI windows, the crop kernel, the heavy
  model over the crops, the uncrop kernel and the per-frame top-K
  merge.

The fused one-program tick and the K-tick window come with a later
slice.
"""
from __future__ import annotations

import time
from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device


# --------------------------------------------------------------- chunking
def sorted_chunk(frames) -> List:
    """Normalize an ingest argument to a list of ``FrameRequest``
    sorted stably by arrival (a single frame passes through as
    ``[frame]``)."""
    from .engine import FrameRequest   # lazy: avoids import cycles
    if isinstance(frames, FrameRequest):
        return [frames]
    return sorted(frames, key=lambda f: f.t_arrival)


def dispatch_time(frames, i: int, replicas) -> float:
    """Virtual 'now' when the micro-batch headed by ``frames[i]``
    forms: the later of the head frame's arrival and the earliest
    replica free-up."""
    return max(frames[i].t_arrival,
               min(r.busy_until for r in replicas))


def chunk_size(frames, i: int, *, micro_batch: Optional[int],
               max_micro_batch: int, replicas) -> int:
    """Queue depth at dispatch time: how many frames have arrived by
    the moment the earliest replica frees up (at least one).  A fixed
    ``micro_batch`` short-circuits the adaptive rule."""
    if micro_batch is not None:
        return micro_batch
    t_now = dispatch_time(frames, i, replicas)
    q = 1
    while (i + q < len(frames) and q < max_micro_batch
           and frames[i + q].t_arrival <= t_now):
        q += 1
    return q


def bucket(k: int) -> int:
    """Pad adaptive batches to power-of-two buckets, so the detector
    sees the same few batch shapes as the reference.

    >>> [bucket(k) for k in (1, 2, 3, 5, 8)]
    [1, 2, 4, 8, 8]
    """
    b = 1
    while b < k:
        b <<= 1
    return b


# -------------------------------------------------------------- TickState
class TickState(NamedTuple):
    """The value threaded through the per-tick stage chain.

    Detection-side fields hold one micro-batch (leading axis = frames
    in the batch); tracker-side fields hold the lockstep table (leading
    axis = streams).

    * ``images``  — the stacked (padded) micro-batch input frames.
    * ``boxes`` / ``scores`` / ``classes`` / ``valid`` — the decoded,
      NMS-suppressed detections (fixed ``max_out`` rows, ``valid``
      masking the real ones).
    * ``model``   — the cascade model that produced them (None without
      a catalog; the heaviest model after the ROI second pass).
    * ``tracker`` — the ``tracking.TrackerState`` (B, T) table.
    * ``det_tid`` — per-detection track-id assignment from the last
      associate/Kalman stage ((B, D) int32, -1 for unused rows).
    """
    boxes: Optional[np.ndarray] = None
    scores: Optional[np.ndarray] = None
    classes: Optional[np.ndarray] = None
    valid: Optional[np.ndarray] = None
    images: Optional[np.ndarray] = None
    model: Optional[str] = None
    tracker: Optional[object] = None
    det_tid: Optional[np.ndarray] = None


# ---------------------------------------------------- portable track rows
def export_track_rows(state, sids) -> Dict[int, dict]:
    """Split the (B, T) track table into per-stream portable rows keyed
    by ``stream_id`` (batch row ``b`` belongs to ``sids[b]``)."""
    from ..tracking import export_rows    # lazy: avoids import cycles
    rows = export_rows(state)
    return {s: rows[b] for b, s in enumerate(sids)}


def build_tracker_state(rows0: Optional[Dict[int, dict]], sids, cfg,
                        device=None):
    """Tracker table for streams ``sids`` (batch row ``b`` =
    ``sids[b]``), seeding each stream from its carried row in ``rows0``
    when present and a fresh row otherwise.  ``device`` as in
    ``tracking.init_state``."""
    from ..tracking import init_state, rows_to_state
    if not rows0:
        return init_state(len(sids), cfg, device=device)
    return rows_to_state([rows0.get(s) for s in sids], cfg, device=device)


def confirmed_ids(row: dict, cfg) -> List[int]:
    """Sorted ids of the confirmed, alive tracks in one portable row."""
    m = np.asarray(row["active"]) & (np.asarray(row["hits"])
                                     >= cfg.min_hits)
    return sorted(int(t) for t in np.asarray(row["track_id"])[m])


class TickPipeline:
    """Driver for the tracker end of the tick chain: ``trk.step`` /
    ``trk.coast`` per tick (looked up on the ``tracking`` module, so a
    test can spy on them), ``trk.output`` on demand.  The table lives on
    ``device`` (None: ``cuda``, raising where no CUDA device exists);
    numpy detection rows are moved there per tick.
    ``launches`` counts tracker ticks, one per ``tick`` or ``coast``."""

    def __init__(self, cfg, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.launches = 0

    def seed(self, sids, rows0: Optional[Dict[int, dict]] = None):
        """Initial table for streams ``sids``: carried rows when given,
        fresh (== ``init_state``) otherwise."""
        return build_tracker_state(rows0, sids, self.cfg,
                                   device=self.device)

    def tick(self, state, boxes, scores, classes, valid):
        """One detection tick.  Returns ``(state, det_tid)``, with
        ``det_tid`` as numpy."""
        from .. import tracking as trk   # module attr: spy-patchable
        self.launches += 1
        dev = self.device
        args = (torch.from_numpy(np.asarray(boxes)).to(dev),
                torch.from_numpy(np.asarray(scores)).to(dev),
                torch.from_numpy(np.asarray(classes)).to(dev),
                torch.from_numpy(np.asarray(valid)).to(dev))
        state, det_tid = trk.step(state, *args, self.cfg)
        return state, det_tid.cpu().numpy()

    def coast(self, state):
        """One detection-free tick."""
        from .. import tracking as trk   # module attr: spy-patchable
        self.launches += 1
        return trk.coast(state, self.cfg)

    def output(self, state):
        """Confirmed-track output of the current table."""
        from .. import tracking as trk
        return trk.output(state, self.cfg)

    def export(self, state, sids) -> Dict[int, dict]:
        """Portable per-stream rows of the final table (see
        ``export_track_rows``)."""
        return export_track_rows(state, sids)


# ------------------------------------------------------------- ROI stage
def roi_second_pass(eng, tick: TickState, kept, pad_b: int, rec):
    """Hierarchical second pass over one micro-batch as a pipeline
    stage: the selected light model's detections (``tick.boxes``...)
    become ROI windows (top ``roi_max`` by score, padded, clamped), the
    heavy model answers only inside them, and its detections REPLACE
    the first pass's fields in the returned ``TickState``.  Also
    returns the fraction of full-frame pixels the second pass read, its
    measured wall seconds, and the pixel tallies ``{"full", "roi",
    "passes"}`` for the caller's accounting (the stage itself mutates
    nothing).

    The crop always runs through ``kernels.ops.crop_resize`` on the
    engine's device (the CUDA kernel on the card).  With the built-in
    SSD the crops stay on the device into the detector, the boxes go
    back to the parent frame through ``kernels.ops.uncrop_boxes`` and
    only then come to the host for the merge; with a cascade oracle the
    ROI windows are forwarded for the oracle's containment filter."""
    from ..kernels import ops as kops
    from .cascade import roi_pixels, rois_from_boxes
    images = tick.images
    boxes, scores = tick.boxes, tick.scores
    classes, valid = tick.classes, tick.valid
    heavy = eng.cascade.heaviest
    n = len(kept)
    R = eng.roi_max
    if eng.roi_bounds is not None:
        W, H = eng.roi_bounds
    else:
        W, H = images.shape[2], images.shape[1]
    rois = np.zeros((n, R, 4), np.float32)
    n_rois = np.zeros(n, np.int64)
    px = np.zeros(n)
    for j in range(n):
        rois[j], n_rois[j] = rois_from_boxes(
            boxes[j], scores[j], valid[j], bounds=(W, H),
            roi_max=R, pad=eng.roi_pad)
        px[j] = roi_pixels(rois[j], int(n_rois[j]), (W, H))
    px_full = float(n) * W * H
    px_roi = float(px.sum())
    t0 = time.perf_counter()
    dev = eng.device
    C = eng.roi_crop or images.shape[1]
    norm = rois / np.array([W, H, W, H], np.float32)
    norm_t = torch.from_numpy(norm).to(dev)
    crops = kops.crop_resize(
        torch.from_numpy(np.ascontiguousarray(images[:n])).to(dev),
        norm_t, out_size=C)
    if eng._detect_fn is not None:
        roi_arg = {f.rid: rois[j][:n_rois[j]]
                   for j, f in enumerate(kept)}
        out2, _ = eng._detect_batch(
            images, rids=[f.rid for f in kept] + [-1] * (pad_b - n),
            model=heavy, rois=roi_arg)
        boxes, scores, classes, valid = out2
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)     # the crop ran unread
    else:
        # built-in SSD: detect the crop tiles on the device, map boxes
        # back into the parent frame, keep the top detections per frame
        flat = crops.reshape((n * R,) + crops.shape[2:])
        bb = bucket(n * R)
        if len(flat) < bb:
            flat = torch.cat([flat, flat.new_zeros(
                (bb - len(flat),) + flat.shape[1:])], 0)
        cb, cs, cc, cv = eng._infer(flat)
        M = cb.shape[1]
        cb = kops.uncrop_boxes(cb[:n * R].reshape(n, R, M, 4),
                               norm_t[:, :, None, :], bounds=(W, H),
                               crop_size=C)
        cb, cs, cc, cv = (t.cpu().numpy() for t in
                          (cb, cs[:n * R], cc[:n * R], cv[:n * R]))
        cs = cs.reshape(n, R, M)
        cc = cc.reshape(n, R, M)
        cv = (cv.reshape(n, R, M)
              & (np.arange(R)[None, :, None] < n_rois[:, None, None]))
        K = boxes.shape[1]
        boxes, scores = boxes.copy(), scores.copy()
        classes, valid = classes.copy(), valid.copy()
        for j in range(n):
            fb = cb[j].reshape(-1, 4)
            fs = np.where(cv[j].reshape(-1), cs[j].reshape(-1),
                          -np.inf)
            top = np.argsort(-fs, kind="stable")[:K]
            keep = top[np.isfinite(fs[top])]
            boxes[j] = 0.0
            scores[j] = 0.0
            classes[j] = 0
            valid[j] = False
            boxes[j, :len(keep)] = fb[keep]
            scores[j, :len(keep)] = fs[keep]
            classes[j, :len(keep)] = cc[j].reshape(-1)[keep]
            valid[j, :len(keep)] = True
    roi_wall = time.perf_counter() - t0
    if rec.enabled:
        for j, f in enumerate(kept):
            v = np.asarray(valid[j], bool)
            fb = np.asarray(boxes[j])[v]
            ext = ([float(fb[:, 0].min()), float(fb[:, 1].min()),
                    float(fb[:, 2].max()), float(fb[:, 3].max())]
                   if len(fb) else None)
            rec.record(
                "roi_pass", f.t_arrival, rid=f.rid,
                stream=f.stream_id, model=heavy,
                n_rois=int(n_rois[j]), px_full=float(W) * float(H),
                px_roi=float(px[j]),
                rois=[[float(x) for x in row]
                      for row in rois[j][:n_rois[j]]],
                bounds=[float(W), float(H)], det_extent=ext)
        # the stage event carries only virtual-clock-deterministic
        # fields; the measured wall ms goes to the sampled series
        rec.record("stage", kept[0].t_arrival, stage="roi", frames=n)
        rec.sample("stage_ms_roi", kept[0].t_arrival, roi_wall * 1e3)
    new_tick = tick._replace(boxes=boxes, scores=scores,
                             classes=classes, valid=valid, model=heavy)
    return new_tick, (px_roi / px_full if px_full else 0.0), roi_wall, \
        {"full": px_full, "roi": px_roi, "passes": n}
