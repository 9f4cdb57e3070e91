"""Per-tick stage pipeline of the serving data plane (the port of the
reference package's ``serving/pipeline.py``).

* ``TickState``   — the value threaded through the stages: the
  micro-batch ``images``, the decoded, NMS-suppressed detections
  (``boxes``/``scores``/``classes``/``valid``), the lockstep ``tracker``
  table and the per-detection ``det_tid`` assignment.
* ``TickPipeline`` — the tracker tick driver on the pipeline's device:
  one fused tick body (step, then output) every tick, detections or
  not, returning the tick's outputs with it.
* ``make_fused_tick`` / ``fused_window`` — the fused tick and a K-tick
  window of it as plain functions.
* ``export_track_rows`` / ``build_tracker_state`` — the portable
  track-state contract: the (B, T) table splits into per-stream numpy
  rows keyed by ``stream_id`` and rebuilds with any stream subset/order.
* ``sorted_chunk`` / ``chunk_size`` / ``bucket`` / ``dispatch_time`` —
  the chunking/ordering helpers of the micro-batch loop.
* ``roi_second_pass`` — the cascade's hierarchical second pass as a
  stage over a ``TickState``: ROI windows, the crop kernel, the heavy
  model over the crops, the uncrop kernel and the per-frame top-K
  merge.

Fused ticks and CUDA graphs
---------------------------
The reference compiles the fused tick as one jitted program with the
track table donated.  Here, on the CPU, the fused body runs eagerly; on
``cuda`` it is a CUDA graph (``TickGraph``, through
``ops.CountedGraph``) captured once per (K, B, D) shape over static
buffers: the ten ``TrackerState`` tensors, the detection rows packed
into one int32 tensor, and the packed outputs.  The body is the
``tracking`` module's staged chain (``trk.step``, then ``trk.output``),
so the bits are that chain's; only the launches change.  A tick copies
its rows into the static input from pinned memory (one copy), replays
the graph and copies ``det_tid`` and the outputs back in one copy.
The body ends by writing the new table into the static one, which is
the state returned: as with the reference's donation, the state passed
in must not be used again.  An all-invalid detection row is
bit-identical to ``coast`` (every lifecycle write is masked by
match/birth bits an invalid row cannot set), which is what lets
``TickPipeline`` run one graph every tick.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..kernels import ops
from ..obs.trace import Timed


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


# ------------------------------------------------------- fused tick program
def _tick_body(state, boxes, scores, classes, valid, cfg):
    """One tick exactly as the staged chain runs it: ``trk.step``, then
    ``trk.output`` (looked up on the ``tracking`` module)."""
    from .. import tracking as trk     # module attr: spy-patchable
    state, det_tid = trk.step(state, boxes, scores, classes, valid, cfg)
    return state, det_tid, trk.output(state, cfg)


def pack_rows(boxes, scores, classes, valid) -> np.ndarray:
    """Detection rows ``boxes`` (..., B, D, 4), ``scores`` / ``classes``
    / ``valid`` (..., B, D) as one (..., B, 7D) int32 array: the float32
    bits of the boxes and scores, the int32 classes, valid as 0/1."""
    scores = np.asarray(scores, np.float32)
    lead, D = scores.shape[:-1], scores.shape[-1]
    boxes = np.ascontiguousarray(boxes, np.float32)
    return np.concatenate(
        [boxes.reshape(lead + (4 * D,)).view(np.int32),
         np.ascontiguousarray(scores).view(np.int32),
         np.asarray(classes).astype(np.int32),
         np.asarray(valid).astype(np.int32)], -1)


def unpack_rows(x, D: int):
    """Views of a (B, 7D) int32 tensor from ``pack_rows`` as
    ``(boxes (B, D, 4), scores, classes, valid)``."""
    B = x.shape[0]
    return (x[:, :4 * D].view(torch.float32).reshape(B, D, 4),
            x[:, 4 * D:5 * D].view(torch.float32), x[:, 5 * D:6 * D],
            x[:, 6 * D:] != 0)


def pack_outputs(det_tid, out):
    """A tick's ``det_tid`` (B, D) and output tuple (boxes (B, T, 4),
    scores, classes, track ids, emit (B, T)) as one (B, D + 8T) int32
    tensor."""
    boxes, scores, classes, tids, emit = out
    B = det_tid.shape[0]
    return torch.cat([det_tid, boxes.reshape(B, -1).view(torch.int32),
                      scores.view(torch.int32), classes, tids,
                      emit.to(torch.int32)], 1)


def unpack_outputs(a: np.ndarray, D: int, T: int):
    """Inverse of ``pack_outputs`` on (..., B, D + 8T) int32 host rows:
    ``(det_tid, (boxes, scores, classes, track_ids, emit))``, each a
    numpy array of its own."""
    lead = a.shape[:-1]
    col = D + 4 * T
    return a[..., :D].copy(), (
        a[..., D:col].copy().view(np.float32).reshape(lead + (T, 4)),
        a[..., col:col + T].copy().view(np.float32),
        a[..., col + T:col + 2 * T].copy(),
        a[..., col + 2 * T:col + 3 * T].copy(),
        a[..., col + 3 * T:] != 0)


class TickGraph:
    """K unrolled tick bodies over static buffers, captured once as one
    CUDA graph (``ops.CountedGraph``) and replayed per call.

    Before capture the body runs once eagerly on a side stream: the
    first launch of a kernel loads its module, which a capturing stream
    does not allow.  That warm-up throws its table away (the tracker
    step is functional), and its launches ran, so they stay counted.
    ``captured`` holds the launches a replay runs (the graph adds them
    at each replay); ``replays`` counts the replays."""

    def __init__(self, cfg, K: int, B: int, D: int, device):
        from .. import tracking as trk
        self.cfg, self.shape, self.device = cfg, (K, B, D), device
        cuda = device.type == "cuda"
        T = cfg.capacity
        self.state = trk.init_state(B, cfg, device=device)
        self.inp = torch.zeros((K, B, 7 * D), dtype=torch.int32,
                               device=device)
        self.h_in = torch.zeros(self.inp.shape, dtype=torch.int32,
                                pin_memory=cuda)
        self.h_out = torch.empty((K, B, D + 8 * T), dtype=torch.int32,
                                 pin_memory=cuda)
        self._h_in, self._h_out = self.h_in.numpy(), self.h_out.numpy()
        self.owner = None            # the state the last call returned
        self.replays = 0
        side = torch.cuda.Stream(device) if cuda else None
        if cuda:
            side.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(side):
            self._body(commit=False)
        if cuda:
            torch.cuda.current_stream(device).wait_stream(side)
        self.graph = ops.CountedGraph(lambda: self._body(commit=True),
                                      device)
        self.captured = self.graph.captured

    def _body(self, commit: bool):
        """The K tick bodies over the static table and input; returns the
        packed outputs (K, B, D + 8T).  ``commit`` writes the new table
        into the static one (the captured body); the warm-up drops it."""
        D = self.shape[2]
        state, packed = self.state, []
        for x in self.inp:
            state, det_tid, out = _tick_body(state, *unpack_rows(x, D),
                                             self.cfg)
            packed.append(pack_outputs(det_tid, out))
        if commit:
            for dst, src in zip(self.state, state):
                dst.copy_(src)
        return torch.stack(packed)

    def __call__(self, state, rows: np.ndarray):
        """Replay over ``state`` and the (K, B, 7D) packed ``rows``.
        Returns the static table (as a new ``TrackerState``) and the
        packed outputs, copied to the host.  A state that is not the one
        the last call returned is copied into the static table first; a
        stale one made of the static buffers raises."""
        from .. import tracking as trk
        if state is not self.owner:
            if all(a is b for a, b in zip(state, self.state)):
                raise RuntimeError(
                    "this tracker state was passed to a later fused tick "
                    "of the same shape: thread the state each tick "
                    "returns")
            for dst, src in zip(self.state, state):
                dst.copy_(src)
        self._h_in[...] = rows
        self.inp.copy_(self.h_in, non_blocking=True)
        out = self.graph.replay()
        self.replays += 1
        self.h_out.copy_(out, non_blocking=True)
        if self.device.type == "cuda":
            torch.cuda.current_stream(self.device).synchronize()
        self.owner = trk.TrackerState(*self.state)
        return self.owner, self._h_out.copy()


# (cfg, K, B, D, device) -> its TickGraph
_GRAPHS: Dict[tuple, TickGraph] = {}


def tick_graphs() -> List[TickGraph]:
    """The captured tick graphs, one per (cfg, K, B, D, device)."""
    return list(_GRAPHS.values())


def clear_tick_graphs() -> None:
    """Drop every captured tick graph (and its memory pool)."""
    _GRAPHS.clear()


def graph_ticks(state, boxes, scores, classes, valid, cfg):
    """K ticks over (K, B, D[, 4]) numpy rows as one replay of the
    (K, B, D) ``TickGraph`` of ``state``'s device, captured at first
    use.  Returns ``(state, det_tid (K, B, D), out)``, the outputs numpy
    and stacked on the tick axis.  What the fused tick and window run on
    ``cuda``; nothing in it but ``ops.CountedGraph`` needs a card."""
    rows = pack_rows(boxes, scores, classes, valid)
    K, B, D = rows.shape[0], rows.shape[1], rows.shape[2] // 7
    key = (cfg, K, B, D, state.active.device)
    graph = _GRAPHS.get(key)
    if graph is None:
        graph = _GRAPHS[key] = TickGraph(*key)
    state, packed = graph(state, rows)
    return (state,) + unpack_outputs(packed, D, cfg.capacity)


def _fused(state, boxes, scores, classes, valid, cfg):
    """K fused ticks over (K, B, D[, 4]) numpy rows: an eager loop on
    the CPU, ``graph_ticks`` elsewhere.  Returns ``(state, det_tid
    (K, B, D), out)`` as numpy, outputs stacked on the tick axis."""
    dev = state.active.device
    if dev.type != "cpu":
        return graph_ticks(state, boxes, scores, classes, valid, cfg)
    tids, outs = [], []
    for row in zip(boxes, scores, classes, valid):
        state, det_tid, out = _tick_body(
            state, *(torch.from_numpy(np.asarray(a)).to(dev) for a in row),
            cfg)
        tids.append(det_tid.numpy())
        outs.append([a.numpy() for a in out])
    return state, np.stack(tids), tuple(np.stack(a) for a in zip(*outs))


def make_fused_tick(cfg):
    """The fused tick as a plain callable ``(state, boxes, scores,
    classes, valid) -> (state, det_tid, (boxes, scores, classes,
    track_ids, emit))`` over one tick's numpy rows, with ``cfg`` closed
    over; the results are numpy.  On ``cuda`` one graph per (B, D)
    shape.  The input ``state`` must not be used again: thread the
    returned one."""
    def tick(state, boxes, scores, classes, valid):
        state, det_tid, out = _fused(
            state, *(np.asarray(a)[None]
                     for a in (boxes, scores, classes, valid)), cfg)
        return state, det_tid[0], tuple(a[0] for a in out)
    return tick


def fused_window(state, boxes, scores, classes, valid, cfg):
    """Run a K-tick window as one graph replay on ``cuda`` (an eager
    loop on the CPU).  ``boxes`` (K, B, D, 4), ``scores``/``classes``/
    ``valid`` (K, B, D) are the window's stacked numpy detection rows
    (all-invalid rows for detection-free ticks); returns ``(state,
    det_tid (K, B, D), out)`` with every output stacked along the tick
    axis, as numpy.  The input ``state`` must not be used again: thread
    the returned one.  One graph per (K, B, D) shape: callers with
    windows of varying length should bucket K."""
    return _fused(state, boxes, scores, classes, valid, cfg)


class TickPipeline:
    """Driver for the tracker end of the tick chain: the fused tick
    (``make_fused_tick``) every tick, detections or not (an all-invalid
    row is bit-identical to coasting), returning the tick's outputs with
    it.  The table lives on ``device`` (None: ``cuda``, raising where no
    CUDA device exists).  ``launches`` counts tracker ticks, one per
    ``tick`` or ``coast``."""

    def __init__(self, cfg, *, device=None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.launches = 0
        self._fused_tick = make_fused_tick(cfg)

    def seed(self, sids, rows0: Optional[Dict[int, dict]] = None):
        """Initial table for streams ``sids``: carried rows when given,
        fresh (== ``init_state``) otherwise."""
        return build_tracker_state(rows0, sids, self.cfg,
                                   device=self.device)

    def tick(self, state, boxes, scores, classes, valid):
        """One detection tick over numpy rows.  Returns ``(state,
        det_tid, out)``, ``det_tid`` and the tick's confirmed-track
        output tuple ``out`` as numpy."""
        self.launches += 1
        return self._fused_tick(state, boxes, scores, classes, valid)

    def coast(self, state, det_width: int = 1):
        """One detection-free tick: the fused tick over an all-invalid
        (B, det_width) row, bit-identical to ``tracking.coast``.  Returns
        ``(state, out)``.  ``det_width`` should match the segment's
        detection width so one graph covers every tick."""
        self.launches += 1
        B, D = state.active.shape[0], det_width
        state, _, out = self._fused_tick(
            state, np.zeros((B, D, 4), np.float32),
            np.zeros((B, D), np.float32), np.zeros((B, D), np.int32),
            np.zeros((B, D), bool))
        return state, out

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
    measured wall seconds (the ``roi`` span's), and the pixel tallies
    ``{"full", "roi", "passes"}`` for the caller's accounting (the stage
    itself mutates nothing).

    The crop always runs through ``kernels.ops.crop_resize`` on the
    engine's device (the CUDA kernel on the card).  With the built-in
    SSD the crops stay on the device into the detector, the boxes go
    back to the parent frame through ``kernels.ops.uncrop_boxes`` and
    only then come to the host for the merge; with a cascade oracle the
    ROI windows are forwarded for the oracle's containment filter."""
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
    wall = Timed("roi")
    dev = eng.device
    C = eng.roi_crop or images.shape[1]
    norm = rois / np.array([W, H, W, H], np.float32)
    norm_t = torch.from_numpy(norm).to(dev)
    crops = ops.crop_resize(
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
        cb = ops.uncrop_boxes(cb[:n * R].reshape(n, R, M, 4),
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
    roi_wall = wall.stop()
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
