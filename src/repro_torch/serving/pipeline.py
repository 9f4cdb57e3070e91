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

The fused one-program tick and the K-tick window come with a later
slice.
"""
from __future__ import annotations

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
    * ``model``   — the cascade model that produced them (always None
      until the cascade is ported).
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
