"""Deterministic virtual-time model selection for cascade serving (a
copy of the reference package's ``serving/cascade.py``: numpy and plain
Python, so the selector replays the reference decision for decision).

``ModelSelector`` picks the model per micro-batch to maximize expected
quality subject to the incoming-FPS constraint (TOD, arXiv 2105.08668:
pick size/precision from the latency budget).  All inputs are virtual-
clock quantities the scheduler already exposes — the batch formation
time, the batch size, ``scheduler.backlog(t)`` and the per-model
healthy-pool capacities — so selection is a pure function of the trace
and replays bit-identically.

Selection state machine (heaviest-first order over the catalog)::

            rate > cap(cur)            rate > cap(cur)
        ┌────────────────────┐     ┌────────────────────┐
        │                    ▼     │                    ▼
    [heavy]              [medium]              [fast/lightest]
        ▲                    │     ▲                    │
        └────────────────────┘     └────────────────────┘
          hold consecutive slack decisions AND
          cap(next) * headroom >= rate AND backlog small

    plus, from any state: backlog above the degrade bar -> one step
    lighter (early warning before the rate EWMA catches a burst).

* **degrade** is immediate and can jump several tiers at once — the
  moment the arrival-rate estimate exceeds the healthy pool's summed
  ``mu`` for the current model, drop to the heaviest *feasible* model;
* **upgrade** is damped (hysteresis): the next-heavier model must look
  feasible with ``upgrade_headroom`` to spare, the backlog must be
  small, and both must hold for ``hold`` consecutive decisions.  The
  band between ``headroom * cap`` and ``cap`` is sticky in both
  directions, so selection cannot flap on a rate sitting near a
  capacity boundary.

The selector starts at the LIGHTEST model: the first few decisions ramp
up as slack is proven, which keeps cascade drops bounded by the
fast-model baseline even when the trace opens with a burst.

Selector state lives on the ENGINE (``engine.cascade``), not on the
scheduler — ``probe_health`` restores and pool resizes must not reset
hysteresis.

``rois_from_boxes`` is the geometry half of the hierarchical second
pass (SNIPPETS.md §3): the first pass's top-scored boxes, padded and
clamped to the frame, become the ROI windows the heavy model reads.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from .models import ModelCatalog


class ModelSelector:
    """Hysteretic heaviest-feasible-model policy over a catalog.

    ``decide`` is called once per micro-batch; it maintains an EWMA
    arrival-rate estimate from the batch sizes and virtual formation
    times, and returns ``(model_name, switched)``.

    Thresholds are expressed in frames of the relevant model's
    reference service time (``k / mu``), so one set of defaults works
    across catalogs with different absolute speeds:

    * degrade when ``backlog_s > degrade_backlog_frames / mu(cur)``;
    * upgrade only while ``backlog_s <= upgrade_backlog_frames /
      mu(next_heavier)``.
    """

    def __init__(self, catalog: ModelCatalog, *,
                 upgrade_headroom: float = 0.7,
                 hold: int = 2,
                 rate_alpha: float = 0.5,
                 degrade_backlog_frames: float = 6.0,
                 upgrade_backlog_frames: float = 2.0):
        self.catalog = catalog
        self._order = catalog.by_quality()       # heaviest first
        self.upgrade_headroom = float(upgrade_headroom)
        self.hold = int(hold)
        self.rate_alpha = float(rate_alpha)
        self.degrade_backlog_frames = float(degrade_backlog_frames)
        self.upgrade_backlog_frames = float(upgrade_backlog_frames)
        self._cur = len(self._order) - 1         # start lightest
        self._streak = 0                         # consecutive slack decisions
        self._rate: Optional[float] = None       # EWMA arrivals/s
        self._last_t: Optional[float] = None
        self.switches = 0

    @property
    def current(self) -> str:
        return self._order[self._cur].name

    @property
    def heaviest(self) -> str:
        return self._order[0].name

    def rate_estimate(self) -> float:
        return self._rate if self._rate is not None else 0.0

    def decide(self, t: float, n_arrived: int, backlog_s: float,
               caps: Dict[str, float]) -> Tuple[str, bool]:
        """Pick the model for the micro-batch forming at virtual time
        ``t`` with ``n_arrived`` frames, given the scheduler's committed
        backlog (seconds of residual service) and ``caps`` = summed
        healthy-pool ``mu`` per model name (frames/s)."""
        order = self._order
        if self._last_t is not None and t > self._last_t:
            inst = n_arrived / (t - self._last_t)
            a = self.rate_alpha
            self._rate = (inst if self._rate is None
                          else (1.0 - a) * self._rate + a * inst)
        self._last_t = t
        rate = self._rate if self._rate is not None else 0.0
        prev = self._cur
        last = len(order) - 1

        def cap(i: int) -> float:
            return caps.get(order[i].name, 0.0)

        def feasible(i: int, margin: float = 1.0) -> bool:
            c = cap(i)
            return c > 0.0 and c * margin >= rate

        # Degrade: jump straight to the heaviest feasible model at or
        # below the current one — a burst can overrun several tiers in
        # one decision, and stopping halfway just defers drops.
        while self._cur < last and not feasible(self._cur):
            self._cur += 1
        # Backlog pressure: one extra step lighter per decision.  The
        # committed work drains at pool speed, so a single step is the
        # stable early-warning response while the EWMA catches up.
        if (self._cur < last and backlog_s * order[self._cur].mu
                > self.degrade_backlog_frames):
            self._cur += 1

        if self._cur != prev:
            self._streak = 0
        elif (self._cur > 0
              and feasible(self._cur - 1, self.upgrade_headroom)
              and backlog_s * order[self._cur - 1].mu
              <= self.upgrade_backlog_frames):
            self._streak += 1
            if self._streak >= self.hold:
                self._cur -= 1
                self._streak = 0
        else:
            self._streak = 0

        switched = self._cur != prev
        if switched:
            self.switches += 1
        return order[self._cur].name, switched


def rois_from_boxes(boxes: np.ndarray, scores: np.ndarray,
                    valid: np.ndarray, *, bounds: Tuple[float, float],
                    roi_max: int = 4, pad: float = 0.1):
    """First-pass detections -> padded, clamped ROI windows.

    ``boxes``/``scores``/``valid`` are one frame's rows from the
    detection output (xyxy, absolute coordinates in ``bounds`` =
    ``(W, H)`` space).  Returns ``(rois, n)`` where ``rois`` is a
    dense ``(roi_max, 4)`` float32 array whose first ``n`` rows are the
    top-``roi_max`` highest-scoring valid boxes grown by ``pad`` on
    each side and clamped to the frame; remaining rows are zero
    (degenerate windows with zero area).
    """
    W, H = float(bounds[0]), float(bounds[1])
    rois = np.zeros((roi_max, 4), np.float32)
    v = np.asarray(valid, bool)
    b = np.asarray(boxes, np.float64)[v]
    s = np.asarray(scores, np.float64)[v]
    if len(b) == 0:
        return rois, 0
    top = np.argsort(-s, kind="stable")[:roi_max]
    sel = b[top]
    pw = (sel[:, 2] - sel[:, 0]) * pad
    ph = (sel[:, 3] - sel[:, 1]) * pad
    out = np.stack([np.clip(sel[:, 0] - pw, 0.0, W),
                    np.clip(sel[:, 1] - ph, 0.0, H),
                    np.clip(sel[:, 2] + pw, 0.0, W),
                    np.clip(sel[:, 3] + ph, 0.0, H)], axis=-1)
    n = len(out)
    rois[:n] = out.astype(np.float32)
    return rois, n


def roi_pixels(rois: np.ndarray, n: int,
               bounds: Tuple[float, float]) -> float:
    """Pixels the second pass reads for one frame: the summed window
    areas, capped at the full frame (overlapping windows cannot cost
    more than reading the whole frame once)."""
    W, H = float(bounds[0]), float(bounds[1])
    r = np.asarray(rois[:n], np.float64)
    if len(r) == 0:
        return 0.0
    areas = (np.clip(r[:, 2] - r[:, 0], 0.0, None)
             * np.clip(r[:, 3] - r[:, 1], 0.0, None))
    return float(min(areas.sum(), W * H))
