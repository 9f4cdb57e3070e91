"""Loadable model profiles and the report block of transprecise cascade
serving (the port of the reference package's ``serving/models.py``;
numpy and plain Python, no tensor code).

A ``ModelProfile`` is one loadable detector with a sustained service
rate ``mu`` and a calibrated quality estimate ``map_est``; a
``ModelCatalog`` is the set of profiles every ``ReplicaExecutor`` can
switch between.  ``paper_catalog`` builds the fast/medium/heavy triple
calibrated from the ``ProxyDetector`` paper bands
(``core.quality.NOISE``): YOLOv3 heavy, SSD300 medium, tiny-YOLO fast.

``make_cascade_detect_fn`` is the multi-model oracle: the engine passes
``model=`` to select the band per micro-batch, and ``rois=`` on the
hierarchical second pass (the heavy model answers only inside the first
pass's ROI windows, detections clipped to their covering ROI).

``cascade_report_keys`` is the one place the cascade block of a serve
report is derived from raw counters.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.quality import ProxyDetector


@dataclass(frozen=True)
class ModelProfile:
    """One loadable detector model.

    * ``map_est`` — calibrated quality estimate (orders the catalog:
      heaviest = highest ``map_est``) and the weight behind the
      report's ``map_estimate``.
    * ``band`` — the ``core.quality.NOISE`` band the proxy oracle
      detects with when this model is selected.
    * ``service_s`` — pinned virtual per-frame service seconds on a
      speed-1.0 replica (like the engine's ``service_time``); ``None``
      leaves the measured-wall service estimate in charge.
    * ``mu`` — sustained frames/s on a speed-1.0 replica; defaults to
      ``1 / service_s``.  The selector's feasibility test compares the
      pool's summed ``mu`` against the arrival-rate estimate.
    """
    name: str
    map_est: float
    band: str = "yolov3"
    service_s: Optional[float] = None
    mu: Optional[float] = None

    def __post_init__(self):
        if self.mu is None:
            if self.service_s is None or self.service_s <= 0:
                raise ValueError(
                    f"profile {self.name!r} needs mu= or a positive "
                    f"service_s= to derive it (got {self.service_s})")
            object.__setattr__(self, "mu", 1.0 / self.service_s)


class ModelCatalog:
    """Ordered, immutable set of ``ModelProfile``s with unique names.

    The catalog object itself rides on every ``ReplicaExecutor``
    (``r.catalog``), so replica lending moves it with the executor and
    a dead replica's catalog leaves the capacity pool with it."""

    def __init__(self, profiles: Sequence[ModelProfile]):
        profiles = tuple(profiles)
        if not profiles:
            raise ValueError("a ModelCatalog needs at least one profile "
                             "(pass catalog=None for no cascade at all)")
        names = [p.name for p in profiles]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate profile names in catalog: {names}")
        self.profiles = profiles
        self._by_name = {p.name: p for p in profiles}

    def get(self, name: str) -> Optional[ModelProfile]:
        return self._by_name.get(name)

    def __getitem__(self, name: str) -> ModelProfile:
        return self._by_name[name]

    def __contains__(self, name: str) -> bool:
        return name in self._by_name

    def __len__(self) -> int:
        return len(self.profiles)

    def __iter__(self):
        return iter(self.profiles)

    @property
    def names(self):
        return tuple(p.name for p in self.profiles)

    def by_quality(self) -> List[ModelProfile]:
        """Profiles sorted heaviest (highest ``map_est``) first; ties
        keep catalog order (stable sort)."""
        return sorted(self.profiles, key=lambda p: -p.map_est)

    @property
    def heaviest(self) -> ModelProfile:
        return self.by_quality()[0]

    @property
    def lightest(self) -> ModelProfile:
        return self.by_quality()[-1]

    def map_est_by_name(self) -> Dict[str, float]:
        return {p.name: p.map_est for p in self.profiles}

    def __repr__(self):
        return f"ModelCatalog({list(self.names)})"


def as_catalog(catalog) -> Optional[ModelCatalog]:
    """Normalize an engine's ``catalog=`` argument: ``None`` / empty ->
    ``None`` (no cascade layer at all — the bit-identical default),
    a sequence of profiles -> a ``ModelCatalog``."""
    if not catalog:
        return None
    if isinstance(catalog, ModelCatalog):
        return catalog
    return ModelCatalog(catalog)


def paper_catalog(heavy_service_s: float = 0.4) -> ModelCatalog:
    """The fast/medium/heavy triple calibrated from the paper bands:
    YOLOv3 (heavy, high recall), SSD300 (medium), tiny-YOLO (fast,
    4x the heavy model's rate at roughly half its quality).  The
    ``map_est`` values are the proxy bands' tracked-mAP plateaus on the
    ETH-Sunnyday scene; relative ORDER is what the selector needs."""
    return ModelCatalog([
        ModelProfile("heavy", map_est=0.88, band="yolov3",
                     service_s=heavy_service_s),
        ModelProfile("medium", map_est=0.62, band="ssd300",
                     service_s=heavy_service_s / 2),
        ModelProfile("fast", map_est=0.45, band="yolov3_tiny",
                     service_s=heavy_service_s / 4),
    ])


def make_cascade_detect_fn(videos: Dict, frame_of, catalog,
                           max_out: int = 24):
    """Multi-model proxy oracle for ``DetectionEngine.detect_fn``.

    Same ``(images, rids) -> (boxes, scores, classes, valid)`` contract
    as ``core.quality.proxy_detect_fn_streams``, plus two keyword
    hooks the engine probes for:

    * ``model=`` — the catalog profile name whose noise band answers
      this micro-batch (default: the heaviest profile, so an engine
      WITHOUT a catalog scores exactly like a fixed heavy-model run);
    * ``rois=`` — ``{rid: (R, 4) xyxy windows}`` for the hierarchical
      second pass: only detections whose center lies inside a window
      survive, clipped to their covering window (a second-pass box can
      never escape the region the first pass proposed — the audit's
      roi-containment invariant holds by construction).

    Detectors are memoized per (stream, band): a band's detections are
    a pure function of (band, stream seed, frame), so a fixed-model
    baseline and the cascade score identically wherever they pick the
    same model."""
    catalog = as_catalog(catalog)
    default = catalog.heaviest.name
    band_of = {p.name: p.band for p in catalog}
    detectors: Dict[tuple, ProxyDetector] = {}

    def det_for(sid: int, band: str) -> ProxyDetector:
        key = (sid, band)
        if key not in detectors:
            detectors[key] = ProxyDetector(band, videos[sid].spec.name,
                                           seed=sid)
        return detectors[key]

    def detect(images, rids, model=None, rois=None):
        band = band_of[model if model is not None else default]
        B = len(images)
        per_det: Dict[int, List[int]] = {}
        for rid in rids:
            if rid < 0:
                continue
            sid, k = frame_of[rid]
            per_det.setdefault(sid, []).append(k)
        for sid, ks in per_det.items():
            det_for(sid, band).detect_many(videos[sid], ks)
        boxes = np.zeros((B, max_out, 4), np.float32)
        scores = np.zeros((B, max_out), np.float32)
        classes = np.zeros((B, max_out), np.int32)
        valid = np.zeros((B, max_out), bool)
        for i, rid in enumerate(rids):
            if rid < 0:                     # batch padding row
                continue
            sid, k = frame_of[rid]
            d = det_for(sid, band).detect(videos[sid], k)
            db, ds, dc = d.boxes, d.scores, d.classes
            if rois is not None:
                rw = np.asarray(rois.get(rid, ()), float).reshape(-1, 4)
                if len(rw) == 0 or len(db) == 0:
                    db, ds, dc = db[:0], ds[:0], dc[:0]
                else:
                    cx = (db[:, 0] + db[:, 2]) / 2
                    cy = (db[:, 1] + db[:, 3]) / 2
                    inside = ((rw[None, :, 0] <= cx[:, None])
                              & (cx[:, None] <= rw[None, :, 2])
                              & (rw[None, :, 1] <= cy[:, None])
                              & (cy[:, None] <= rw[None, :, 3]))
                    hit = inside.any(-1)
                    cover = rw[inside.argmax(-1)[hit]]
                    db, ds, dc = db[hit], ds[hit], dc[hit]
                    db = np.stack([np.maximum(db[:, 0], cover[:, 0]),
                                   np.maximum(db[:, 1], cover[:, 1]),
                                   np.minimum(db[:, 2], cover[:, 2]),
                                   np.minimum(db[:, 3], cover[:, 3])], -1)
            n = min(len(db), max_out)
            boxes[i, :n] = db[:n]
            scores[i, :n] = ds[:n]
            classes[i, :n] = dc[:n]
            valid[i, :n] = True
        return boxes, scores, classes, valid

    return detect


def cascade_report_keys(model_counts: Dict[str, int],
                        model_of_frame: Dict[int, str],
                        model_map_est: Dict[str, float],
                        model_switches: int,
                        roi_pixels: Dict[str, float],
                        n_frames: int) -> Dict:
    """The cascade block of a serve report, derived from raw counters:

    * ``models`` — frames detected per model;
    * ``model_of_frame`` — ``{rid: model name}`` for every detected
      frame;
    * ``model_map_est`` — the catalog's quality estimates;
    * ``model_switches`` — selector transitions this report covers;
    * ``map_estimate`` — ``sum(count_m * map_est_m) / n_frames``;
    * ``roi_pixels`` / ``roi_pixel_reduction`` — second-pass pixel
      accounting.

    Every key is present (empty/0.0) on a catalog-less engine."""
    est = 0.0
    for m in sorted(model_counts):
        est += model_counts[m] * model_map_est.get(m, 0.0)
    full = float(roi_pixels.get("full", 0.0))
    roi = float(roi_pixels.get("roi", 0.0))
    return {
        "models": dict(model_counts),
        "model_of_frame": dict(model_of_frame),
        "model_map_est": dict(model_map_est),
        "model_switches": int(model_switches),
        "map_estimate": est / n_frames if n_frames else 0.0,
        "roi_pixels": {"full": full, "roi": roi,
                       "passes": int(roi_pixels.get("passes", 0))},
        "roi_pixel_reduction": 1.0 - roi / full if full > 0 else 0.0,
    }
