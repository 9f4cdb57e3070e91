"""Report helpers of the transprecise cascade.  Only the report block is
ported so far: the engine carries the cascade keys, empty, so its
report schema matches the reference engine's key for key.  The model
catalog, selector and ROI pass come with a later slice."""
from __future__ import annotations

from typing import Dict


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
