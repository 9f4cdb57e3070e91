"""Streaming latency metrics: log-bucketed histograms with mergeable
quantiles.

The paper's diagnosis method is rate *measurement* (incoming FPS vs
processing FPS vs display FPS); a single end-of-serve median hides
exactly the tail behaviour that exposes an edge bottleneck.  This
module gives the serving reports a latency distribution that

* streams — O(1) per observation, no latency list kept around,
* merges exactly — two histograms sum bucket-wise, so a sharded
  report's distribution equals the whole-run distribution (quantiles
  are recomputed from the merged buckets, NEVER averaged: an average
  of per-shard p99s is not a p99), and
* serializes — the dict form is JSON-ready and round-trips.

Bucket layout: quarter-octave log buckets anchored at ``LO`` = 1 µs.
Bucket 0 holds every latency ``<= LO``; bucket ``k >= 1`` holds
``(LO * 2^((k-1)/4), LO * 2^(k/4)]`` — ~19 %-wide buckets, so a
reported quantile (a bucket's upper edge, capped at the observed max)
is within 19 % of the exact order statistic at any scale from
microseconds to hours.  1 second lands in bucket 80:

>>> LatencyHistogram.bucket_of(1.0)
80
>>> LatencyHistogram.bucket_of(0.0)
0
>>> h = LatencyHistogram()
>>> for x in (0.010, 0.011, 0.012, 0.5):
...     h.add(x)
>>> h.n, round(h.max, 3)
(4, 0.5)
>>> round(h.quantile(0.5), 6) <= round(h.quantile(0.99), 6) == 0.5
True
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional

import numpy as np

_LOG2 = math.log(2.0)


class LatencyHistogram:
    """Log-bucketed streaming histogram (see module docstring for the
    bucket layout).  ``merge`` sums bucket counts; ``quantile``
    recomputes from the (merged) buckets.  Equality compares counts,
    n and max — the mergeable state — so a merged histogram compares
    equal to the whole-run histogram of the same observations."""

    LO = 1e-6                 # seconds: bucket-0 upper edge
    PER_OCTAVE = 4            # buckets per doubling (quarter-octave)

    def __init__(self):
        self.counts: Dict[int, int] = {}
        self.n = 0
        self.max = 0.0

    @classmethod
    def bucket_of(cls, x: float) -> int:
        if x <= cls.LO:
            return 0
        return 1 + int(math.floor(
            math.log(x / cls.LO) / _LOG2 * cls.PER_OCTAVE))

    @classmethod
    def upper_edge(cls, k: int) -> float:
        """Upper edge of bucket ``k`` in seconds."""
        return cls.LO if k <= 0 else cls.LO * 2.0 ** (k / cls.PER_OCTAVE)

    def add(self, x: float):
        k = self.bucket_of(x)
        self.counts[k] = self.counts.get(k, 0) + 1
        self.n += 1
        if x > self.max:
            self.max = float(x)

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        for k, c in other.counts.items():
            self.counts[k] = self.counts.get(k, 0) + c
        self.n += other.n
        self.max = max(self.max, other.max)
        return self

    def quantile(self, q: float) -> float:
        """The smallest bucket upper edge covering rank ``ceil(q * n)``,
        capped at the observed max (so ``quantile(1.0) == max`` and a
        top-bucket quantile never over-reports past the data).  0.0 on
        an empty histogram."""
        if self.n == 0:
            return 0.0
        rank = max(1, math.ceil(q * self.n))
        cum = 0
        for k in sorted(self.counts):
            cum += self.counts[k]
            if cum >= rank:
                return min(self.upper_edge(k), self.max)
        return self.max

    # ------------------------------------------------------ serialization
    def to_dict(self) -> dict:
        return {"lo": self.LO, "per_octave": self.PER_OCTAVE,
                "counts": dict(self.counts), "n": self.n, "max": self.max}

    @classmethod
    def from_dict(cls, d: Optional[dict]) -> "LatencyHistogram":
        h = cls()
        if d:
            h.counts = {int(k): int(c) for k, c in d["counts"].items()}
            h.n = int(d["n"])
            h.max = float(d["max"])
        return h

    def __eq__(self, other) -> bool:
        if not isinstance(other, LatencyHistogram):
            return NotImplemented
        return (self.counts == other.counts and self.n == other.n
                and self.max == other.max)

    def __repr__(self):
        return (f"LatencyHistogram(n={self.n}, max={self.max:.6f}, "
                f"buckets={len(self.counts)})")


def merge_hist_dicts(dicts: Iterable[Optional[dict]]) -> dict:
    """Sum serialized histograms bucket-wise (the shard-report merge)."""
    out = LatencyHistogram()
    for d in dicts:
        out.merge(LatencyHistogram.from_dict(d))
    return out.to_dict()


def quantile_of_dict(d: Optional[dict], q: float) -> float:
    return LatencyHistogram.from_dict(d).quantile(q)


def detection_latency_keys(responses, arrival_of=None) -> dict:
    """The latency block of a serve report, computed from final
    responses (pure post-processing: never touches the virtual clock).

    Detection latency is ``t_done - t_start`` — the frame's service
    window on its replica.  Tracker-coasted re-emissions
    (``interpolated`` / ``replica == -1``) are NOT detections and must
    not pollute the detection distribution (their service window is
    zero by construction); they land in the separate ``interp_latency``
    series instead, measured as re-emission delay ``t_done -
    t_arrival`` when ``arrival_of`` (rid -> arrival time) is given.

    Keys: ``p50_latency`` (exact median — backward-compatible with the
    pre-histogram reports), ``p95_latency`` / ``p99_latency``
    (histogram quantiles, so merged reports can recompute them exactly
    from summed buckets), ``latency_hist`` / ``interp_latency``
    (serialized histograms) and ``latency_by_stream`` /
    ``latency_by_replica`` rollups."""
    det = LatencyHistogram()
    interp = LatencyHistogram()
    by_stream: Dict[int, LatencyHistogram] = {}
    by_replica: Dict[int, LatencyHistogram] = {}
    lat: List[float] = []
    for r in responses:
        if getattr(r, "interpolated", False):
            if arrival_of is not None and r.rid in arrival_of:
                interp.add(r.t_done - arrival_of[r.rid])
            continue
        x = r.t_done - r.t_start
        lat.append(x)
        det.add(x)
        sid = getattr(r, "stream_id", 0)
        by_stream.setdefault(sid, LatencyHistogram()).add(x)
        if r.replica >= 0:
            by_replica.setdefault(r.replica, LatencyHistogram()).add(x)
    return {
        "p50_latency": float(np.median(lat)) if lat else 0.0,
        "p95_latency": det.quantile(0.95),
        "p99_latency": det.quantile(0.99),
        "latency_hist": det.to_dict(),
        "interp_latency": interp.to_dict(),
        "latency_by_stream": {s: h.to_dict()
                              for s, h in sorted(by_stream.items())},
        "latency_by_replica": {i: h.to_dict()
                               for i, h in sorted(by_replica.items())},
    }
