"""The proxy detector: each camera's detections drawn from the seed as
the scene's ground truth with a detector's errors (localization and size
jitter, misses, false positives), in the video's pixel coordinates, the
way the program's own proxy detector models a trained SSD300 or YOLOv3
(``repro_torch/core/quality.py``).  A cell whose configuration names a
``proxy`` detector serves these rows through ``DetectionEngine``'s
``detect_fn``: the detections are the cell's input, like its frames, and
the scheduler, the tracker and the runtime are what it measures.

Every row of a camera's frame pool is drawn in set-up, so a detect call
in the window is a table lookup."""
from __future__ import annotations

import numpy as np

from .video import BENCHMARK_VIDEOS, SyntheticVideo


class ProxyDetections:
    """``(boxes (N, P, D, 4), scores, classes, valid)`` of camera ``s``'s
    ``P`` pool frames, ``D`` = ``max_out`` rows each (the first ones
    real, the rest invalid)."""

    def __init__(self, cams, det: dict, seed: int, max_out: int):
        n, P, D = cams.n, cams.pool, max_out
        self.n, self.pool = n, P
        self.boxes = np.zeros((n, P, D, 4), np.float32)
        self.scores = np.zeros((n, P, D), np.float32)
        self.classes = np.zeros((n, P, D), np.int32)
        self.valid = np.zeros((n, P, D), bool)
        videos = {}
        for s in range(n):
            name = cams.video_of[s]
            vid = videos.setdefault(name, SyntheticVideo(
                BENCHMARK_VIDEOS[name]))
            self._draw(s, vid, cams, det, np.random.default_rng(
                [seed, 4, s]), D)

    def _draw(self, s, vid, cams, det, rng, D):
        spec = vid.spec
        diff = det["difficulty"][spec.name]
        jit = 1.0 + 0.3 * (diff - 1.0)
        miss = min(det["miss"] * min(diff, det["max_miss_diff"]), 0.9)
        W, H = spec.width, spec.height
        for j in range(self.pool):
            gt = vid.boxes_at((cams.start[s] + j) % spec.n_frames)
            K = len(gt)
            keep = rng.random(K) >= miss
            wh = gt[:, 2:] - gt[:, :2]
            c = (gt[:, :2] + gt[:, 2:]) / 2 + \
                rng.standard_normal((K, 2)) * det["c"] * jit * wh
            wh = wh * np.exp(rng.standard_normal((K, 2)) * det["s"] * jit)
            tp = np.concatenate([c - wh / 2, c + wh / 2], -1)[keep]
            n_fp = min(int(rng.poisson(det["fp"] * diff)), det["fp_max"])
            fwh = np.stack([(0.03 + 0.12 * rng.random(n_fp)) * W,
                            (0.06 + 0.24 * rng.random(n_fp)) * H], -1)
            fc = np.stack([rng.random(n_fp) * W, rng.random(n_fp) * H], -1)
            boxes = np.concatenate(
                [tp, np.concatenate([fc - fwh / 2, fc + fwh / 2], -1)])
            m = min(len(boxes), D)
            self.boxes[s, j, :m] = boxes[:m]
            self.scores[s, j, :m] = np.concatenate([
                0.55 + 0.44 * rng.random(int(keep.sum())),
                0.1 + 0.55 * rng.random(n_fp)])[:m]
            self.classes[s, j, :m] = np.concatenate([
                vid.classes[keep],
                rng.integers(0, vid.N_CLASSES, n_fp)])[:m]
            self.valid[s, j, :m] = True

    def rows(self, rids):
        """The rows of frames ``rids`` (rid ``k * n + s``; a negative rid
        is a padding frame with no detection)."""
        r = np.asarray(rids, np.int64)
        s, k = r % self.n, (r // self.n) % self.pool
        real = (r >= 0)[:, None]
        return (np.where(real[..., None], self.boxes[s, k], 0),
                np.where(real, self.scores[s, k], 0),
                np.where(real, self.classes[s, k], 0),
                self.valid[s, k] & real)

    def detect_fn(self):
        """``DetectionEngine``'s ``detect_fn``: ``(images, rids) ->
        (boxes, scores, classes, valid)``."""
        return lambda images, rids: self.rows(rids)
