"""The benchmark videos: a copy of the program's synthetic scenes
(``repro_torch/core/stream.py``: ``VideoSpec``, the two Table I specs and
``SyntheticVideo``'s boxes and pixels), kept here so that a change to the
program cannot move the frames the cells are measured on."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class VideoSpec:
    name: str
    fps: float
    n_frames: int
    width: int
    height: int
    moving_camera: bool
    n_objects: int = 8
    seed: int = 0
    obj_speed: float = 0.002
    cam_speed: float = 0.0025


ADL_RUNDLE_6 = VideoSpec("ADL-Rundle-6", 30.0, 525, 1920, 1080,
                         moving_camera=False, n_objects=10, seed=6,
                         obj_speed=0.002, cam_speed=0.0)
ETH_SUNNYDAY = VideoSpec("ETH-Sunnyday", 14.0, 354, 640, 480,
                         moving_camera=True, n_objects=8, seed=3,
                         obj_speed=0.0025, cam_speed=0.002)
BENCHMARK_VIDEOS = {v.name: v for v in (ADL_RUNDLE_6, ETH_SUNNYDAY)}


class SyntheticVideo:
    """Objects at constant velocity plus a camera pan, bouncing off the
    frame's edges; three classes."""

    N_CLASSES = 3

    def __init__(self, spec: VideoSpec):
        self.spec = spec
        rng = np.random.default_rng(spec.seed)
        W, H, K = spec.width, spec.height, spec.n_objects
        self.sizes = np.stack([rng.uniform(0.04, 0.12, K) * W,
                               rng.uniform(0.10, 0.25, K) * H], -1)
        self.pos0 = np.stack([rng.uniform(0.1, 0.9, K) * W,
                              rng.uniform(0.2, 0.8, K) * H], -1)
        speed = spec.obj_speed * W
        ang = rng.uniform(0, 2 * np.pi, K)
        self.vel = np.stack([np.cos(ang), np.sin(ang)], -1) * \
            rng.uniform(0.5, 1.5, (K, 1)) * speed
        self.cam_vel = np.array([spec.cam_speed * W, 0.0])
        self.classes = rng.integers(0, self.N_CLASSES, K)

    def boxes_at(self, frame_idx: int) -> np.ndarray:
        W, H = self.spec.width, self.spec.height
        centers = self.pos0 + frame_idx * (self.vel + self.cam_vel)
        span = np.array([W, H], float)
        centers = np.abs(np.mod(centers, 2 * span) - span)
        half = self.sizes / 2
        return np.concatenate([centers - half, centers + half], -1)

    def pixels(self, i: int, size: int = 64) -> np.ndarray:
        """A (size, size, 3) float32 frame: each object a filled box in
        its class's channel."""
        img = np.zeros((size, size, 3), np.float32)
        boxes = self.boxes_at(i)
        sx, sy = size / self.spec.width, size / self.spec.height
        for b, c in zip(boxes, self.classes):
            x0, y0 = int(b[0] * sx), int(b[1] * sy)
            x1, y1 = max(int(b[2] * sx), x0 + 1), max(int(b[3] * sy), y0 + 1)
            img[max(y0, 0):y1, max(x0, 0):x1, c % 3] = 1.0
        return img
