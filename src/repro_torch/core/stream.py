"""Video stream model: frames arriving at λ FPS, plus a synthetic benchmark
video generator with moving-object ground truth (stands in for the MOT-15
clips, which are not available offline).

The two benchmark specs mirror the paper's Table I:
  ADL-Rundle-6 : 30 FPS, 525 frames, 1920x1080, static camera
  ETH-Sunnyday : 14 FPS, 354 frames,  640x480, moving camera
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple

import numpy as np


@dataclass(frozen=True)
class VideoSpec:
    name: str
    fps: float              # λ — incoming video stream rate
    n_frames: int
    width: int
    height: int
    moving_camera: bool
    n_objects: int = 8
    seed: int = 0
    # object / camera speed as a fraction of frame width per frame
    obj_speed: float = 0.002
    cam_speed: float = 0.0025


ADL_RUNDLE_6 = VideoSpec("ADL-Rundle-6", 30.0, 525, 1920, 1080,
                         moving_camera=False, n_objects=10, seed=6,
                         obj_speed=0.002, cam_speed=0.0)
ETH_SUNNYDAY = VideoSpec("ETH-Sunnyday", 14.0, 354, 640, 480,
                         moving_camera=True, n_objects=8, seed=3,
                         obj_speed=0.0025, cam_speed=0.002)
BENCHMARK_VIDEOS = {v.name: v for v in (ADL_RUNDLE_6, ETH_SUNNYDAY)}


@dataclass
class Frame:
    index: int
    t_arrival: float         # seconds since stream start (= index / fps)
    boxes: np.ndarray        # ground-truth (K, 4) xyxy, pixel coords
    classes: np.ndarray      # (K,) int class ids


class SyntheticVideo:
    """Objects move with constant velocity + camera pan (moving cameras get
    a global drift, which makes stale-reused detections decay faster —
    exactly the effect the paper shows on ETH-Sunnyday)."""

    N_CLASSES = 3  # person / bicycle / car — the classes the paper shows

    def __init__(self, spec: VideoSpec):
        self.spec = spec
        rng = np.random.default_rng(spec.seed)
        W, H, K = spec.width, spec.height, spec.n_objects
        self.sizes = np.stack([rng.uniform(0.04, 0.12, K) * W,
                               rng.uniform(0.10, 0.25, K) * H], -1)
        self.pos0 = np.stack([rng.uniform(0.1, 0.9, K) * W,
                              rng.uniform(0.2, 0.8, K) * H], -1)
        # pedestrian-ish speeds: a few px/frame at the video's native fps
        speed = spec.obj_speed * W
        ang = rng.uniform(0, 2 * np.pi, K)
        self.vel = np.stack([np.cos(ang), np.sin(ang)], -1) * \
            rng.uniform(0.5, 1.5, (K, 1)) * speed
        self.cam_vel = np.array([spec.cam_speed * W, 0.0])
        self.classes = rng.integers(0, self.N_CLASSES, K)

    def boxes_at(self, frame_idx: int) -> np.ndarray:
        W, H = self.spec.width, self.spec.height
        centers = self.pos0 + frame_idx * (self.vel + self.cam_vel)
        # bounce off frame edges (keeps objects in view)
        span = np.array([W, H], float)
        centers = np.abs(np.mod(centers, 2 * span) - span)
        half = self.sizes / 2
        return np.concatenate([centers - half, centers + half], -1)

    def boxes_at_many(self, frame_idx: np.ndarray) -> np.ndarray:
        """Ground truth for many frames at once: (F,) indices ->
        (F, K, 4) xyxy.  Same math as ``boxes_at`` with the frame axis
        broadcast, so quality evaluation fetches all its GT in one call."""
        idx = np.asarray(frame_idx, float)[:, None, None]
        centers = self.pos0[None] + idx * (self.vel + self.cam_vel)[None]
        span = np.array([self.spec.width, self.spec.height], float)
        centers = np.abs(np.mod(centers, 2 * span) - span)
        half = (self.sizes / 2)[None]
        return np.concatenate([centers - half, centers + half], -1)

    def frame(self, i: int) -> Frame:
        return Frame(i, i / self.spec.fps, self.boxes_at(i), self.classes)

    def pixels(self, i: int, size: int = 64) -> np.ndarray:
        """Render a small frame tensor (for real-inference executors)."""
        img = np.zeros((size, size, 3), np.float32)
        boxes = self.boxes_at(i)
        sx, sy = size / self.spec.width, size / self.spec.height
        for b, c in zip(boxes, self.classes):
            x0, y0 = int(b[0] * sx), int(b[1] * sy)
            x1, y1 = max(int(b[2] * sx), x0 + 1), max(int(b[3] * sy), y0 + 1)
            img[max(y0, 0):y1, max(x0, 0):x1, c % 3] = 1.0
        return img


class FrameStream:
    """The live stream: frames with arrival timestamps at λ FPS."""

    def __init__(self, video: SyntheticVideo):
        self.video = video
        self.fps = video.spec.fps

    def __iter__(self):
        for i in range(self.video.spec.n_frames):
            yield self.video.frame(i)

    def __len__(self):
        return self.video.spec.n_frames
