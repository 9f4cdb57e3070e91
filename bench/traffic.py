"""The one traffic generator: it reads a mix's data file
(``bench/traffic/<name>.json``) and the seed, and yields the cell's
inputs.  Two kinds of mix, named by the file's ``kind``:

* ``cameras``: ``cameras`` streams at ``fps`` frames a second, camera
  ``s`` showing video ``videos[s % len(videos)]`` from a start frame the
  seed draws, looped over ``pool_frames`` frames (rendered once, so host
  memory stays bounded).  Frames arrive phase-staggered as in the
  program's NVR streams: camera ``s``'s ``k``-th frame at
  ``(k + s / cameras) / fps`` seconds of video, with rid ``k * cameras +
  s``.  The feed is closed-loop, one tick (every camera's next frame) at
  a time.
* ``requests``: a fixed set of ``set_size`` (prompt, output) length
  pairs at the quantiles of the stated log-uniform ranges, paired by a
  fixed permutation; the seed only orders them (a fresh permutation a
  pass over the set) and draws the token ids.  Every seed thus serves
  the same sizes, in another order.

Nothing here imports the program: the generator hands out plain tuples
and arrays."""
from __future__ import annotations

import numpy as np

from .video import BENCHMARK_VIDEOS, SyntheticVideo


class Cameras:
    def __init__(self, mix: dict, seed: int, image_size: int):
        self.n = mix["cameras"]
        self.fps = float(mix["fps"])
        self.pool = mix["pool_frames"]
        rng = np.random.default_rng([seed, 1])
        names = mix["videos"]
        self.video_of = [names[s % len(names)] for s in range(self.n)]
        self.start = [int(rng.integers(BENCHMARK_VIDEOS[v].n_frames))
                      for v in self.video_of]
        need = {}
        for s, v in enumerate(self.video_of):
            n_v = BENCHMARK_VIDEOS[v].n_frames
            need.setdefault(v, set()).update(
                (self.start[s] + j) % n_v for j in range(self.pool))
        self._pixels = {}
        for v, idx in need.items():
            vid = SyntheticVideo(BENCHMARK_VIDEOS[v])
            for i in sorted(idx):
                self._pixels[v, i] = vid.pixels(i, image_size)

    def image(self, cam: int, k: int) -> np.ndarray:
        """Camera ``cam``'s ``k``-th frame (a shared array: read only)."""
        v = self.video_of[cam]
        n_v = BENCHMARK_VIDEOS[v].n_frames
        return self._pixels[v, (self.start[cam] + k % self.pool) % n_v]

    def tick(self, k: int):
        """Tick ``k``: ``(rid, camera, t_arrival, image)`` of each
        camera's ``k``-th frame, in arrival order."""
        return [(k * self.n + s, s, (k + s / self.n) / self.fps,
                 self.image(s, k)) for s in range(self.n)]

    def frame_of(self, rid: int):
        """``(camera, k)`` of frame ``rid``."""
        return rid % self.n, rid // self.n


def _loguniform_quantiles(lo: int, hi: int, n: int) -> np.ndarray:
    q = (np.arange(n) + 0.5) / n
    return np.round(np.exp(np.log(lo) + q * (np.log(hi) - np.log(lo)))
                    ).astype(np.int64)


class Requests:
    def __init__(self, mix: dict, seed: int, vocab: int):
        n = mix["set_size"]
        prompts = _loguniform_quantiles(*mix["prompt_len"], n)
        outs = _loguniform_quantiles(*mix["output_len"], n)
        pair = np.random.default_rng(mix["pairing_seed"]).permutation(n)
        self.sizes = list(zip(prompts.tolist(), outs[pair].tolist()))
        self._rng = np.random.default_rng([seed, 2])
        self.vocab = vocab
        self._order = []

    def next(self):
        """The next request: ``(prompt tokens (P,) int32, output length)``."""
        if not self._order:
            self._order = list(self._rng.permutation(len(self.sizes)))
        p, o = self.sizes[self._order.pop(0)]
        toks = self._rng.integers(0, self.vocab, p).astype(np.int32)
        return toks, o

    @property
    def longest_total(self) -> int:
        return max(p + o for p, o in self.sizes)
