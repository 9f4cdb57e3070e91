"""Detection quality model + real mAP evaluation.

MOT-15 videos and pretrained SSD/YOLO weights are not available
offline, so detection outputs come from a *proxy detector*: a
well-trained detector is modelled as ground truth + localization jitter +
misses + false positives, with noise levels per model class (SSD300 is
noisier than YOLOv3, matching the paper's mAP ordering).  The mAP math
(greedy IoU matching + all-point-interpolated AP) is real — and the
paper's central quality effect is mechanical: dropped frames reuse stale
detections, object motion decays their IoU against the current frame, and
mAP falls exactly as in Tables IV/V.

``evaluate_map`` is the vectorized scorer (batched GT fetch, per-source
class partitioning, argmax-based greedy matcher); ``evaluate_map_loop``
keeps the seed's Python-loop implementation as the equality oracle.
``evaluate_map_dets`` scores a stream whose per-frame detections are
given explicitly (the tracked/interpolated stream), and
``track_quality`` adds the tracker-identity counters (ID switches,
object coverage, fragmentation).

Noise synthesis is a batched counter-based sampler (splitmix64-style
hashing -> uniforms -> Box-Muller normals / inverse-CDF Poisson): every
frame's detections are a pure function of (model, seed, frame) — batch
composition and evaluation order can't change them — and a whole run's
noise is drawn in a handful of vectorized calls instead of per-frame
PCG streams.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Sequence
from zlib import crc32

import numpy as np

from .stream import SyntheticVideo
from .synchronizer import SyncedFrame

# (center jitter, size jitter, miss rate, false positives per frame)
NOISE = {
    # max_miss_diff caps how much scene difficulty compounds the miss rate
    # (SSD's recall is already low; the paper's ADL/ETH gap is mostly
    # localization+precision for SSD, recall for YOLO)
    "yolov3": dict(c=0.05, s=0.055, miss=0.13, fp=0.5, max_miss_diff=99.0),
    "ssd300": dict(c=0.06, s=0.07, miss=0.28, fp=1.3, max_miss_diff=1.5),
    # tiny-YOLO band for the transprecise cascade's fast first pass:
    # clearly worse than both paper models (high miss, noisy fps) so
    # the fast/medium/heavy quality ordering is strict
    "yolov3_tiny": dict(c=0.08, s=0.09, miss=0.38, fp=2.0,
                        max_miss_diff=1.3),
}
# per-video difficulty multiplier (ADL-Rundle-6 is the harder scene in the
# paper: 1080p static camera, more/smaller objects)
DIFFICULTY = {"ADL-Rundle-6": 2.8, "ETH-Sunnyday": 1.0}


@dataclass
class Detections:
    boxes: np.ndarray      # (K, 4) xyxy
    classes: np.ndarray    # (K,)
    scores: np.ndarray     # (K,)


# ------------------------------------------------ counter-based sampler
# splitmix64-style finalizer over uint64 arrays: every random draw is
# keyed by (frame key, stream id, element index), so the sampler is a
# pure function of the frame — batchable to any width with zero state.
_G = np.uint64(0x9E3779B97F4A7C15)
_M1 = np.uint64(0xBF58476D1CE4E5B9)
_M2 = np.uint64(0x94D049BB133111EB)
_M3 = np.uint64(0xD6E8FEB86659FD93)


def _mix64(x: np.ndarray) -> np.ndarray:
    x = (x ^ (x >> np.uint64(30))) * _M1
    x = (x ^ (x >> np.uint64(27))) * _M2
    return x ^ (x >> np.uint64(31))


def _uniform(keys: np.ndarray, stream: int, n: int) -> np.ndarray:
    """keys (F,) uint64 -> (F, n) uniforms in [0, 1)."""
    e = np.arange(1, n + 1, dtype=np.uint64)
    with np.errstate(over="ignore"):     # uint64 wraparound is the point
        h = _mix64(keys[:, None] + _G * np.uint64(stream)
                   + _M3 * e[None, :])
    return (h >> np.uint64(11)) * (1.0 / (1 << 53))


def _normal(keys: np.ndarray, stream: int, n: int) -> np.ndarray:
    """Box-Muller over two uniform streams -> (F, n) standard normals."""
    u1 = _uniform(keys, stream, n)
    u2 = _uniform(keys, stream + 1, n)
    return np.sqrt(-2.0 * np.log1p(-u1)) * np.cos(2.0 * np.pi * u2)


def _poisson(keys: np.ndarray, stream: int, lam: float,
             kmax: int = 16) -> np.ndarray:
    """Inverse-CDF Poisson(lam) -> (F,) ints in [0, kmax]."""
    u = _uniform(keys, stream, 1)[:, 0]
    k = np.arange(kmax + 1, dtype=float)
    pmf = np.exp(-lam) * np.cumprod(np.concatenate(
        [[1.0], lam / k[1:]]))
    cdf = np.cumsum(pmf)
    return np.minimum((u[:, None] >= cdf[None, :]).sum(-1), kmax)


_FP_MAX = 16   # Poisson tail cap (P(N>16) < 1e-7 at the rates in NOISE)


class ProxyDetector:
    def __init__(self, model: str, video_name: str, seed: int = 0):
        self.noise = NOISE[model]
        self.diff = DIFFICULTY.get(video_name, 1.0)
        self.model = model
        self.seed = seed
        # crc32, not hash(): string hashing is randomized per process
        # (PYTHONHASHSEED), which made mAP values — and the paper-band
        # tests — flap from run to run
        self._base = (crc32(f"{model}/{seed}".encode()) & 0xFFFF) * 100003
        self._memo: Dict[int, Detections] = {}
        self._memo_video: SyntheticVideo | None = None

    def detect(self, video: SyntheticVideo, frame_idx: int) -> Detections:
        return self.detect_many(video, [frame_idx])[0]

    def detect_many(self, video: SyntheticVideo,
                    frame_idxs) -> List[Detections]:
        """Detections for many frames at once: the whole batch's noise is
        synthesized in one vectorized pass.  Detection is a pure function
        of (model, seed, video, frame): results are memoized so repeated
        evaluations (offline + paced runs, benchmark sweeps) pay the
        synthesis once per frame; the cache resets when a different video
        object comes through."""
        if video is not self._memo_video:
            self._memo = {}
            self._memo_video = video
        missing = sorted({int(i) for i in frame_idxs} - self._memo.keys())
        if missing:
            self._synthesize(video, np.asarray(missing, np.int64))
        return [self._memo[int(i)] for i in frame_idxs]

    def _synthesize(self, video: SyntheticVideo, idx: np.ndarray):
        n = self.noise
        F, K = len(idx), len(video.classes)
        keys = _mix64(np.uint64(self._base) + idx.astype(np.uint64))
        gt = video.boxes_at_many(idx)                    # (F, K, 4)
        # difficulty scales misses/false-positives strongly but jitter only
        # mildly, so harder scenes lower the mAP plateau without putting
        # every match at the IoU-threshold cliff
        jit = 1.0 + 0.3 * (self.diff - 1.0)
        miss_diff = min(self.diff, n["max_miss_diff"])
        keep = _uniform(keys, 0, K) >= min(n["miss"] * miss_diff, 0.9)
        wh = gt[..., 2:] - gt[..., :2]
        center = (gt[..., :2] + gt[..., 2:]) / 2
        center = center + _normal(keys, 1, K * 2).reshape(F, K, 2) \
            * (n["c"] * jit) * wh
        wh = wh * np.exp(_normal(keys, 3, K * 2).reshape(F, K, 2)
                         * (n["s"] * jit))
        boxes = np.concatenate([center - wh / 2, center + wh / 2], -1)
        scores = 0.55 + _uniform(keys, 5, K) * (0.99 - 0.55)
        # false positives
        n_fp = _poisson(keys, 6, n["fp"] * self.diff, _FP_MAX)
        W, H = video.spec.width, video.spec.height
        fp_wh = np.stack(
            [(0.03 + _uniform(keys, 7, _FP_MAX) * 0.12) * W,
             (0.06 + _uniform(keys, 8, _FP_MAX) * 0.24) * H], -1)
        fp_c = np.stack([_uniform(keys, 9, _FP_MAX) * W,
                         _uniform(keys, 10, _FP_MAX) * H], -1)
        fp_boxes = np.concatenate([fp_c - fp_wh / 2, fp_c + fp_wh / 2], -1)
        fp_cls = (_uniform(keys, 11, _FP_MAX)
                  * video.N_CLASSES).astype(np.int64)
        fp_sc = 0.1 + _uniform(keys, 12, _FP_MAX) * (0.65 - 0.1)
        for f, i in enumerate(idx):
            k, m = keep[f], int(n_fp[f])
            self._memo[int(i)] = Detections(
                np.concatenate([boxes[f][k], fp_boxes[f][:m]], 0),
                np.concatenate([video.classes[k], fp_cls[f][:m]]),
                np.concatenate([scores[f][k], fp_sc[f][:m]]))


class _IdentityFrameOf:
    """rid -> (stream 0, frame rid): the single-stream ``frame_of``
    mapping without materializing a dict."""

    def __getitem__(self, rid):
        return (0, int(rid))


def proxy_detect_fn(video: SyntheticVideo, detector: ProxyDetector,
                    max_out: int = 24):
    """Bridge a ProxyDetector into ``serving.DetectionEngine``'s
    ``detect_fn`` interface: an ``(images, rids) -> (boxes, scores,
    classes, valid)`` callable that looks detections up by frame id
    (rid) instead of running the mini-SSD — the oracle detector the
    engine tests and ``benchmarks/tracking_bench.py`` share.  The
    single-stream special case of ``proxy_detect_fn_streams`` (rid ==
    frame index, one camera)."""
    return proxy_detect_fn_streams({0: video}, {0: detector},
                                   _IdentityFrameOf(), max_out)


def proxy_detect_fn_streams(videos: Dict[int, SyntheticVideo],
                            detectors: Dict[int, ProxyDetector],
                            frame_of: Dict[int, tuple],
                            max_out: int = 24):
    """Multi-camera oracle for ``DetectionEngine.detect_fn``: ``rid`` is
    globally unique across cameras, so ``frame_of`` maps it back to
    ``(stream_id, per-stream frame index)`` and each camera's proxy
    detector answers for its own video.  Batches are grouped per
    detector so every model still pays one vectorized noise-synthesis
    call per micro-batch."""
    def detect(images, rids):
        B = len(images)
        per_det: Dict[int, List[int]] = {}
        for rid in rids:
            if rid < 0:
                continue
            sid, k = frame_of[rid]
            per_det.setdefault(sid, []).append(k)
        for sid, ks in per_det.items():
            detectors[sid].detect_many(videos[sid], ks)
        boxes = np.zeros((B, max_out, 4), np.float32)
        scores = np.zeros((B, max_out), np.float32)
        classes = np.zeros((B, max_out), np.int32)
        valid = np.zeros((B, max_out), bool)
        for i, rid in enumerate(rids):
            if rid < 0:                     # batch padding row
                continue
            sid, k = frame_of[rid]
            d = detectors[sid].detect(videos[sid], k)
            n = min(len(d.boxes), max_out)
            boxes[i, :n] = d.boxes[:n]
            scores[i, :n] = d.scores[:n]
            classes[i, :n] = d.classes[:n]
            valid[i, :n] = True
        return boxes, scores, classes, valid
    return detect


@dataclass
class _TrackedView:
    """Minimal per-frame view for ``track_quality`` over engine
    responses (index/boxes/track_ids triple)."""
    index: int
    boxes: np.ndarray
    track_ids: np.ndarray


def evaluate_streams(videos, streams: Dict[int, Sequence],
                     n_frames: int, iou_thr: float = 0.5) -> Dict:
    """Per-stream quality aggregation for multi-camera serving: each
    camera's responses (the engine report's ``streams`` entry, ordered
    by per-stream ``seq``) are scored independently against that
    camera's video — mAP over the camera's arrival-frame sequence
    (``evaluate_map_dets``; frames with no response still count in the
    recall denominator) and tracker-identity counters
    (``track_quality``) — plus cross-stream aggregates.

    ``videos`` is either one ``SyntheticVideo`` shared by every camera
    or a ``{stream_id: video}`` dict; EdgeNet-style accounting: compute
    is shared, accuracy stays per-stream.

    Sharded serving needs no variant of this function: streams are
    disjoint across shards, so the ``streams`` key of a merged
    ``ShardedDetectionEngine`` report scores identically to the
    per-shard reports scored separately — per-stream quality is
    invariant to WHICH shard served a camera."""
    per: Dict[int, Dict[str, float]] = {}
    for sid, resp in streams.items():
        video = videos[sid] if isinstance(videos, dict) else videos
        dets: List = [None] * n_frames
        tracked: List[_TrackedView] = []
        for r in resp:
            if not 0 <= r.seq < n_frames:
                raise ValueError(
                    f"stream {sid}: response rid={r.rid} has "
                    f"seq={r.seq} outside [0, {n_frames}) — only "
                    "engine-produced streams (DetectionEngine sets "
                    "seq) or responses with seq set explicitly can "
                    "be scored")
            v = np.asarray(r.valid, bool)
            d = Detections(np.asarray(r.boxes)[v],
                           np.asarray(r.classes)[v],
                           np.asarray(r.scores)[v])
            dets[r.seq] = d
            tids = (np.asarray(r.track_ids)[v]
                    if r.track_ids is not None
                    else np.full(int(v.sum()), -1, np.int64))
            tracked.append(_TrackedView(r.seq, d.boxes, tids))
        tq = track_quality(video, tracked, iou_thr)
        per[sid] = {"map": evaluate_map_dets(video, dets, iou_thr), **tq}
    maps = [v["map"] for v in per.values()]
    covs = [v["coverage"] for v in per.values()]
    return {
        "per_stream": per,
        "map_mean": float(np.mean(maps)) if maps else 0.0,
        "map_min": float(np.min(maps)) if maps else 0.0,
        "coverage_mean": float(np.mean(covs)) if covs else 0.0,
        "id_switches_total": float(sum(v["id_switches"]
                                       for v in per.values())),
    }


def responses_to_detections(responses, n_frames: int) -> List:
    """Engine responses -> the per-arrival-frame ``Detections`` list
    ``evaluate_map_dets`` scores (None for frames with no response)."""
    per: List = [None] * n_frames
    for r in responses:
        v = np.asarray(r.valid, bool)
        per[r.rid] = Detections(np.asarray(r.boxes)[v],
                                np.asarray(r.classes)[v],
                                np.asarray(r.scores)[v])
    return per


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N,4) x (M,4) xyxy -> (N,M) IoU.  (The Pallas kernel in
    repro/kernels/iou.py implements this tiled for TPU.)"""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)))
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), -1)
    area_a = np.prod(a[:, 2:] - a[:, :2], -1)
    area_b = np.prod(b[:, 2:] - b[:, :2], -1)
    return inter / np.maximum(area_a[:, None] + area_b[None] - inter, 1e-9)


def average_precision(tp: np.ndarray, scores: np.ndarray,
                      n_gt: int) -> float:
    if n_gt == 0 or len(tp) == 0:
        return 0.0
    order = np.argsort(-scores)
    tp = tp[order]
    cum_tp = np.cumsum(tp)
    recall = cum_tp / n_gt
    precision = cum_tp / (np.arange(len(tp)) + 1)
    # all-point interpolation (running max from the right, vectorized)
    mrec = np.concatenate([[0.0], recall, [1.0]])
    mpre = np.concatenate([[1.0], precision, [0.0]])
    mpre = np.maximum.accumulate(mpre[::-1])[::-1]
    idx = np.where(mrec[1:] != mrec[:-1])[0]
    return float(np.sum((mrec[idx + 1] - mrec[idx]) * mpre[idx + 1]))


def _batched_iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a (F, D, 4) x b (F, K, 4) -> (F, D, K) IoU."""
    tl = np.maximum(a[:, :, None, :2], b[:, None, :, :2])
    br = np.minimum(a[:, :, None, 2:], b[:, None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), -1)
    aa = np.prod(a[:, :, 2:] - a[:, :, :2], -1)
    ab = np.prod(b[:, :, 2:] - b[:, :, :2], -1)
    return inter / np.maximum(aa[:, :, None] + ab[:, None, :] - inter, 1e-9)


def _batched_greedy_tp(fb: np.ndarray, fs: np.ndarray, gt: np.ndarray,
                       iou_thr: float):
    """Batched greedy matcher: fb (F, Dmax, 4) score-sorted padded
    detection boxes, fs (F, Dmax) scores (-inf padding), gt (F, K, 4)
    -> (tp (F, Dmax) float, real (F, Dmax) bool).

    The seed walked detections in score order and matched each against
    the *single* best-IoU ground-truth box (a second-best box never
    rescues a detection whose best box is taken), so the match rule is
    separable: a detection is TP iff its best-IoU box clears the
    threshold AND no earlier (higher-score) detection in the same frame
    claimed the same box — one argmax plus a triangular first-claim
    mask, batched over frames."""
    d_max = fb.shape[1]
    real = np.isfinite(fs)
    ious = _batched_iou(fb, gt)                        # (F, Dmax, K)
    jb = np.argmax(ious, -1)                           # best gt per det
    best = np.take_along_axis(ious, jb[..., None], -1)[..., 0]
    ok = (best >= iou_thr) & real
    # first claim wins: det i is blocked if an earlier (higher-score)
    # qualified det j < i targets the same gt box
    same = jb[:, :, None] == jb[:, None, :]            # (F, i, j)
    earlier = np.tril(np.ones((d_max, d_max), bool), -1)
    blocked = np.any(same & ok[:, None, :] & earlier[None], -1)
    tp = (ok & ~blocked).astype(float)
    return tp, real


def evaluate_map(video: SyntheticVideo, synced: Sequence[SyncedFrame],
                 detector: ProxyDetector, iou_thr: float = 0.5,
                 det_by_frame: Dict[int, ProxyDetector] | None = None
                 ) -> float:
    """Vectorized mAP over all frames of the output stream (identical
    result to ``evaluate_map_loop``, the seed implementation kept below
    as the oracle): processed frames score their own detections; dropped
    frames score the stale reused detections against the *current*
    frame's ground truth.  ``det_by_frame`` scores each processed frame
    with the model that ran it (heterogeneous-model deployments).

    Vectorization: detections per unique source frame are synthesized and
    class-partitioned once (one batched sampler call per detector);
    ground truth for every output frame comes from one batched
    ``boxes_at_many`` call; and the per-frame/per-class Python greedy-
    matching loops collapse into ONE batched matcher per class over all
    frames at once (``_batched_greedy_tp``).
    """
    C = video.N_CLASSES
    gt_cls = video.classes
    cls_masks = [gt_cls == c for c in range(C)]
    n_gt = {c: len(synced) * int(np.sum(m))
            for c, m in enumerate(cls_masks)}

    # detections per unique source frame, class-partitioned + score-sorted
    # once (the same (D, 4) arrays serve every output frame that reuses
    # this source, stale or fresh); sources are batched per detector so
    # each model pays one vectorized noise-synthesis call
    scored = [sf for sf in synced if sf.source_index >= 0]
    by_det: Dict[int, tuple] = {}
    for sf in scored:
        det = (det_by_frame or {}).get(sf.source_index, detector)
        by_det.setdefault(id(det), (det, set()))[1].add(sf.source_index)
    for det, idxs in by_det.values():
        det.detect_many(video, sorted(idxs))

    det_cache: Dict[int, List[tuple]] = {}
    sources = []
    for sf in scored:
        if sf.source_index in det_cache:
            continue
        det = (det_by_frame or {}).get(sf.source_index, detector)
        d = det.detect(video, sf.source_index)
        by_class = []
        for c in range(C):
            db = d.boxes[d.classes == c]
            ds = d.scores[d.classes == c]
            order = np.argsort(-ds)
            by_class.append((db[order], ds[order]))
        det_cache[sf.source_index] = by_class
        sources.append(sf.source_index)
    src_row = {s: i for i, s in enumerate(sources)}
    frame_src = np.array([src_row[sf.source_index] for sf in scored])

    all_gt = video.boxes_at_many(np.array([sf.index for sf in scored],
                                          np.int64))   # (F, K, 4)

    aps = []
    for c in range(C):
        if n_gt[c] == 0:
            continue
        K = int(np.sum(cls_masks[c]))
        per_src = [det_cache[s][c] for s in sources]
        d_max = max((len(db) for db, _ in per_src), default=0)
        if d_max == 0 or K == 0:
            aps.append(average_precision(np.zeros(0), np.zeros(0),
                                         n_gt[c]))
            continue
        # pad per-source detections to (S, Dmax)
        S = len(per_src)
        sb = np.zeros((S, d_max, 4))
        ss = np.full((S, d_max), -np.inf)
        for i, (db, ds) in enumerate(per_src):
            sb[i, :len(db)] = db
            ss[i, :len(ds)] = ds
        fb = sb[frame_src]                     # (F, Dmax, 4)
        fs = ss[frame_src]                     # (F, Dmax)
        tp, real = _batched_greedy_tp(fb, fs, all_gt[:, cls_masks[c]],
                                      iou_thr)
        aps.append(average_precision(tp[real], fs[real], n_gt[c]))
    return float(np.mean(aps)) if aps else 0.0


def evaluate_map_dets(video: SyntheticVideo, dets: Sequence,
                      iou_thr: float = 0.5) -> float:
    """mAP over an output stream whose per-frame detections are given
    explicitly — the tracked stream (fresh detections on processed
    frames, tracker-predicted boxes on interpolated ones).

    ``dets[f]`` covers arrival frame f: any object with ``boxes`` /
    ``classes`` / ``scores`` attributes (``Detections``,
    ``tracking.TrackedFrame``) or None for a frame with no output
    (which still contributes its ground truth to the recall
    denominator, exactly like ``evaluate_map``).

    Empty inputs are explicit, not incidental: a zero-frame ``dets``
    returns 0.0 (there is nothing to score — previously this raised
    ``ValueError`` from ``max()`` over an empty per-frame partition),
    and an all-``None``/all-empty stream scores 0.0 through the normal
    zero-detection AP path."""
    C = video.N_CLASSES
    F = len(dets)
    if F == 0:
        return 0.0
    cls_masks = [video.classes == c for c in range(C)]
    n_gt = {c: F * int(np.sum(m)) for c, m in enumerate(cls_masks)}
    all_gt = video.boxes_at_many(np.arange(F, dtype=np.int64))

    # partition each frame once (score-sorted per class), not per class
    empty = (np.zeros((0, 4)), np.zeros(0))
    by_class = [[empty] * F for _ in range(C)]
    for f, d in enumerate(dets):
        if d is None or len(d.boxes) == 0:
            continue
        db = np.asarray(d.boxes)
        ds = np.asarray(d.scores)
        dc = np.asarray(d.classes)
        order = np.argsort(-ds)
        db, ds, dc = db[order], ds[order], dc[order]
        for c in range(C):
            m = dc == c
            if m.any():
                by_class[c][f] = (db[m], ds[m])

    aps = []
    for c in range(C):
        if n_gt[c] == 0:
            continue
        per_frame = by_class[c]
        d_max = max(len(db) for db, _ in per_frame)
        if d_max == 0:
            aps.append(average_precision(np.zeros(0), np.zeros(0),
                                         n_gt[c]))
            continue
        fb = np.zeros((F, d_max, 4))
        fs = np.full((F, d_max), -np.inf)
        for i, (db, ds) in enumerate(per_frame):
            fb[i, :len(db)] = db
            fs[i, :len(ds)] = ds
        tp, real = _batched_greedy_tp(fb, fs, all_gt[:, cls_masks[c]],
                                      iou_thr)
        aps.append(average_precision(tp[real], fs[real], n_gt[c]))
    return float(np.mean(aps)) if aps else 0.0


def track_quality(video: SyntheticVideo, tracked: Sequence,
                  iou_thr: float = 0.5) -> Dict[str, float]:
    """Tracker-identity counters over a tracked output stream
    (``tracking.fill_stream`` output, or anything with per-frame
    ``index`` / ``boxes`` / ``track_ids``):

    * ``id_switches``  — times a ground-truth object's matched track id
      changed (both ids real; standard MOTA-style accounting against
      the last known id).
    * ``coverage``     — fraction of object-frames covered by an
      emitted box at ``iou_thr``.
    * ``fragments``    — covered -> uncovered transitions while the
      object remains in frame (track continuity).

    An empty ``tracked`` stream returns the explicit all-zero schema
    (coverage 0.0, no switches, no fragments) so zero-frame reports
    carry the same keys as populated ones.
    """
    if not len(tracked):
        return {"id_switches": 0.0, "coverage": 0.0, "fragments": 0.0}
    last_id: Dict[int, int] = {}
    prev_cov: Dict[int, bool] = {}
    switches = frags = covered = total = 0
    for tf in tracked:
        gt = video.boxes_at(tf.index)
        total += len(gt)
        boxes = np.asarray(tf.boxes, float).reshape(-1, 4)
        tids = np.asarray(tf.track_ids, np.int64).reshape(-1)
        matched_obj: Dict[int, int] = {}
        if len(boxes):
            iou = iou_matrix(gt, boxes)
            order = np.argsort(-iou, axis=None)
            used_t = set()
            for flat in order:
                o, t = divmod(int(flat), len(boxes))
                if iou[o, t] < iou_thr:
                    break
                if o in matched_obj or t in used_t:
                    continue
                matched_obj[o] = int(tids[t])
                used_t.add(t)
        for o in range(len(gt)):
            cov = o in matched_obj
            covered += cov
            if cov:
                tid = matched_obj[o]
                if tid >= 0:
                    if o in last_id and last_id[o] != tid:
                        switches += 1
                    last_id[o] = tid
            elif prev_cov.get(o, False):
                frags += 1
            prev_cov[o] = cov
    return {"id_switches": float(switches),
            "coverage": covered / max(total, 1),
            "fragments": float(frags)}


def evaluate_map_loop(video: SyntheticVideo, synced: Sequence[SyncedFrame],
                      detector: ProxyDetector, iou_thr: float = 0.5,
                      det_by_frame: Dict[int, ProxyDetector] | None = None
                      ) -> float:
    """The seed's per-frame/per-class/per-detection Python-loop mAP —
    kept verbatim as the oracle for ``evaluate_map`` (tests assert
    equality; ``benchmarks/nms_bench.py`` times the two against each
    other)."""
    det_cache: Dict[int, Detections] = {}
    per_class_tp: Dict[int, List[float]] = {c: [] for c in
                                            range(video.N_CLASSES)}
    per_class_scores: Dict[int, List[float]] = {c: [] for c in
                                                range(video.N_CLASSES)}
    n_gt = {c: 0 for c in range(video.N_CLASSES)}

    for sf in synced:
        gt_boxes = video.boxes_at(sf.index)
        gt_cls = video.classes
        for c in range(video.N_CLASSES):
            n_gt[c] += int(np.sum(gt_cls == c))
        if sf.source_index < 0:
            continue
        if sf.source_index not in det_cache:
            det = (det_by_frame or {}).get(sf.source_index, detector)
            det_cache[sf.source_index] = det.detect(video, sf.source_index)
        det = det_cache[sf.source_index]
        for c in range(video.N_CLASSES):
            db = det.boxes[det.classes == c]
            ds = det.scores[det.classes == c]
            gb = gt_boxes[gt_cls == c]
            if len(db) == 0:
                continue
            order = np.argsort(-ds)
            ious = iou_matrix(db[order], gb)
            matched = np.zeros(len(gb), bool)
            for i in range(len(db)):
                j = int(np.argmax(ious[i])) if len(gb) else -1
                if j >= 0 and ious[i, j] >= iou_thr and not matched[j]:
                    matched[j] = True
                    per_class_tp[c].append(1.0)
                else:
                    per_class_tp[c].append(0.0)
                per_class_scores[c].append(float(ds[order][i]))

    aps = []
    for c in range(video.N_CLASSES):
        if n_gt[c] == 0:
            continue
        aps.append(average_precision(np.array(per_class_tp[c]),
                                     np.array(per_class_scores[c]),
                                     n_gt[c]))
    return float(np.mean(aps)) if aps else 0.0
