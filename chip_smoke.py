"""Smoke run of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases, in order; any failure exits non-zero and prints no result:

1. build the CUDA kernels of ``src/repro_torch/kernels/csrc`` with nvcc
   for sm_90a into ``build/kernels`` (one nvcc per source, in parallel);
2. hold each kernel against its plain PyTorch version on the card, at
   the serving path's shapes and at edge cases: ``keep``/``valid`` and
   ``match`` must be exactly equal (tolerance 0).  Times the kernel, its
   plain version, and works out the least time the card could take;
3. serve an NVR trace (4 cameras x 32 frames of ``SyntheticVideo``
   pixels) through ``repro_torch``'s ``DetectionEngine(
   track_and_interpolate=True)`` on ``cuda`` with the real mini-SSD
   (random weights from a seed): coverage must be 1.0 and both kernels'
   launch counters, zeroed just before the serve, must be > 0;
4. check the served path against the CPU: the same engine on
   ``device="cpu"`` (plain versions) over a short trace with a pinned
   service time must give the same schedule, detections and track ids.

``--profile`` adds one more serve under ``torch.profiler`` and prints
the device time by kernel and the device's busy share.

The second-to-last line is a JSON object with one entry per kernel; the
card's name and power limit are printed before it; the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import proxy_detect_fn_streams  # noqa: E402
from repro_torch.core.stream import BENCHMARK_VIDEOS, SyntheticVideo  # noqa: E402,E501
from repro_torch.detector import (SSDConfig, init_ssd, make_anchors,  # noqa: E402,E501
                                  ssd_candidates)
from repro_torch.kernels import build, ops  # noqa: E402
from repro_torch.obs import TraceRecorder  # noqa: E402
from repro_torch.kernels import association as kassoc  # noqa: E402
from repro_torch.kernels import nms as knms  # noqa: E402
from repro_torch.serving import (DetectionEngine, FrameRequest,  # noqa: E402
                                 make_nvr_streams)

HBM_BYTES_PER_S = 3.35e12       # H100 SXM HBM3 (data sheet)
FP32_OPS_PER_S = 67e12          # H100 SXM fp32 outside the tensor cores
SEED = 0
DEV = "cuda"
# the engine's shapes on the serving path
NMS_KW = dict(iou_thr=0.5, score_thr=0.4, max_out=32, stop_at_zero=True)
ASSIGN_THR = 0.3
RATE_FPS = 30.0                 # per camera
SERVICE_S = 0.025               # per frame and replica: 80 of 120 frames/s
IOU_FLOPS = 15                  # 4 min/max, 3 sub, 2 clamp, 2 mul, add+sub, div


class SmokeFailure(RuntimeError):
    pass


def check(cond, what):
    if not cond:
        raise SmokeFailure(what)


def cuda_ms(fn, iters=200, warmup=20):
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


# ------------------------------------------------------------- inputs
def nvr_frames(n_cams, n_frames, rate):
    """``make_nvr_streams`` arrivals with real pixels: camera s renders
    benchmark video s (mod the catalogue) at its own frame index."""
    frames, frame_of, videos, dets = make_nvr_streams(n_cams, n_frames,
                                                      rate)
    vids = [SyntheticVideo(v) for v in BENCHMARK_VIDEOS.values()]
    out = []
    for f in frames:
        s, k = frame_of[f.rid]
        out.append(FrameRequest(f.rid, vids[s % len(vids)].pixels(k),
                                f.t_arrival, stream_id=s))
    return out, frame_of, videos, dets


def random_boxes(rng, shape, span=1.0, max_wh=0.3):
    xy = rng.uniform(0, span, shape + (2,))
    wh = rng.uniform(0, max_wh * span, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def nms_cases(rng, ssd_boxes, ssd_scores):
    """(name, boxes, scores, kwargs) on the card."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    cases = []
    for B in (1, 2, 4, 8):
        cases.append((f"ssd B={B} A=160", ssd_boxes[:B], ssd_scores[:B],
                      NMS_KW))
    b = random_boxes(rng, (8, 200))
    s = rng.uniform(0, 1, (8, 200)).astype(np.float32)
    s[:, 1::3] = s[:, ::3][:, :s[:, 1::3].shape[1]]          # score ties
    b[:, ::7, 2:] = b[:, ::7, :2]                            # zero area
    cases.append(("random A=200 ties zero-area", t(b), t(s), NMS_KW))
    cases.append(("random A=200 no thr", t(b), t(s),
                  dict(NMS_KW, score_thr=None, stop_at_zero=False)))
    cases.append(("random A=200 max_out=5", t(b), t(s),
                  dict(NMS_KW, max_out=5)))
    s2 = rng.uniform(0, 0.45, (3, 7)).astype(np.float32)
    cases.append(("random A=7", t(random_boxes(rng, (3, 7))), t(s2),
                  NMS_KW))
    # positives and zero scores in one tile: the tile is processed whole
    s3 = np.where(rng.uniform(size=(4, 160)) < 0.1,
                  rng.uniform(0.4, 1, (4, 160)), 0.1).astype(np.float32)
    cases.append(("mixed tile", t(random_boxes(rng, (4, 160), max_wh=.1)),
                  t(s3), NMS_KW))
    dense = random_boxes(rng, (2, 160), max_wh=0.9)
    cases.append(("dense overlap", t(dense),
                  t(rng.uniform(0.4, 1, (2, 160)).astype(np.float32)),
                  dict(NMS_KW, iou_thr=0.7)))
    return cases


def assign_cases(rng):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEV)  # noqa: E731
    cases = []
    for name, B, T, D, p_t, p_d in (("engine B=4 T=64 D=32", 4, 64, 32,
                                     0.5, 0.8),
                                    ("T=13 D=11", 3, 13, 11, 0.8, 0.8),
                                    ("T<D", 2, 5, 40, 1.0, 0.7),
                                    ("all masked", 2, 64, 32, 0.0, 1.0)):
        tb = random_boxes(rng, (B, T), span=100.0, max_wh=0.4)
        db = tb[:, rng.integers(0, T, D)] + rng.normal(
            0, 3, (B, D, 4)).astype(np.float32)
        db[:, D // 2:D // 2 + 2] = db[:, :2]                   # ties
        tm = rng.uniform(size=(B, T)) < p_t
        dm = rng.uniform(size=(B, D)) < p_d
        tc = rng.integers(0, 3, (B, T)).astype(np.int32)
        dc = rng.integers(0, 3, (B, D)).astype(np.int32)
        cases.append((name, (t(tb), t(db), t(tm), t(dm), t(tc), t(dc))))
    return cases


# ------------------------------------------------------------- bounds
def nms_iou_count(boxes, scores, iou_thr, score_thr, max_out,
                  stop_at_zero):
    """IoUs greedy NMS needs on these inputs: each survivor against the
    later candidates still alive when it is kept, over the tiles a frame
    enters (host replay of the greedy loop)."""
    boxes = boxes.cpu().numpy().astype(np.float64)
    s = scores.cpu().numpy().astype(np.float32)
    if score_thr is not None:
        s = np.where(s >= np.float32(score_thr), s, 0)
    n = 0
    for fb, fs in zip(boxes, s):
        order = np.argsort(-fs, kind="stable")
        bs, ss = fb[order], fs[order]
        A = len(ss)
        alive = np.ones(A, bool)
        found = 0
        for c0 in range(0, A, knms.TILE):
            if found >= max_out or (stop_at_zero and not ss[c0] > 0):
                break
            T = min(knms.TILE, A - c0)
            for i in range(c0, c0 + T):
                if not alive[i]:
                    continue
                found += 1
                n += int(alive[i + 1:].sum())
                rest = bs[i + 1:]
                ix = (np.clip(np.minimum(bs[i, 2], rest[:, 2]) -
                              np.maximum(bs[i, 0], rest[:, 0]), 0, None) *
                      np.clip(np.minimum(bs[i, 3], rest[:, 3]) -
                              np.maximum(bs[i, 1], rest[:, 1]), 0, None))
                ar = (rest[:, 2] - rest[:, 0]) * (rest[:, 3] - rest[:, 1])
                ai = (bs[i, 2] - bs[i, 0]) * (bs[i, 3] - bs[i, 1])
                iou = ix / np.maximum(ai + ar - ix, 1e-9)
                alive[i + 1:] &= ~(iou >= iou_thr)
    return n


def nms_bound_ms(boxes, scores, kw):
    B, A = scores.shape
    nbytes = B * A * (16 + 4) + B * kw["max_out"] * (4 + 1)
    ops_ = IOU_FLOPS * nms_iou_count(boxes, scores, **kw)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def assign_bound_ms(args, match):
    tb, db = args[0], args[1]
    B, T = tb.shape[:2]
    D = db.shape[1]
    nbytes = B * (T * 16 + D * 16 + T + D + 4 * T + 4 * D) + B * T * 4
    matches = (match >= 0).sum(-1).cpu().numpy()
    steps = np.minimum(matches + (matches < min(T, D)), min(T, D))
    ops_ = B * T * D * IOU_FLOPS + int(steps.sum()) * T * D
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops_ / FP32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ------------------------------------------------------------- phases
def phase_build():
    t0 = time.perf_counter()
    paths = build.build()
    print(f"[build] {len(paths)} kernel libraries in "
          f"{time.perf_counter() - t0:.1f} s: "
          + ", ".join(p.name for p in paths.values()))
    for name in paths:
        log = build.BUILD_DIR / f"{name}.log"
        if log.is_file():
            for line in log.read_text().splitlines():
                if "registers" in line or "spill" in line:
                    print(f"[build] {name}: {line.strip()}")


def check_counters(b, s, assign_args):
    """Each wrapper counts one launch where it launches its kernel and
    nothing where it launches none (an empty batch)."""
    ops.reset_launches()
    knms.batched_nms_cuda(b[:0], s[:0], **NMS_KW)
    kassoc.greedy_assign_cuda(*(a[:0] for a in assign_args),
                              iou_thr=ASSIGN_THR)
    check(ops.launches() == {"batched_nms": 0, "greedy_assign": 0},
          f"launch counted for an empty batch: {ops.launches()}")
    knms.batched_nms_cuda(b, s, **NMS_KW)
    kassoc.greedy_assign_cuda(*assign_args, iou_thr=ASSIGN_THR)
    check(ops.launches() == {"batched_nms": 1, "greedy_assign": 1},
          f"one launch each counted as {ops.launches()}")
    print("[counters] empty batch: no launch counted; one call: one each")


def phase_kernels(params, cfg, anchors, frames):
    rng = np.random.default_rng(SEED)
    imgs = torch.from_numpy(np.stack([f.image for f in frames[:8]])).to(DEV)
    ssd_b, ssd_s, _ = ssd_candidates(params, cfg, imgs, anchors)
    entries = {}

    # NMS: exact against the plain version on every case
    worst = 0
    for name, b, s, kw in nms_cases(rng, ssd_b, ssd_s):
        kk, vk = knms.batched_nms_cuda(b, s, **kw)
        kp, vp = knms.batched_nms_torch(b, s, **kw)
        torch.cuda.synchronize()
        err = max(int((kk - kp).abs().max()), int((vk != vp).sum()))
        print(f"[nms] {name}: keep/valid equal={err == 0} "
              f"valid={int(vk.sum())}")
        check(err == 0, f"batched_nms kernel != plain version on {name}")
        worst = max(worst, err)
    b, s = ssd_b[:8].contiguous(), ssd_s[:8].contiguous()
    ms = cuda_ms(lambda: knms.batched_nms_cuda(b, s, **NMS_KW))
    plain_ms = cuda_ms(lambda: knms.batched_nms_torch(b, s, **NMS_KW),
                       iters=20, warmup=3)
    bs, ss, order = knms._sorted_candidates(b, s, NMS_KW["score_thr"])
    bs, ss = bs.contiguous(), ss.contiguous()
    order = order.to(torch.int32).contiguous()
    keep = torch.empty((8, 32), dtype=torch.int32, device=DEV)
    count = torch.empty((8,), dtype=torch.int32, device=DEV)
    launch = build.function("nms", "batched_nms_launch", knms._LAUNCH_ARGS)
    stream = torch.cuda.current_stream().cuda_stream
    kernel_ms = cuda_ms(lambda: launch(
        bs.data_ptr(), ss.data_ptr(), order.data_ptr(), 8, 160, 32,
        0.5, 1, keep.data_ptr(), count.data_ptr(), stream))
    bound, by = nms_bound_ms(b, s, NMS_KW)
    entries["batched_nms"] = dict(
        name="batched_nms", route="cuda",
        source="src/repro_torch/kernels/csrc/nms.cu",
        replaces="src/repro/kernels/nms.py:166",
        max_abs_err=float(worst), ms=ms, kernel_only_ms=kernel_ms,
        plain_ms=plain_ms, bound_ms=bound, bound_by=by, library_ms=None,
        shape="B=8 A=160 max_out=32")
    print(f"[nms] B=8 A=160: wrapper {ms:.4f} ms (kernel alone "
          f"{kernel_ms:.4f} ms), plain {plain_ms:.4f} ms, bound "
          f"{bound:.2e} ms ({by})")
    for B in (1, 2, 4):                  # the engine's other buckets
        bb, sb = ssd_b[:B].contiguous(), ssd_s[:B].contiguous()
        t_k = cuda_ms(lambda: knms.batched_nms_cuda(bb, sb, **NMS_KW))
        t_p = cuda_ms(lambda: knms.batched_nms_torch(bb, sb, **NMS_KW),
                      iters=20, warmup=3)
        print(f"[nms-sweep] B={B} A=160: wrapper {t_k:.4f} ms, plain "
              f"{t_p:.4f} ms, bound {nms_bound_ms(bb, sb, NMS_KW)[0]:.2e} ms")

    # association: exact against the plain version on every case
    worst = 0
    eng_case = None
    for name, args in assign_cases(rng):
        mk = kassoc.greedy_assign_cuda(*args, iou_thr=ASSIGN_THR)
        mp = kassoc.greedy_assign_torch(*args, iou_thr=ASSIGN_THR)
        torch.cuda.synchronize()
        err = int((mk - mp).abs().max()) if mk.numel() else 0
        print(f"[assign] {name}: match equal={err == 0} "
              f"matches={int((mk >= 0).sum())}")
        check(err == 0, f"greedy_assign kernel != plain version on {name}")
        worst = max(worst, err)
        if eng_case is None:
            eng_case = (args, mk)
    args, mk = eng_case
    ms = cuda_ms(lambda: kassoc.greedy_assign_cuda(*args,
                                                   iou_thr=ASSIGN_THR))
    plain_ms = cuda_ms(lambda: kassoc.greedy_assign_torch(
        *args, iou_thr=ASSIGN_THR), iters=20, warmup=3)
    bound, by = assign_bound_ms(args, mk)
    entries["greedy_assign"] = dict(
        name="greedy_assign", route="cuda",
        source="src/repro_torch/kernels/csrc/association.cu",
        replaces="src/repro/kernels/association.py:103",
        max_abs_err=float(worst), ms=ms, plain_ms=plain_ms,
        bound_ms=bound, bound_by=by, library_ms=None,
        shape="B=4 T=64 D=32")
    print(f"[assign] B=4 T=64 D=32: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, bound {bound:.2e} ms ({by})")
    for B in (1, 8):                     # one camera / eight cameras
        sub = tuple(a[:1] if B == 1 else torch.cat([a, a]) for a in args)
        t_k = cuda_ms(lambda: kassoc.greedy_assign_cuda(
            *sub, iou_thr=ASSIGN_THR))
        t_p = cuda_ms(lambda: kassoc.greedy_assign_torch(
            *sub, iou_thr=ASSIGN_THR), iters=20, warmup=3)
        print(f"[assign-sweep] B={B} T=64 D=32: kernel {t_k:.4f} ms, "
              f"plain {t_p:.4f} ms")
    check_counters(b, s, args)
    return entries


def phase_serve(params, cfg, frames):
    # a pinned service time below the arrival rate: the paper's drop
    # regime, so the tracker both associates and interpolates
    rec = TraceRecorder()
    eng = DetectionEngine(cfg=cfg, params=params, n_replicas=2,
                          service_time=SERVICE_S, recorder=rec,
                          track_and_interpolate=True, device=DEV)
    eng.warmup()
    ops.reset_launches()
    t0 = time.perf_counter()
    rep = eng.serve(frames)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launches()
    n = len(frames)
    n_interp = rep["interpolated"]
    print(f"[serve] {n} frames ({rep['n_streams']} cameras): coverage "
          f"{rep['coverage']}, detected {n - n_interp}, interpolated "
          f"{n_interp}, tracker ticks {rep['tracker_ticks']}, wall "
          f"{wall:.3f} s ({n / wall:.1f} frames/s)")
    print(f"[serve] launches: {launches}; mean micro-batch "
          f"{(n - n_interp) / max(launches['batched_nms'], 1):.2f} frames")
    det_ms = [v for _, v in rec.series.get("stage_ms_detect/0", [])]
    trk_ms = [v for _, v in rec.series.get("stage_ms_track/0", [])]
    print(f"[serve] host wall: detect {sum(det_ms):.2f} ms over "
          f"{len(det_ms)} micro-batches (median "
          f"{float(np.median(det_ms)) if det_ms else 0.0:.3f} ms), tracker "
          f"{sum(trk_ms):.2f} ms over {rep['tracker_ticks']} ticks")
    check(rep["coverage"] == 1.0, "NVR serve coverage != 1.0")
    check(len(rep["responses"]) == n, "a frame got no response")
    for r in rep["responses"]:
        rows = eng.tracker_cfg.capacity if r.interpolated else 32
        check(r.boxes.shape == (rows, 4) and np.isfinite(r.boxes).all()
              and np.isfinite(r.scores).all(), f"bad response {r.rid}")
    check(launches["batched_nms"] > 0, "NMS kernel never launched")
    check(launches["greedy_assign"] > 0, "assign kernel never launched")
    return launches, n, wall


def phase_profile(params, cfg, frames):
    """One more serve under ``torch.profiler``: device time by kernel
    and the device's busy share of the serve's wall time."""
    from torch.profiler import ProfilerActivity, profile
    eng = DetectionEngine(cfg=cfg, params=params, n_replicas=2,
                          service_time=SERVICE_S,
                          track_and_interpolate=True, device=DEV)
    eng.warmup()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.serve(frames)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for e in prof.key_averages():
        # device-side events only: an aten op's row repeats the time of
        # the kernels it launched
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        dev_us = getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
        if dev_us > 0:
            rows.append((dev_us, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows) / 1e3
    print(f"[profile] serve wall {wall_ms:.2f} ms (profiled), device "
          f"busy {busy_ms:.2f} ms = {busy_ms / wall_ms:.3f} of wall, "
          f"{sum(r[1] for r in rows)} device events")
    for dev_us, count, key in rows[:15]:
        print(f"[profile] {dev_us / 1e3:9.3f} ms {count:6d}x  {key[:90]}")


def assert_same_report(a, b, what):
    """Schedule, discrete fields and track ids equal; float fields of a
    response within 1e-4 (cuDNN vs CPU conv sums; ULPs in the tracker's
    Kalman arithmetic)."""
    check(set(a) == set(b), f"{what}: report keys differ")
    check(len(a["responses"]) == len(b["responses"]),
          f"{what}: response count")
    for ra, rb in zip(a["responses"], b["responses"]):
        for f in ("rid", "replica", "t_start", "t_done", "service_s",
                  "interpolated", "stream_id", "seq"):
            check(getattr(ra, f) == getattr(rb, f), f"{what}: {f}")
        for f in ("classes", "valid"):
            check(np.array_equal(getattr(ra, f), getattr(rb, f)),
                  f"{what}: rid {ra.rid} {f}")
        check(np.array_equal(ra.track_ids, rb.track_ids),
              f"{what}: rid {ra.rid} track_ids")
        for f in ("boxes", "scores"):
            check(np.allclose(getattr(ra, f), getattr(rb, f), rtol=0,
                              atol=1e-4), f"{what}: rid {ra.rid} {f}")


def phase_parity(params, cfg):
    # oracle detector: the schedule is pure Python, the tracker runs on
    # the card (association kernel) and on the CPU (plain version)
    frames, frame_of, videos, dets = make_nvr_streams(4, 24, rate=4.0)
    kw = dict(n_replicas=2, service_time=0.4, track_and_interpolate=True)
    reps = [DetectionEngine(detect_fn=proxy_detect_fn_streams(
                videos, dets, frame_of), device=d, **kw).serve(frames)
            for d in (DEV, "cpu")]
    assert_same_report(*reps, "oracle path cuda vs cpu")
    print(f"[parity] oracle NVR report, cuda == cpu: "
          f"{len(reps[0]['responses'])} responses, "
          f"{reps[0]['interpolated']} interpolated")
    # real mini-SSD + NMS kernel + tracker on a short trace
    frames, *_ = nvr_frames(2, 8, rate=8.0)
    kw = dict(cfg=cfg, n_replicas=2, micro_batch=4, service_time=0.05,
              track_and_interpolate=True)
    reps = [DetectionEngine(params=params, device=d, **kw).serve(frames)
            for d in (DEV, "cpu")]
    assert_same_report(*reps, "mini-SSD path cuda vs cpu")
    n_det = sum(int(r.valid.sum()) for r in reps[0]["responses"])
    print(f"[parity] mini-SSD NVR report, cuda == cpu: "
          f"{len(reps[0]['responses'])} responses, {n_det} detections")


def gpu_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print("TF32 off: torch.backends.cudnn.allow_tf32 = False, "
          "torch.backends.cuda.matmul.allow_tf32 = False")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]}")
    t_start = time.perf_counter()
    phase_build()
    cfg = SSDConfig()
    params = init_ssd(cfg, torch.Generator().manual_seed(SEED), device=DEV)
    anchors = torch.from_numpy(make_anchors(cfg)).to(DEV)
    frames, *_ = nvr_frames(4, 32, rate=RATE_FPS)
    entries = phase_kernels(params, cfg, anchors, frames)
    launches, n_frames, wall = phase_serve(params, cfg, frames)
    for k, e in entries.items():
        e["launches"] = launches[k]
        e["launches_per_frame"] = launches[k] / n_frames
    phase_parity(params, cfg)
    if "--profile" in sys.argv[1:]:
        phase_profile(params, cfg, frames)
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": list(entries.values())}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
