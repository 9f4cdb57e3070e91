"""The NVR cells: the program's ``DetectionEngine`` (a detector, the
replica pool that drops what arrives while every replica is busy, the
lockstep tracker filling dropped frames) behind its always-on
``ServingRuntime``, fed camera ticks closed-loop and cut into epochs.

The configuration's ``detector`` is either the program's mini-SSD
(``kind: ssd``: forward, decode and the NMS kernel on the device, weights
drawn from the seed) or proxy detections (``kind: proxy``, ``proxy.py``:
rows drawn from the seed and served through ``detect_fn``).

The window drives ``ingest``/``advance`` a tick at a time and
``epoch_boundary`` every ``epoch_ticks`` ticks.  ``frames_per_s`` is
every frame of the window's closed epochs over the window;
``epoch_latency_p95_ms`` the 95th percentile, over every epoch, of the
wall from the epoch's first ingest to the return of its boundary.

``correct`` holds the served frames to the plain references: the
detected frames to the reference detector (a sample drawn from the seed,
``reference.detector.judge_frame``) or, for proxy rows, each to its row
exactly; and every frame, detected or filled by the tracker, to the
reference tracker replayed over the window's ticks
(``reference.tracker``).  Where the pool drops frames, the share of
filled frames that carry no box is held under a limit too, so that a
fill that emits nothing cannot pass by agreeing with an empty replay.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness
from .. import traffic as traffic_mod
from ..proxy import ProxyDetections
from ..reference import detector as ref_det
from ..reference import tracker as ref_trk
from ..trace import DeviceTrace, Spans


# --------------------------------------------------------------- weights
def make_params(det: dict, weights: dict, seed: int, device):
    """The mini-SSD's weights in the program's layout, drawn on
    ``device`` from ``seed`` in one call: conv kernels (out, in, 3, 3)
    of standard normals over sqrt(fan-in), biases of
    ``weights["bias_std"]`` normals."""
    shapes = []
    c_in = 3
    for c in det["channels"]:
        shapes.append((c, c_in))
        c_in = c
    out = 2 * (5 + det["n_classes"])
    shapes += [(out, det["channels"][-2]), (out, det["channels"][-1])]
    n = sum(o * i * 9 + o for o, i in shapes)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.randn(n, generator=g, device=device, dtype=torch.float32)
    convs, at = [], 0
    for o, i in shapes:
        w = flat[at:at + o * i * 9].reshape(o, i, 3, 3) / np.sqrt(9 * i)
        at += o * i * 9
        b = flat[at:at + o] * weights["bias_std"]
        at += o
        convs.append({"w": w.contiguous(), "b": b.contiguous()})
    return {"backbone": convs[:-2], "head8": convs[-2],
            "head16": convs[-1]}


def make_source(config: dict, cams, seed: int, device):
    """What the detector serves from: the mini-SSD's weights, or the
    proxy detections of every pool frame."""
    det = config["detector"]
    if det.get("kind") == "proxy":
        return ProxyDetections(cams, det, seed,
                               config["deployment"]["max_out"])
    return make_params(det, config["weights"], seed, device)


def make_engine(config: dict, mix: dict, source, device):
    from repro_torch.serving import DetectionEngine
    from repro_torch.tracking import TrackerConfig
    det, dep = config["detector"], config["deployment"]
    eng = mix["engine"]
    if isinstance(source, ProxyDetections):
        model = dict(cfg=None, detect_fn=source.detect_fn())
    else:
        from repro_torch.detector import SSDConfig
        model = dict(cfg=SSDConfig(
            image_size=det["image_size"], n_classes=det["n_classes"],
            channels=tuple(det["channels"]),
            anchor_scales=tuple(det["anchor_scales"]),
            feature_strides=tuple(det["feature_strides"])), params=source,
            score_thr=dep["score_thr"], iou_thr=dep["iou_thr"])
    return DetectionEngine(
        **model, n_replicas=dep["n_replicas"],
        scheduler=dep["scheduler"], micro_batch=eng["micro_batch"],
        max_micro_batch=dep["max_micro_batch"],
        max_out=dep["max_out"], track_and_interpolate=True,
        tracker_cfg=TrackerConfig(**config["tracker"]), fused_tick=True,
        service_time=eng["service_time"], device=device)


# ------------------------------------------------------------------ feed
class Feed:
    """Closed-loop ticks of the mix into one runtime."""

    def __init__(self, cams, engine, mix):
        from repro_torch.serving import FrameRequest, ServingRuntime
        self.cams = cams
        self.fr = FrameRequest
        self.rt = ServingRuntime(engine, streams=range(cams.n))
        self.k = 0
        self.E = mix["epoch_ticks"]

    def epoch(self):
        """Ingest and advance ``epoch_ticks`` ticks, then close the
        epoch; returns its report."""
        fr, rt, cams = self.fr, self.rt, self.cams
        for _ in range(self.E):
            rt.ingest([fr(rid, img, t, stream_id=s)
                       for rid, s, t, img in cams.tick(self.k)])
            self.k += 1
            rt.advance(self.k / cams.fps)
        return rt.epoch_boundary()


def warm(engine, config, mix, cams):
    """Every shape the window uses: the detect at each micro-batch size
    the mix forms, then ``warmup_epochs`` epochs of the mix itself (the
    tracker's tick graph, the kernels, the runtime's paths)."""
    S = config["detector"]["image_size"]
    sizes = ([mix["engine"]["micro_batch"]] if mix["engine"]["micro_batch"]
             else [2 ** i for i in range(
                 config["deployment"]["max_micro_batch"].bit_length())])
    for b in sizes:
        engine._detect_batch(np.zeros((b, S, S, 3), np.float32),
                             rids=[-1] * b)
    feed = Feed(cams, engine, mix)
    for _ in range(mix["warmup_epochs"]):
        feed.epoch()


# ---------------------------------------------------------------- window
def run(ctx):
    config, mix, device = ctx.config, ctx.mix, ctx.device
    det = config["detector"]
    cams = traffic_mod.Cameras(mix, ctx.seed, det["image_size"])
    source = make_source(config, cams, ctx.seed, device)
    engine = make_engine(config, mix, source, device)
    warm(engine, config, mix, cams)
    spans = None
    if ctx.trace:
        spans = Spans(device)
        spans.wrap(engine, "_detect_batch", "bench.detect",
                   lambda a, kw, out: kw.get("rids"))
        spans.wrap(engine, "_interpolate", "bench.track",
                   lambda a, kw, out: engine._tracker_ticks)
    feed = Feed(cams, engine, mix)
    dtrace = DeviceTrace() if ctx.trace else None
    if device.type == "cuda":
        torch.cuda.synchronize()
    if dtrace:
        from repro_torch.kernels import ops
        launches0 = ops.launches()
        dtrace.start()
    t_open = ctx.open_window()
    reps, lat = [], []
    while True:
        t0 = time.perf_counter()
        reps.append(feed.epoch())
        t1 = time.perf_counter()
        lat.append(t1 - t0)
        if dtrace and dtrace.t1 is None and \
                t1 - t_open >= min(mix["trace_seconds"], ctx.seconds):
            dtrace.stop()
            launches = {k: v - launches0[k]
                        for k, v in ops.launches().items()}
        if t1 - t_open >= ctx.seconds:
            break
    window = t1 - t_open
    ctx.close_window()
    if spans:
        spans.unwrap()
    ctx.read_memory()
    n_frames = feed.k * cams.n
    served = sum(len(r["responses"]) for r in reps)
    out = {
        "attempted": n_frames,
        "failed": n_frames - served,
        "e2e": {"frames_per_s": harness.rate(served, window),
                "epoch_latency_p95_ms": harness.p95_ms(lat)},
        "counts": {"epochs": len(lat), "ticks": feed.k,
                   "detected": sum(sum(not x.interpolated
                                       for x in r["responses"])
                                   for r in reps)},
    }
    del feed, engine
    _free_program(device)
    responses = {x.rid: x for r in reps for x in r["responses"]}
    out["compared"] = compare(ctx, cams, source, responses, n_frames)
    if dtrace:
        out["trace"] = dtrace.read()
        # the program's own launch counters over the traced window, beside
        # the profiler's kernel records
        out["counts"]["launches_traced"] = launches
        out["spans"] = spans.between("bench.detect", dtrace.t0, dtrace.t1) \
            + spans.between("bench.track", dtrace.t0, dtrace.t1)
        if not isinstance(source, ProxyDetections):
            out["candidates"] = lambda rids: _candidates(
                config, cams, source, rids, device)
    return out


def _free_program(device):
    from repro_torch.serving.pipeline import clear_tick_graphs
    clear_tick_graphs()
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


# ----------------------------------------------------------- correctness
def _images(cams, rids, S):
    imgs = np.zeros((len(rids), S, S, 3), np.float32)
    for i, rid in enumerate(rids):
        if rid >= 0:
            imgs[i] = cams.image(*cams.frame_of(rid))
    return imgs


def _candidates(config, cams, params, rids, device, tf32=False,
                block=1024):
    """The reference's candidates for frames ``rids`` (-1: a blank
    padding frame), as numpy (boxes, scores, class logits)."""
    det = config["detector"]
    anc = torch.from_numpy(ref_det.anchors(det)).to(device)
    outs = []
    for i in range(0, len(rids), block):
        imgs = torch.from_numpy(_images(cams, rids[i:i + block],
                                        det["image_size"])).to(device)
        with torch.no_grad():
            outs.append([t.cpu().numpy() for t in ref_det.candidates(
                params, det, imgs, anc, tf32)])
    return [np.concatenate([o[j] for o in outs]) for j in range(3)]


def detection_sample(ctx, responses):
    det_rids = sorted(r for r, x in responses.items() if not x.interpolated)
    n = min(ctx.mix["sample_frames"], len(det_rids))
    rng = np.random.default_rng([ctx.seed, 3])
    return sorted(rng.choice(det_rids, n, replace=False).tolist())


def judge_detections(config, rows_of, cands, rids):
    dep = config["deployment"]
    err = gap = 0.0
    for i, rid in enumerate(rids):
        e, g = ref_det.judge_frame(
            rows_of(rid), (cands[0][i], cands[1][i], cands[2][i]),
            dep["score_thr"], dep["iou_thr"], dep["max_out"])
        err, gap = max(err, e), max(gap, g)
    return err, gap


def judge_tracker(config, n_cams, responses, n_frames, rows_of,
                  control=False):
    """Replay the reference tracker over every tick of the window, fed
    ``rows_of(rid)`` for each detected frame, and count the frames whose
    answer differs from it in any bit: a detected frame's track ids, a
    filled frame's emitted set and, on it, the boxes, scores, classes
    and track ids.  The reference repeats the tracker's float32
    operations in their order, so a sound program reads 0: an exact
    comparison.  ``control=True`` judges the reference tracker in
    bfloat16, put in the program's place, instead of the served answers.
    Also returns the share of the filled frames that carry no box (1.0
    where no frame was filled)."""
    trk = ref_trk.Tracker(n_cams, config["tracker"])
    ctl = ref_trk.Tracker(n_cams, config["tracker"], bf16=True) \
        if control else None
    D = config["deployment"]["max_out"]
    bad = filled = empty = 0
    rows = (np.zeros((n_cams, D, 4), np.float32),
            np.zeros((n_cams, D), np.float32),
            np.zeros((n_cams, D), np.int32), np.zeros((n_cams, D), bool))
    for k in range(n_frames // n_cams):
        got = [responses.get(k * n_cams + s) for s in range(n_cams)]
        for s, x in enumerate(got):
            live = x is not None and not x.interpolated
            det = rows_of(x.rid) if live else (0, 0, 0, False)
            for a, v in zip(rows, det):
                a[s] = v
        tid = trk.tick(*rows)
        have_tid = ctl.tick(*rows) if ctl else None
        want = have = None
        for s, x in enumerate(got):
            if x is None:
                bad += 1
                continue
            if not x.interpolated:
                ids = have_tid[s] if ctl else np.asarray(x.track_ids)
                bad += not np.array_equal(ids, tid[s])
                continue
            filled += 1
            empty += not np.asarray(x.valid).any()
            if want is None:
                want = trk.output()
                have = ctl.output() if ctl else None
            tb, ts, tc, ti, emit = (a[s] for a in want)
            if ctl:
                hb, hs, hc, hi, hv = (a[s] for a in have)
            else:
                hb, hs, hc, hi, hv = (np.asarray(a) for a in (
                    x.boxes, x.scores, x.classes, x.track_ids, x.valid))
            bad += not (np.array_equal(hv.astype(bool), emit)
                        and all(np.array_equal(g[emit], w[emit])
                                for g, w in ((hb, tb), (hs, ts), (hc, tc),
                                             (hi, ti))))
    return bad, (empty / filled if filled else 1.0)


def proxy_mismatch(proxy, responses):
    """Detected frames whose served rows differ in any bit from the proxy
    rows the detector was given: the engine passes them through."""
    bad = 0
    for rid, x in responses.items():
        if not x.interpolated:
            want = proxy.rows([rid])
            bad += not all(np.array_equal(np.asarray(g), w[0]) for g, w in
                           zip((x.boxes, x.scores, x.classes, x.valid),
                               want))
    return bad


def compare(ctx, cams, source, responses, n_frames):
    """The numbers compared, each with its limit."""
    config = ctx.config
    limits = config["limits"].get(ctx.cell["name"], {})
    if isinstance(source, ProxyDetections):
        got = {"det_mismatch": proxy_mismatch(source, responses)}
        rows_of = lambda rid: tuple(a[0] for a in source.rows([rid]))
    else:
        rids = detection_sample(ctx, responses)
        rows_of = lambda rid: (responses[rid].boxes, responses[rid].scores,
                               responses[rid].classes, responses[rid].valid)
        cands = _candidates(config, cams, source, rids, ctx.device)
        det_err, nms_gap = judge_detections(config, rows_of, cands, rids)
        got = {"det_err": det_err, "nms_gap": nms_gap}
    got["track_mismatch"], empty = judge_tracker(
        config, cams.n, responses, n_frames, rows_of)
    if "fill_empty_share" in limits:
        got["fill_empty_share"] = empty
    if ctx.control:
        if isinstance(source, ProxyDetections):
            got["control.track_mismatch"], _ = judge_tracker(
                config, cams.n, responses, n_frames, rows_of, control=True)
        else:
            got.update(control(ctx, cams, source, responses, rids))
    return {k: (v, limits.get(k)) for k, v in got.items()}


def control(ctx, cams, params, responses, rids):
    """The control's readings of the detection numbers: the reference
    put in the program's place, its convolutions in TF32."""
    config = ctx.config
    dep = config["deployment"]
    tf = _candidates(config, cams, params, rids, ctx.device, tf32=True)
    ctl = {rid: ref_det.nms(tf[0][i], tf[1][i],
                            tf[2][i].argmax(-1).astype(np.int32),
                            dep["score_thr"], dep["iou_thr"],
                            dep["max_out"])
           for i, rid in enumerate(rids)}
    cands = _candidates(config, cams, params, rids, ctx.device)
    err, gap = judge_detections(config, ctl.__getitem__, cands, rids)
    return {"control.det_err": err, "control.nms_gap": gap}
