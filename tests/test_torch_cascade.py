"""The port's transprecise cascade against the JAX package, on the CPU.

* The ROI crop's plain version equals every tier of the reference
  (XLA twin, Pallas kernel in interpret mode, numpy oracle) exactly,
  on the serving shapes and the edge cases ``chip_smoke.py`` also runs
  on the card.
* The uncrop's plain version equals the numpy oracle exactly and the
  reference's jitted tiers within one float32 ULP of the parent frame
  scale (they contract ``x0 + t * (x1 - x0)`` into an FMA).
* ``ModelSelector``, ``rois_from_boxes`` and ``roi_pixels`` replay the
  reference decision for decision.
* The oracle cascade serve (``make_cascade_detect_fn``) gives the
  reference's report key for key, the cascade block exact.
* A short mini-SSD cascade serve with the reference's weights gives the
  reference's schedule, models and discrete detections, and floats
  within the forward tolerance of slice 1.

The CUDA kernels are held against these plain versions on the card by
``chip_smoke.py``.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.detector import ssd as jssd
from repro.kernels import ref as jref
from repro.kernels.roi import (crop_resize_pallas, crop_resize_xla,
                               uncrop_boxes_pallas, uncrop_boxes_xla)
from repro.serving import DetectionEngine as JEngine
from repro.serving import FrameRequest as JFrame
from repro.serving import ModelCatalog as JCatalog
from repro.serving import ModelSelector as JSelector
from repro.serving import make_cascade_detect_fn as jcascade_fn
from repro.serving import paper_catalog as jpaper
from repro.serving import pipeline as jpipe
from repro.serving.cascade import roi_pixels as jroi_pixels
from repro.serving.cascade import rois_from_boxes as jrois_from_boxes
from repro_torch.core.stream import SyntheticVideo, VideoSpec
from repro_torch.detector import ssd as tssd
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.roi import crop_resize_torch, uncrop_boxes_torch
from repro_torch.obs import TraceRecorder
from repro_torch.serving import DetectionEngine as TEngine
from repro_torch.serving import FrameRequest as TFrame
from repro_torch.serving import ModelCatalog as TCatalog
from repro_torch.serving import ModelProfile as TProfile
from repro_torch.serving import ModelSelector as TSelector
from repro_torch.serving import make_cascade_detect_fn as tcascade_fn
from repro_torch.serving import make_nvr_streams as tstreams
from repro_torch.serving import paper_catalog as tpaper
from repro_torch.serving import pipeline as tpipe
from repro_torch.serving.cascade import roi_pixels as troi_pixels
from repro_torch.serving.cascade import rois_from_boxes as trois_from_boxes
from repro_torch.serving.models import cascade_report_keys
from test_cascade import fast_videos, trace_for
from test_torch_serving import _pixel_frames, assert_reports_match

FORWARD_ATOL = 1e-4      # slice 1's forward tolerance (conv sums, exp)


# ------------------------------------------------------------- crop
def _windows(rng, B, R, lo=0.0, hi=0.6, span=0.5):
    a = rng.uniform(lo, hi, (B, R, 2)).astype(np.float32)
    b = np.minimum(a + rng.uniform(0.05, span, (B, R, 2)), 1.0)
    return np.concatenate([a, b.astype(np.float32)], -1)


def _crop_case(name):
    """(images, rois, C) for one of the cases chip_smoke also runs."""
    rng = np.random.default_rng(CROP_CASES.index(name))
    B, H, W, ch, R, C = 8, 64, 64, 3, 4, 64     # the serving shapes
    if name == "downsample":
        C = 32
    elif name == "upsample":
        C = 96
    elif name == "non_square_gray":
        H, W, ch, B = 48, 80, 1, 3
    images = rng.random((B, H, W, ch)).astype(np.float32)
    rois = _windows(rng, B, R)
    if name == "zero_area":
        n_rois = rng.integers(0, R + 1, B)
        rois[np.arange(R)[None, :] >= n_rois[:, None]] = 0.0
    elif name == "frame_edge":
        rois[:, :, 2] = 1.0                    # x1 on the frame edge
        rois[:, 1::2, 3] = 1.0                 # y1 too, every other
        rois[0, 0] = [0.0, 0.0, 1.0, 1.0]      # the whole frame
    elif name == "upsample":
        rois = _windows(rng, B, R, span=0.2)    # small windows, C = 96
    return images, rois, C


CROP_CASES = ["serve", "zero_area", "frame_edge", "downsample", "upsample",
              "non_square_gray"]


@pytest.mark.parametrize("name", CROP_CASES)
def test_crop_plain_equals_every_reference_tier(name):
    images, rois, C = _crop_case(name)
    port = crop_resize_torch(torch.from_numpy(images),
                             torch.from_numpy(rois), out_size=C).numpy()
    B, H, W, ch = images.shape
    assert port.shape == (B, rois.shape[1], C, C, ch)
    assert port.dtype == np.float32
    for tier, out in (
            ("numpy oracle", jref.crop_resize_ref(images, rois, out_size=C)),
            ("XLA twin", crop_resize_xla(images, rois, out_size=C)),
            ("Pallas (interpret)", crop_resize_pallas(images, rois,
                                                      out_size=C)),
            ("port oracle", tref.crop_resize_ref(images, rois,
                                                 out_size=C).numpy())):
        np.testing.assert_array_equal(port, np.array(out),
                                      err_msg=f"{name}: {tier}")
    if name == "zero_area":          # a tile of the frame's pixel (0, 0)
        empty = ~(rois != 0).any(-1)
        assert empty.any()
        for b, r in zip(*np.nonzero(empty)):
            assert (port[b, r] == images[b, 0, 0]).all()


def _pixel_grid_case(S, w, seed=0):
    """Windows with edges on pixel boundaries of an S-pixel frame and
    C = w / 2: every source coordinate ``(a + 2i + 1) / S * S`` is an
    integer in exact arithmetic, so the floor decides on the last bit.
    Pixel (y, x) holds (y, x, 0), so a crop reads back its indices."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(S), np.arange(S), indexing="ij")
    img = np.stack([yy, xx, np.zeros_like(yy)], -1).astype(np.float32)
    a = rng.integers(0, S - w, (2, 4, 2))
    rois = (np.concatenate([a, a + w], -1) / np.float32(S)).astype(
        np.float32)
    return np.stack([img, img]), rois, w // 2


@pytest.mark.parametrize("S,w", [(60, 24), (57, 18), (100, 30)])
def test_crop_on_exact_pixel_boundaries_follows_the_oracle(S, w):
    """Where the source coordinate is an exact integer, rounding decides
    the pixel.  The port rounds after every operation, as the numpy
    oracle does, and equals it exactly.  The reference's jitted tiers
    contract ``y0 + f * (y1 - y0)`` into an FMA and may read the
    neighbouring pixel there (never further)."""
    images, rois, C = _pixel_grid_case(S, w)
    port = crop_resize_torch(torch.from_numpy(images),
                             torch.from_numpy(rois), out_size=C).numpy()
    np.testing.assert_array_equal(
        port, np.array(jref.crop_resize_ref(images, rois, out_size=C)))
    np.testing.assert_array_equal(
        port, tref.crop_resize_ref(images, rois, out_size=C).numpy())
    for out in (crop_resize_xla(images, rois, out_size=C),
                crop_resize_pallas(images, rois, out_size=C)):
        assert np.abs(port - np.array(out)).max() <= 1.0   # one pixel


# ----------------------------------------------------------- uncrop
UNCROP_CASES = {
    # name: (leading shape of the boxes, roi shape, bounds, crop size)
    "serve": ((8, 4, 32), (8, 4, 1), (1.0, 1.0), 64),
    "pixels": ((8, 4, 32), (8, 4, 1), (640, 480), 64),
    "ragged": ((3, 5, 7), (3, 5, 7), (123.4, 55.5), 96),
    "flat": ((1000,), (1000,), (1920, 1080), 32),
}


def _uncrop_case(name):
    lead, rlead, bounds, C = UNCROP_CASES[name]
    rng = np.random.default_rng(len(name))
    boxes = rng.uniform(0, C, lead + (4,)).astype(np.float32)
    rois = _windows(rng, 1, int(np.prod(rlead))).reshape(rlead + (4,))
    return boxes, rois, bounds, C


@pytest.mark.parametrize("name", sorted(UNCROP_CASES))
def test_uncrop_plain_equals_oracle_and_jitted_tiers_within_one_ulp(name):
    boxes, rois, bounds, C = _uncrop_case(name)
    kw = dict(bounds=bounds, crop_size=C)
    port = uncrop_boxes_torch(torch.from_numpy(boxes),
                              torch.from_numpy(rois), **kw).numpy()
    assert port.shape == boxes.shape and port.dtype == np.float32
    # exact: the oracle rounds after every operation, as the port does
    np.testing.assert_array_equal(port, np.array(
        jref.uncrop_boxes_ref(boxes, rois, **kw)))
    np.testing.assert_array_equal(
        port, tref.uncrop_boxes_ref(boxes, rois, **kw).numpy())
    # the jitted tiers fuse x0 + t * (x1 - x0): one ULP of the frame scale
    ulp = np.spacing(np.float32(max(bounds)))
    for tier, out in (("XLA twin", uncrop_boxes_xla(boxes, rois, **kw)),
                      ("Pallas (interpret)",
                       uncrop_boxes_pallas(boxes, rois, **kw))):
        err = np.abs(port - np.array(out)).max()
        assert err <= ulp, (name, tier, err, ulp)


def test_ops_dispatch_cpu_tensors_to_the_plain_versions():
    images, rois, C = _crop_case("serve")
    a = ops.crop_resize(torch.from_numpy(images), torch.from_numpy(rois),
                        out_size=C)
    assert torch.equal(a, crop_resize_torch(torch.from_numpy(images),
                                            torch.from_numpy(rois),
                                            out_size=C))
    boxes, r, bounds, C = _uncrop_case("serve")
    u = ops.uncrop_boxes(torch.from_numpy(boxes), torch.from_numpy(r),
                         bounds=bounds, crop_size=C)
    assert torch.equal(u, uncrop_boxes_torch(
        torch.from_numpy(boxes), torch.from_numpy(r), bounds=bounds,
        crop_size=C))


# --------------------------------------------------- selector / rois
CATALOGS = {
    "paper": lambda m: m.paper_catalog(0.5),
    "two": lambda m: m.ModelCatalog([m.paper_catalog(0.5)["fast"],
                                     m.paper_catalog(0.5)["heavy"]]),
    "single": lambda m: m.ModelCatalog([m.ModelProfile(
        "only", 0.8, band="yolov3", service_s=0.4)]),
}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("catalog", sorted(CATALOGS))
def test_selector_replays_reference_decisions(catalog, seed):
    from repro.serving import models as jm
    from repro_torch.serving import models as tm
    jcat, tcat = CATALOGS[catalog](jm), CATALOGS[catalog](tm)
    assert tcat.names == jcat.names
    assert [p.mu for p in tcat.by_quality()] == \
        [p.mu for p in jcat.by_quality()]
    kw = dict(hold=1 + seed, upgrade_headroom=0.6 + 0.1 * seed)
    js, ts = JSelector(jcat, **kw), TSelector(tcat, **kw)
    rng = np.random.default_rng(seed)
    t = 0.0
    for k in range(300):
        t += float(rng.exponential(0.3)) * (k % 7 != 0)   # equal t too
        n = int(rng.integers(0, 5))
        backlog = float(rng.exponential(0.3)) * (rng.uniform() < 0.3)
        # pool capacity in phases: slack, overload, outage, recovery
        scale = (4.0, 0.5, 2.0, 0.0, 8.0)[(k // 30) % 5]
        caps = {p.name: scale * p.mu for p in jcat
                if rng.uniform() < 0.95}
        a = js.decide(t, n, backlog, caps)
        b = ts.decide(t, n, backlog, dict(caps))
        assert a == b, (k, a, b)
        assert js.rate_estimate() == ts.rate_estimate()
    assert js.switches == ts.switches
    if catalog != "single":
        assert ts.switches > 1


@pytest.mark.parametrize("seed", [0, 1])
def test_rois_from_boxes_and_roi_pixels_equal_reference(seed):
    rng = np.random.default_rng(seed)
    for _ in range(20):
        K = int(rng.integers(1, 40))
        W, H = float(rng.choice([1.0, 640.0])), float(rng.choice([1.0,
                                                                  480.0]))
        xy = rng.uniform(-0.1, 1.0, (K, 2)) * [W, H]
        wh = rng.uniform(0, 0.5, (K, 2)) * [W, H]
        boxes = np.concatenate([xy, xy + wh], -1).astype(np.float32)
        scores = rng.uniform(0, 1, K).astype(np.float32)
        scores[::3] = scores[0]                     # ties
        valid = rng.uniform(size=K) < 0.7
        kw = dict(bounds=(W, H), roi_max=int(rng.integers(1, 6)),
                  pad=float(rng.uniform(0, 0.3)))
        (jr, jn), (tr, tn) = (jrois_from_boxes(boxes, scores, valid, **kw),
                              trois_from_boxes(boxes, scores, valid, **kw))
        assert jn == tn
        np.testing.assert_array_equal(tr, jr)
        assert troi_pixels(tr, tn, (W, H)) == jroi_pixels(jr, jn, (W, H))


# ------------------------------------------------- oracle cascade serve
def _port_videos(videos):
    return {s: SyntheticVideo(VideoSpec(**dataclasses.asdict(v.spec)))
            for s, v in videos.items()}


def _lull_burst_lull():
    """``test_cascade.py``'s lull -> burst -> lull trace: (t, stream)."""
    out, t = [], 0.0
    for k in range(60):
        out.append((t, k % 2))
        t += 1.0 / (12.0 if 20 <= k < 40 else 2.0)
    return out


def _trace(name):
    """(JAX frames, port frames, frame_of) of one named trace."""
    if name == "steady_10fps":
        jf, frame_of = trace_for(48, rate=10.0)
    else:
        img = np.zeros((4, 4, 3), np.float32)
        jf, frame_of, seqs = [], {}, [0, 0]
        for k, (t, s) in enumerate(_lull_burst_lull()):
            jf.append(JFrame(k, img, t, stream_id=s))
            frame_of[k] = (s, seqs[s])
            seqs[s] += 1
    tf = [TFrame(f.rid, f.image, f.t_arrival, stream_id=f.stream_id)
          for f in jf]
    return jf, tf, frame_of


def _oracle_cascade(trace, catalog=None, **extra):
    videos = fast_videos()
    jf, tf, frame_of = _trace(trace)
    jcat = jpaper(0.5) if catalog is None else catalog(JCatalog, jpaper)
    tcat = tpaper(0.5) if catalog is None else catalog(TCatalog, tpaper)
    kw = dict(n_replicas=2, track_and_interpolate=True, roi=True,
              roi_bounds=(640, 480), **extra)
    base = JEngine(detect_fn=jcascade_fn(videos, frame_of, jcat),
                   catalog=jcat, **kw).serve(jf)
    port = TEngine(detect_fn=tcascade_fn(_port_videos(videos), frame_of,
                                         tcat),
                   catalog=tcat, device="cpu", **kw).serve(tf)
    return base, port


CASCADE_KEYS = set(cascade_report_keys(
    {}, {}, {}, 0, {"full": 0.0, "roi": 0.0, "passes": 0}, 0))


@pytest.mark.parametrize("trace", ["steady_10fps", "lull_burst_lull"])
def test_oracle_cascade_report_matches_reference(trace):
    base, port = _oracle_cascade(trace)
    assert base["coverage"] == 1.0
    assert base["roi_pixels"]["passes"] > 0          # the second pass ran
    if trace == "lull_burst_lull":
        assert base["model_switches"] > 0            # the selector moved
    for k in CASCADE_KEYS:                           # the block, exact
        assert port[k] == base[k], k
    assert_reports_match(base, port)


def test_post_process_hook_sees_the_batch_model_like_reference():
    """The hook runs after detection, before responses and the tracker,
    on a ``TickState`` that carries the batch's selected model."""
    seen = {"jax": [], "port": []}

    def hook(side):
        def post(tick):
            seen[side].append((tick.model, int(np.sum(tick.valid))))
            keep = np.asarray(tick.valid) & (np.asarray(tick.scores) > 0.5)
            return tick._replace(valid=keep)
        return post

    videos = fast_videos()
    jf, tf, frame_of = _trace("lull_burst_lull")
    kw = dict(n_replicas=2, track_and_interpolate=True)
    base = JEngine(detect_fn=jcascade_fn(videos, frame_of, jpaper(0.5)),
                   catalog=jpaper(0.5), post_process=hook("jax"),
                   **kw).serve(jf)
    port = TEngine(detect_fn=tcascade_fn(_port_videos(videos), frame_of,
                                         tpaper(0.5)),
                   catalog=tpaper(0.5), post_process=hook("port"),
                   device="cpu", **kw).serve(tf)
    assert seen["port"] == seen["jax"]
    assert len({m for m, _ in seen["port"]}) > 1     # models switched
    assert_reports_match(base, port)


@pytest.mark.parametrize("mode_kw", [{"drop_when_busy": True},
                                     {"track_and_interpolate": True}])
def test_single_entry_catalog_equals_pinned_service_time(mode_kw):
    """The reference's bit-identity bar (``test_cascade.py``), on the
    port: a one-model catalog never switches and never runs the ROI
    pass, so the report equals pinning ``service_time`` to the profile,
    apart from the cascade block."""
    cat = TCatalog([TProfile("only", 0.8, band="yolov3", service_s=0.4)])
    reps = []
    for extra in ({"service_time": 0.4},
                  {"catalog": cat, "roi": True, "roi_bounds": (640, 480)}):
        frames, frame_of, videos, _ = tstreams(3, 16, rate=2.0)
        reps.append(TEngine(detect_fn=tcascade_fn(videos, frame_of, cat),
                            n_replicas=2, device="cpu", **mode_kw,
                            **extra).serve(frames))
    base, cas = reps
    assert cas["model_switches"] == 0
    assert cas["roi_pixels"]["passes"] == 0
    assert cas["models"] == {"only": len(cas["model_of_frame"])}
    assert_reports_match({k: v for k, v in base.items()
                          if k not in CASCADE_KEYS},
                         {k: v for k, v in cas.items()
                          if k not in CASCADE_KEYS})


# --------------------------------------------- mini-SSD cascade serve
def _assert_close(base, port, path, atol):
    """Recursive report comparison (responses included): floats within
    ``atol``, everything discrete (ints, bools, strings, keys, lengths)
    exact."""
    if dataclasses.is_dataclass(base):
        base, port = vars(base), vars(port)
    if isinstance(base, dict):
        assert set(base) == set(port), path
        for k in base:
            _assert_close(base[k], port[k], f"{path}.{k}", atol)
    elif isinstance(base, (list, tuple)):
        assert len(base) == len(port), path
        for i, (a, b) in enumerate(zip(base, port)):
            _assert_close(a, b, f"{path}[{i}]", atol)
    elif isinstance(base, np.ndarray) or np.ndim(base):
        a, b = np.asarray(base), np.asarray(port)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if np.issubdtype(a.dtype, np.floating):
            np.testing.assert_allclose(b, a, rtol=0, atol=atol,
                                       err_msg=path)
        else:
            np.testing.assert_array_equal(b, a, err_msg=path)
    elif isinstance(base, float):
        assert abs(base - port) <= atol, (path, base, port)
    else:
        assert base == port, (path, base, port)


def test_mini_ssd_cascade_serve_matches_reference(monkeypatch):
    """2 cameras x 8 frames of benchmark-video pixels at 8 frames/s
    each, the reference's mini-SSD weights (``params_from_numpy``),
    ``paper_catalog(0.15)``: the pool's medium-model capacity sustains
    the 16 frames/s with headroom and the heavy model's does not, so
    the selector climbs once from fast to medium and every later batch
    runs the ROI second pass.  The virtual clock prices that pass by
    the pixel fraction of the first pass's boxes, so clock floats carry
    the forward error too: every float within ``FORWARD_ATOL``; models,
    schedule, valid masks, classes and track ids exact."""
    cfg = jssd.SSDConfig()
    params = jssd.init_ssd(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.array(a), params)
    jframes = _pixel_frames(JFrame, 2, 8, 8.0)
    tframes = _pixel_frames(TFrame, 2, 8, 8.0)
    kw = dict(n_replicas=2, micro_batch=4, track_and_interpolate=True,
              roi=True, roi_bounds=(1.0, 1.0))
    base = JEngine(cfg=cfg, params=params, catalog=jpaper(0.15),
                   **kw).serve(jframes)
    calls = {"crop_resize": 0, "uncrop_boxes": 0}
    for name in calls:
        fn = getattr(ops, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, spy)
    rec = TraceRecorder()
    port = TEngine(cfg=tssd.SSDConfig(),
                   params=tssd.params_from_numpy(tree, device="cpu"),
                   catalog=tpaper(0.15), recorder=rec, device="cpu",
                   **kw).serve(tframes)
    assert base["coverage"] == 1.0 and base["model_switches"] >= 1
    assert base["roi_pixels"]["passes"] > 0
    roi_batches = sum(e["kind"] == "stage" and e["stage"] == "roi"
                      for e in rec.events)
    assert calls == {"crop_resize": roi_batches,
                     "uncrop_boxes": roi_batches}
    for k in ("models", "model_of_frame", "model_map_est",
              "model_switches", "map_estimate"):
        assert port[k] == base[k], k
    assert port["roi_pixels"]["passes"] == base["roi_pixels"]["passes"]
    _assert_close(base, port, "report", FORWARD_ATOL)


def test_roi_stage_matches_reference_on_the_same_tick():
    """The stage alone: one ``TickState`` of first-pass detections fed
    to both ``roi_second_pass`` implementations with the same weights.
    The crop windows are computed from identical boxes, so the crops
    are identical and only the second pass's forward error remains."""
    cfg = jssd.SSDConfig()
    params = jssd.init_ssd(cfg, jax.random.PRNGKey(1))
    tree = jax.tree.map(lambda a: np.array(a), params)
    frames = _pixel_frames(TFrame, 2, 2, 8.0)
    images = np.stack([f.image for f in frames])
    kw = dict(catalog=jpaper(0.15), roi=True, roi_bounds=(1.0, 1.0),
              roi_max=3, n_replicas=1)
    jeng = JEngine(cfg=cfg, params=params, **kw)
    teng = TEngine(cfg=tssd.SSDConfig(), device="cpu",
                   params=tssd.params_from_numpy(tree, device="cpu"),
                   **dict(kw, catalog=tpaper(0.15)))
    (boxes, scores, classes, valid), _ = jeng._detect_batch(images)
    boxes, scores, classes, valid = (np.array(a) for a in
                                     (boxes, scores, classes, valid))
    assert valid.any()
    outs = []
    for pipe, eng, Tick in ((jpipe, jeng, jpipe.TickState),
                            (tpipe, teng, tpipe.TickState)):
        from repro.obs.trace import NULL_RECORDER as jnull
        from repro_torch.obs.trace import NULL_RECORDER as tnull
        tick = Tick(boxes=boxes.copy(), scores=scores.copy(),
                    classes=classes.copy(), valid=valid.copy(),
                    images=images, model="fast")
        outs.append(pipe.roi_second_pass(
            eng, tick, frames, len(frames),
            jnull if pipe is jpipe else tnull))
    (jt, jfrac, _, jpx), (tt, tfrac, _, tpx) = outs
    assert jfrac == tfrac and jpx == tpx
    assert tt.model == jt.model == "heavy"
    np.testing.assert_array_equal(tt.valid, np.array(jt.valid))
    np.testing.assert_array_equal(tt.classes, np.array(jt.classes))
    for f in ("boxes", "scores"):
        np.testing.assert_allclose(getattr(tt, f), np.array(getattr(jt, f)),
                                   rtol=0, atol=FORWARD_ATOL)
