"""The port's NVR serving path against the JAX package on the CPU.

* Oracle path (numpy proxy detector, pinned service time): the port's
  report equals the reference's key for key — schedule, drops, counts,
  per-stream maps, latency block, track ids — for 1, 3 and 8 cameras.
  Only the tracker's float fields of ``interpolated`` responses (boxes
  and scores coasted by the Kalman filter) get a tolerance, rtol 1e-5
  + atol 1e-4: XLA fuses the float32 Kalman arithmetic, PyTorch runs it
  op by op, so they differ in the last bits.
* Real mini-SSD path: the same weights and frames give the same response
  schedule, the same discrete detections and track ids, and floats
  within the forward tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import proxy_detect_fn_streams as jproxy
from repro.core.stream import BENCHMARK_VIDEOS, SyntheticVideo
from repro.detector import ssd as jssd
from repro.kernels import nms as jnms
from repro.serving import DetectionEngine as JEngine
from repro.serving import FrameRequest as JFrame
from repro.serving import make_nvr_streams as jstreams
from repro.serving import pipeline as jpipe
from repro_torch.core import proxy_detect_fn_streams as tproxy
from repro_torch.detector import ssd as tssd
from repro_torch.kernels.nms import _pair_iou
from repro_torch.serving import DetectionEngine as TEngine
from repro_torch.serving import FrameRequest as TFrame
from repro_torch.serving import ServingRuntime
from repro_torch.serving import make_nvr_streams as tstreams
from repro_torch.serving import pipeline as tpipe

INTERP_RTOL, INTERP_ATOL = 1e-5, 1e-4


def assert_reports_match(base, port, *, float_atol=0.0):
    """Port-side copy of the reference tests' ``assert_reports_identical``
    (``tests/test_sharded_serving.py``): every key of the reference
    report is in the port's and equal.  Float fields of a response may
    differ by ``float_atol`` (detected frames: the forward tolerance)
    or, for tracker-interpolated responses, by the stated Kalman
    tolerance; everything discrete stays exact."""
    assert set(base) == set(port)
    for k, bv in base.items():
        pv = port[k]
        if k == "responses":
            assert len(bv) == len(pv)
            for ra, rb in zip(bv, pv):
                for f in ("rid", "replica", "t_start", "t_done",
                          "service_s", "interpolated", "stream_id",
                          "seq"):
                    assert getattr(ra, f) == getattr(rb, f), (ra.rid, f)
                for f in ("classes", "valid"):
                    np.testing.assert_array_equal(
                        getattr(rb, f), getattr(ra, f),
                        err_msg=f"rid {ra.rid} {f}")
                for f in ("boxes", "scores"):
                    a, b = getattr(ra, f), getattr(rb, f)
                    assert a.shape == b.shape and a.dtype == b.dtype
                    if ra.interpolated:
                        np.testing.assert_allclose(
                            b, a, rtol=INTERP_RTOL, atol=INTERP_ATOL,
                            err_msg=f"rid {ra.rid} {f}")
                    elif float_atol:
                        np.testing.assert_allclose(
                            b, a, rtol=0, atol=float_atol,
                            err_msg=f"rid {ra.rid} {f}")
                    else:
                        np.testing.assert_array_equal(
                            b, a, err_msg=f"rid {ra.rid} {f}")
                ta, tb = ra.track_ids, rb.track_ids
                assert (ta is None) == (tb is None)
                if ta is not None:
                    np.testing.assert_array_equal(np.asarray(tb),
                                                  np.asarray(ta))
        elif k == "streams":
            assert bv.keys() == pv.keys()
            for sid in bv:
                assert [r.rid for r in bv[sid]] == [r.rid for r in pv[sid]]
        else:
            assert bv == pv, k


def _oracle_reports(n_cams, mode, n_frames=16, rate=4.0, **kw):
    kw = dict(n_replicas=1, service_time=0.4, **kw,
              **({"drop_when_busy": True} if mode == "drop"
                 else {"track_and_interpolate": True}))
    f, fo, v, d = jstreams(n_cams, n_frames, rate=rate)
    base = JEngine(detect_fn=jproxy(v, d, fo), **kw).serve(f)
    f, fo, v, d = tstreams(n_cams, n_frames, rate=rate)
    port = TEngine(detect_fn=tproxy(v, d, fo), device="cpu",
                   **kw).serve(f)
    return base, port


@pytest.mark.parametrize("mode", ["drop", "track"])
@pytest.mark.parametrize("n_cams", [1, 3, 8])
def test_oracle_nvr_report_matches_reference(n_cams, mode):
    base, port = _oracle_reports(n_cams, mode)
    assert base["dropped"]                      # the drop regime
    if mode == "track":
        assert base["interpolated"] > 0 and base["coverage"] == 1.0
        assert base["tracker_ticks"] == 16
    assert_reports_match(base, port)


def test_oracle_report_adaptive_micro_batches_match():
    """Queue-depth micro-batches (power-of-two buckets) on two replicas."""
    base, port = _oracle_reports(4, "track", n_frames=12, rate=6.0,
                                 max_micro_batch=4)
    assert_reports_match(base, port)


# ------------------------------------------------------ real mini-SSD
def _pixel_frames(Frame, n_cams, n_frames, rate):
    vids = [SyntheticVideo(v) for v in BENCHMARK_VIDEOS.values()]
    return [Frame(k * n_cams + s, vids[s % len(vids)].pixels(k),
                  (k + s / n_cams) / rate, stream_id=s)
            for k in range(n_frames) for s in range(n_cams)]


def _decoded(deltas, obj, anchors):
    anc_wh = anchors[:, 2:] - anchors[:, :2]
    anc_c = (anchors[:, :2] + anchors[:, 2:]) / 2
    c = anc_c + deltas[..., :2] * anc_wh
    wh = anc_wh * np.exp(np.clip(deltas[..., 2:], -4, 4))
    return np.concatenate([c - wh / 2, c + wh / 2], -1), \
        1 / (1 + np.exp(-obj))


def test_real_ssd_nvr_serving_matches_reference():
    cfg = jssd.SSDConfig()
    params = jssd.init_ssd(cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(lambda a: np.array(a), params)
    n_cams, n_frames, rate = 2, 6, 8.0
    jframes = _pixel_frames(JFrame, n_cams, n_frames, rate)
    tframes = _pixel_frames(TFrame, n_cams, n_frames, rate)

    # precondition: no decision lies within the forward error of its
    # threshold, so any discrete difference below is a port fault
    imgs = np.stack([f.image for f in jframes])
    anchors = jssd.make_anchors(cfg)
    dj, oj, _ = (np.array(a) for a in jssd.ssd_forward(
        params, cfg, jnp.asarray(imgs)))
    dt, ot, _ = (a.numpy() for a in tssd.ssd_forward(
        tssd.params_from_numpy(tree, device="cpu"), tssd.SSDConfig(),
        torch.from_numpy(imgs)))
    bj, sj = _decoded(dj, oj, anchors)
    bt, st = _decoded(dt, ot, anchors)
    iou_j = np.array(jnms._pair_iou(jnp.asarray(bj), jnp.asarray(bj)))
    iou_t = _pair_iou(torch.from_numpy(bt), torch.from_numpy(bt)).numpy()
    err_s, err_iou = np.abs(sj - st).max(), np.abs(iou_j - iou_t).max()
    assert err_s < 1e-5 and err_iou < 1e-5
    assert np.abs(sj - 0.4).min() > 10 * err_s
    assert np.abs(iou_j - 0.5).min() > 10 * err_iou

    kw = dict(n_replicas=2, micro_batch=4, service_time=0.2,
              track_and_interpolate=True)
    base = JEngine(cfg=cfg, params=params, **kw).serve(jframes)
    port = TEngine(cfg=tssd.SSDConfig(),
                   params=tssd.params_from_numpy(tree, device="cpu"),
                   device="cpu", **kw).serve(tframes)
    assert base["interpolated"] > 0 and base["coverage"] == 1.0
    assert_reports_match(base, port, float_atol=1e-4)


# ----------------------------------------------------------- pipeline
def test_chunking_helpers_match_reference():
    rng = np.random.default_rng(0)
    t = np.sort(rng.uniform(0, 3, 40))
    jf = [JFrame(i, None, float(x)) for i, x in enumerate(t)]
    tf = [TFrame(i, None, float(x)) for i, x in enumerate(t)]

    class R:
        def __init__(self, b):
            self.busy_until = b

    reps = [R(0.5), R(1.2)]
    for i in range(0, 40, 3):
        for mb in (None, 3):
            a = jpipe.chunk_size(jf, i, micro_batch=mb, max_micro_batch=8,
                                 replicas=reps)
            b = tpipe.chunk_size(tf, i, micro_batch=mb, max_micro_batch=8,
                                 replicas=reps)
            assert a == b
        assert jpipe.dispatch_time(jf, i, reps) == \
            tpipe.dispatch_time(tf, i, reps)
    assert [tpipe.bucket(k) for k in range(1, 10)] == \
        [jpipe.bucket(k) for k in range(1, 10)]
    assert tpipe.TickState._fields == jpipe.TickState._fields
    assert [f.rid for f in tpipe.sorted_chunk(tf[::-1])] == \
        [f.rid for f in jpipe.sorted_chunk(jf[::-1])]


def test_runtime_chunked_ingest_equals_one_shot():
    def engine():
        f, fo, v, d = tstreams(3, 12, rate=4.0)
        return f, TEngine(detect_fn=tproxy(v, d, fo), n_replicas=2,
                          service_time=0.4, track_and_interpolate=True,
                          device="cpu")
    frames, eng = engine()
    one = eng.serve(frames)
    frames, eng = engine()
    rt = ServingRuntime(eng)
    for i in range(0, len(frames), 5):
        rt.ingest(frames[i:i + 5])
        rt.advance()
    assert rt.frames_pending >= 0
    assert_reports_match(one, rt.drain())


def test_runtime_epoch_reports_match_reference():
    """Two epochs through ``epoch_boundary``: each segment report equals
    the reference's, the second segment's tracker continues the first
    one's identities (carried portable rows), and the cumulative view
    and ``drain()`` merge the two segments as the reference does
    (``merge_epoch_shard_reports``)."""
    from repro.serving import ServingRuntime as JRuntime
    reps = []
    for streams, proxy, Engine, Runtime, kw in (
            (jstreams, jproxy, JEngine, JRuntime, {}),
            (tstreams, tproxy, TEngine, ServingRuntime, {"device": "cpu"})):
        f, fo, v, d = streams(2, 12, rate=4.0)
        eng = Engine(detect_fn=proxy(v, d, fo), n_replicas=1,
                     service_time=0.4, track_and_interpolate=True, **kw)
        rt = Runtime(eng)
        rt.ingest(f[:12])
        first = rt.epoch_boundary()
        rt.ingest(f[12:])
        partial = rt.report(rolling=False)
        reps.append((first, partial, rt.epoch_boundary(), rt.drain()))
    (j1, jp, j2, jd), (t1, tp, t2, td) = reps
    assert_reports_match(j1, t1)
    assert_reports_match(j2, t2)
    ids = [{int(t) for r in rep["responses"] if not r.interpolated
            for t in r.track_ids if t >= 0} for rep in (t1, t2)]
    assert ids[0] & ids[1]                      # identities survive
    assert_reports_match(jp, tp)
    assert_reports_match(jd, td)
    assert len(td["responses"]) == 24 and td["per_epoch"].keys() == {0, 1}
