"""The port's fused tracker tick (``repro_torch.serving.pipeline``)
against its own staged chain and against the JAX package, on the CPU.

* Fused against staged on the port, bit for bit: tick by tick with a
  detection-free tick in the middle, the all-invalid row against
  ``coast``, a K-tick ``fused_window`` against the staged chain, and
  whole serves with ``fused_tick=True`` against staged ones.
* The port against the reference's ``_fused_tick`` / ``fused_window``
  on the same numpy inputs: ``det_tid``, ``active``, ``track_id`` and
  ``emit`` exact; ``pos``/``vel``/``cov`` within rtol 1e-5 (atol 1e-5
  near zero), the coasted output boxes and scores within the
  interpolated tolerance (rtol 1e-5, atol 1e-4): XLA fuses the float32
  Kalman arithmetic, PyTorch runs it op by op.
* The CUDA-graph holder (``TickGraph``) with ``capture_graph`` replaced
  by a stand-in that runs the captured body eagerly on the CPU: one
  capture per shape, replays add the captured launches to
  ``ops.launches()``, a foreign state is copied into the static table,
  a stale one raises, a failed capture raises with nothing run in its
  place, and the packed rows and outputs round trip bit for bit.
"""
import numpy as np
import pytest
import torch

import repro.tracking as jtrk
import repro_torch.tracking as ttrk
from repro.core import proxy_detect_fn_streams as jproxy
from repro.serving import DetectionEngine as JEngine
from repro.serving import make_nvr_streams as jstreams
from repro.serving import pipeline as jpipe
from repro_torch.core import proxy_detect_fn_streams as tproxy
from repro_torch.kernels import association, ops
from repro_torch.serving import DetectionEngine as TEngine
from repro_torch.serving import TickPipeline
from repro_torch.serving import make_nvr_streams as tstreams
from repro_torch.serving import pipeline as tpipe
from test_torch_serving import assert_reports_match

CFG_T = ttrk.TrackerConfig(capacity=16)
CFG_J = jtrk.TrackerConfig(capacity=16)
STATE_RTOL = STATE_ATOL = 1e-5          # Kalman floats (ROADMAP §3)
INTERP_RTOL, INTERP_ATOL = 1e-5, 1e-4
SEEDS = list(range(6))     # tests/test_serving_properties.py's SEEDS


def random_dets(rng, B, D):
    tl = rng.uniform(0, 400, (B, D, 2)).astype(np.float32)
    wh = rng.uniform(10, 60, (B, D, 2)).astype(np.float32)
    return (np.concatenate([tl, tl + wh], -1),
            rng.uniform(0.5, 1.0, (B, D)).astype(np.float32),
            rng.integers(0, 3, (B, D)).astype(np.int32),
            rng.random((B, D)) > 0.2)


def empty_dets(B, D):
    return (np.zeros((B, D, 4), np.float32), np.zeros((B, D), np.float32),
            np.zeros((B, D), np.int32), np.zeros((B, D), bool))


def window(rng, K, B, D, empty_at=3):
    ticks = [random_dets(rng, B, D) for _ in range(K)]
    ticks[empty_at] = empty_dets(B, D)      # a detection-free tick
    return ticks, tuple(np.stack([t[i] for t in ticks]) for i in range(4))


def assert_states_equal(a, b):
    for f in ttrk.TrackerState._fields:
        assert torch.equal(getattr(a, f).cpu(), getattr(b, f).cpu()), f


def assert_outputs_equal(a, b, what):
    for i, (x, y) in enumerate(zip(a, b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=f"{what} output {i}")


def assert_state_matches_reference(js, ts, what):
    for f in ("active", "track_id", "hits", "tsu", "cls", "next_id"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.array(getattr(js, f)),
                                      err_msg=f"{what} {f}")
    for f in ("pos", "vel", "cov", "score"):
        np.testing.assert_allclose(getattr(ts, f).numpy(),
                                   np.array(getattr(js, f)),
                                   rtol=STATE_RTOL, atol=STATE_ATOL,
                                   err_msg=f"{what} {f}")


def assert_outputs_match_reference(jout, tout, what):
    jb, js, jc, jid, jemit = (np.array(a) for a in jout)
    tb, ts, tc, tid, temit = tout
    for name, j, t in (("classes", jc, tc), ("track_ids", jid, tid),
                       ("emit", jemit, temit)):
        np.testing.assert_array_equal(t, j, err_msg=f"{what} {name}")
    for name, j, t in (("boxes", jb, tb), ("scores", js, ts)):
        np.testing.assert_allclose(t, j, rtol=INTERP_RTOL,
                                   atol=INTERP_ATOL,
                                   err_msg=f"{what} {name}")


# ----------------------------------------------- fused == staged (port)
@pytest.mark.parametrize("B,D", [(1, 4), (3, 5)])
def test_fused_tick_bit_identical_to_staged_chain(B, D):
    rng = np.random.default_rng(42)
    staged = TickPipeline(CFG_T, device="cpu")
    fused = TickPipeline(CFG_T, fused=True, device="cpu")
    s1 = staged.seed(list(range(B)))
    s2 = fused.seed(list(range(B)))
    for k in range(8):
        dets = random_dets(rng, B, D)
        if k == 5:            # a detection-free tick mid-sequence
            s1, o1 = staged.coast(s1, det_width=D)
            s2, o2 = fused.coast(s2, det_width=D)
        else:
            s1, tid1, o1 = staged.tick(s1, *dets)
            s2, tid2, o2 = fused.tick(s2, *dets)
            assert isinstance(tid2, np.ndarray) and tid2.shape == (B, D)
            np.testing.assert_array_equal(tid1, tid2, err_msg=str(k))
        assert o1 is None and o2 is not None
        assert_states_equal(s1, s2)
        assert_outputs_equal([a.numpy() for a in staged.output(s1)], o2,
                             f"tick {k}")
    assert staged.launches == fused.launches == 8
    assert tpipe.export_track_rows(s1, range(B)).keys() \
        == tpipe.export_track_rows(s2, range(B)).keys()


def test_fused_all_invalid_row_equals_coast():
    rng = np.random.default_rng(3)
    B, D = 2, 6
    pipe = TickPipeline(CFG_T, fused=True, device="cpu")
    s = pipe.seed([0, 1])
    for _ in range(3):
        s, _, _ = pipe.tick(s, *random_dets(rng, B, D))
    coasted = ttrk.coast(s, CFG_T)
    s_fused, out = pipe.coast(s, det_width=D)
    assert_states_equal(coasted, s_fused)
    assert_outputs_equal([a.numpy() for a in ttrk.output(coasted, CFG_T)],
                         out, "coast")


def test_fused_window_bit_identical_to_staged_chain():
    rng = np.random.default_rng(7)
    B, D, K = 2, 5, 6
    ticks, stacked = window(rng, K, B, D)
    s1 = ttrk.init_state(B, CFG_T, device="cpu")
    tids, outs = [], []
    for t in ticks:
        s1, tid = ttrk.step(s1, *(torch.from_numpy(a) for a in t), CFG_T)
        tids.append(tid.numpy())
        outs.append([a.numpy() for a in ttrk.output(s1, CFG_T)])
    s2, wtid, wout = tpipe.fused_window(
        ttrk.init_state(B, CFG_T, device="cpu"), *stacked, CFG_T)
    assert_states_equal(s1, s2)
    assert wtid.shape == (K, B, D)
    for k in range(K):
        np.testing.assert_array_equal(wtid[k], tids[k], err_msg=str(k))
        assert_outputs_equal(outs[k], [a[k] for a in wout], f"tick {k}")


# ------------------------------------------- port fused == JAX fused
@pytest.mark.parametrize("B,D", [(1, 4), (3, 5)])
def test_fused_tick_matches_reference(B, D):
    rng = np.random.default_rng(11)
    jtick = jpipe.make_fused_tick(CFG_J)
    ttick = tpipe.make_fused_tick(CFG_T)
    js = jtrk.init_state(B, CFG_J)
    ts = ttrk.init_state(B, CFG_T, device="cpu")
    for k in range(8):
        dets = empty_dets(B, D) if k == 5 else random_dets(rng, B, D)
        js, jtid, jout = jtick(js, *dets)
        ts, ttid, tout = ttick(ts, *dets)
        np.testing.assert_array_equal(ttid, np.array(jtid),
                                      err_msg=f"tick {k} det_tid")
        assert_state_matches_reference(js, ts, f"tick {k}")
        assert_outputs_match_reference(jout, tout, f"tick {k}")


def test_fused_window_matches_reference():
    rng = np.random.default_rng(5)
    B, D, K = 3, 5, 6
    _, stacked = window(rng, K, B, D)
    js, jtid, jout = jpipe.fused_window(jtrk.init_state(B, CFG_J),
                                        *stacked, CFG_J)
    ts, ttid, tout = tpipe.fused_window(
        ttrk.init_state(B, CFG_T, device="cpu"), *stacked, CFG_T)
    np.testing.assert_array_equal(ttid, np.array(jtid))
    assert_state_matches_reference(js, ts, "window")
    assert_outputs_match_reference(jout, tout, "window")


# ------------------------------------------------ engine: fused serves
def random_trace(make_streams, proxy, seed):
    """``tests/test_serving_properties.py:random_trace`` over either
    package's stream maker and proxy oracle."""
    rng = np.random.default_rng(seed)
    n_streams = int(rng.integers(1, 5))
    n_frames = int(rng.integers(2, 12))
    rate = float(rng.uniform(1.0, 8.0))
    frames, frame_of, videos, dets = make_streams(n_streams, n_frames,
                                                  rate)
    for f in frames:
        f.t_arrival = max(0.0, f.t_arrival +
                          float(rng.uniform(-0.05, 0.05)))
    frames.sort(key=lambda f: (f.t_arrival, f.rid))
    return frames, proxy(videos, dets, frame_of)


def engine_kw(seed):
    """``check_fused_matches_staged``'s engine settings for ``seed``."""
    rng = np.random.default_rng(2000 + seed)
    return dict(n_replicas=int(rng.integers(1, 4)),
                service_time=float(rng.uniform(0.1, 0.6)),
                track_and_interpolate=True,
                drop_when_busy=bool(rng.integers(2)))


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_engine_report_identical_to_staged(seed):
    kw = engine_kw(seed)
    reps = []
    for fused in (False, True):
        frames, oracle = random_trace(tstreams, tproxy, seed)
        reps.append(TEngine(detect_fn=oracle, fused_tick=fused,
                            device="cpu", **kw).serve(frames))
    assert_reports_match(*reps)
    assert reps[1]["tracker_launches"] == reps[1]["tracker_ticks"]


@pytest.mark.parametrize("seed", SEEDS)
def test_fused_engine_matches_reference_fused(seed):
    kw = engine_kw(seed)
    frames, oracle = random_trace(jstreams, jproxy, seed)
    base = JEngine(detect_fn=oracle, fused_tick=True, **kw).serve(frames)
    frames, oracle = random_trace(tstreams, tproxy, seed)
    port = TEngine(detect_fn=oracle, fused_tick=True, device="cpu",
                   **kw).serve(frames)
    assert_reports_match(base, port)


def test_fused_engine_interpolates_on_nvr_trace():
    """A drop-regime NVR trace: fused serves interpolate, and equal the
    staged serve and the reference's fused serve."""
    kw = dict(n_replicas=1, service_time=0.4, track_and_interpolate=True)
    f, fo, v, d = jstreams(3, 16, rate=4.0)
    base = JEngine(detect_fn=jproxy(v, d, fo), fused_tick=True,
                   **kw).serve(f)
    reps = []
    for fused in (False, True):
        f, fo, v, d = tstreams(3, 16, rate=4.0)
        reps.append(TEngine(detect_fn=tproxy(v, d, fo), fused_tick=fused,
                            device="cpu", **kw).serve(f))
    assert reps[1]["interpolated"] > 0 and reps[1]["coverage"] == 1.0
    assert_reports_match(*reps)
    assert_reports_match(base, reps[1])


# ---------------------------------------- the CUDA-graph holder, stood in
class EagerGraph:
    """Stands in for a captured CUDA graph on the CPU: ``replay`` runs
    the captured body again into the tensors the capture returned, and
    holds the wrappers' counters as they were, as a real replay (which
    calls no wrapper) would."""

    def __init__(self, body):
        self.body = body
        self.out = body()          # a capture runs the Python once

    def replay(self):
        held = ops.launches()
        self.out.copy_(self.body())
        ops.add_launches({k: held[k] - n for k, n in ops.launches().items()})


@pytest.fixture
def stand_in(monkeypatch):
    """``capture_graph`` replaced by ``EagerGraph``; the CPU plain
    assignment counted as if it were the kernel's wrapper; the graph
    cache and counters emptied before and after.  Yields the list of
    captures made."""
    captures = []
    plain = ops.greedy_assign_torch

    def capture(body, device):
        captures.append(device)
        g = EagerGraph(body)
        return g, g.out

    def counted(*a, **k):
        association.LAUNCHES += 1
        return plain(*a, **k)

    monkeypatch.setattr(tpipe, "capture_graph", capture)
    monkeypatch.setattr(ops, "greedy_assign_torch", counted)
    tpipe.clear_tick_graphs()
    ops.reset_launches()
    yield captures
    tpipe.clear_tick_graphs()
    ops.reset_launches()


def staged_chain(state, ticks):
    tids, outs = [], []
    for t in ticks:
        state, tid = ttrk.step(state, *(torch.from_numpy(a) for a in t),
                               CFG_T)
        tids.append(tid.numpy())
        outs.append([a.numpy() for a in ttrk.output(state, CFG_T)])
    return state, tids, outs


def test_graph_ticks_bit_identical_through_the_holder(stand_in):
    """Packed rows in, packed outputs out, static table threaded: the
    stood-in graph gives the staged chain's bits, tick and window."""
    rng = np.random.default_rng(9)
    B, D, K = 3, 5, 4
    ticks, stacked = window(rng, K, B, D, empty_at=1)
    ref_state, tids, outs = staged_chain(
        ttrk.init_state(B, CFG_T, device="cpu"), ticks)
    state = ttrk.init_state(B, CFG_T, device="cpu")
    for k, t in enumerate(ticks):
        state, tid, out = tpipe.graph_ticks(
            state, *(a[None] for a in t), CFG_T)
        np.testing.assert_array_equal(tid[0], tids[k])
        assert_outputs_equal(outs[k], [a[0] for a in out], f"tick {k}")
    assert_states_equal(ref_state, state)
    state, wtid, wout = tpipe.graph_ticks(
        ttrk.init_state(B, CFG_T, device="cpu"), *stacked, CFG_T)
    assert_states_equal(ref_state, state)
    for k in range(K):
        np.testing.assert_array_equal(wtid[k], tids[k])
        assert_outputs_equal(outs[k], [a[k] for a in wout], f"window {k}")
    assert [g.shape for g in tpipe.tick_graphs()] == [(1, B, D), (K, B, D)]


def test_one_capture_per_shape_and_replays_count_launches(stand_in):
    rng = np.random.default_rng(1)
    B, D, K = 2, 4, 3
    state = ttrk.init_state(B, CFG_T, device="cpu")
    for _ in range(5):
        state, _, _ = tpipe.graph_ticks(
            state, *(a[None] for a in random_dets(rng, B, D)), CFG_T)
    g1, = tpipe.tick_graphs()
    assert len(stand_in) == 1 and g1.replays == 5
    assert g1.captured == {"greedy_assign": 1}
    # the warm-up's launch ran and stays counted; the capture's did not
    # run and is taken back; each replay adds what was captured
    assert ops.launches()["greedy_assign"] == 1 + 5 * 1
    _, stacked = window(rng, K, B, D, empty_at=1)
    for _ in range(2):
        state, _, _ = tpipe.graph_ticks(state, *stacked, CFG_T)
    _, gk = tpipe.tick_graphs()
    assert len(stand_in) == 2 and gk.shape == (K, B, D)
    assert gk.captured == {"greedy_assign": K} and gk.replays == 2
    assert ops.launches()["greedy_assign"] == 6 + (1 + 2) * K
    # another detection width is another shape, another capture
    tpipe.graph_ticks(state, *(a[None] for a in random_dets(rng, B, 8)),
                      CFG_T)
    assert len(stand_in) == 3 and len(tpipe.tick_graphs()) == 3
    expect = sum((1 + g.replays) * g.captured["greedy_assign"]
                 for g in tpipe.tick_graphs())
    assert ops.launches() == dict(
        {k: 0 for k in ops.launches()}, greedy_assign=expect)


def test_foreign_state_copied_into_the_static_table(stand_in):
    rng = np.random.default_rng(4)
    B, D = 2, 4
    ticks = [random_dets(rng, B, D) for _ in range(6)]
    ref, tids, _ = staged_chain(ttrk.init_state(B, CFG_T, device="cpu"),
                                ticks)
    # three staged ticks, then the graph takes over the foreign table
    mid, _, _ = staged_chain(ttrk.init_state(B, CFG_T, device="cpu"),
                             ticks[:3])
    state = mid
    for k, t in enumerate(ticks[3:], 3):
        state, tid, _ = tpipe.graph_ticks(state, *(a[None] for a in t),
                                          CFG_T)
        np.testing.assert_array_equal(tid[0], tids[k])
    g, = tpipe.tick_graphs()
    assert all(a is b for a, b in zip(state, g.state))
    assert not any(a is b for a, b in zip(mid, g.state))
    assert_states_equal(ref, state)
    # the table passed in is read, never written
    assert_states_equal(mid, staged_chain(
        ttrk.init_state(B, CFG_T, device="cpu"), ticks[:3])[0])


def test_stale_state_raises(stand_in):
    rng = np.random.default_rng(6)
    B, D = 1, 4
    s0 = ttrk.init_state(B, CFG_T, device="cpu")
    s1, _, _ = tpipe.graph_ticks(s0, *(a[None] for a in
                                      random_dets(rng, B, D)), CFG_T)
    s2, _, _ = tpipe.graph_ticks(s1, *(a[None] for a in
                                      random_dets(rng, B, D)), CFG_T)
    with pytest.raises(RuntimeError, match="thread the state"):
        tpipe.graph_ticks(s1, *(a[None] for a in random_dets(rng, B, D)),
                          CFG_T)
    assert tpipe.tick_graphs()[0].replays == 2


def test_failed_capture_raises_with_no_eager_fallback(monkeypatch,
                                                      stand_in):
    ran = []
    real_step = ttrk.step

    def step(*a, **k):
        ran.append(1)
        return real_step(*a, **k)

    def failing(body, device):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(ttrk, "step", step)
    monkeypatch.setattr(tpipe, "capture_graph", failing)
    state = ttrk.init_state(2, CFG_T, device="cpu")
    with pytest.raises(RuntimeError, match="capturing"):
        tpipe.graph_ticks(state, *(a[None] for a in empty_dets(2, 4)),
                          CFG_T)
    assert ran == [1]            # the warm-up, and nothing after it
    assert tpipe.tick_graphs() == []
    assert ops.launches()["greedy_assign"] == 1     # the warm-up's


def test_packing_round_trips_bit_for_bit():
    rng = np.random.default_rng(8)
    K, B, D, T = 2, 3, 5, 7
    dets = [random_dets(rng, B, D) for _ in range(K)]
    boxes, scores, classes, valid = (np.stack([d[i] for d in dets])
                                     for i in range(4))
    boxes[0, 0, 0] = [np.nan, -0.0, np.inf, -np.inf]
    rows = tpipe.pack_rows(boxes, scores, classes, valid)
    assert rows.shape == (K, B, 7 * D) and rows.dtype == np.int32
    for k in range(K):
        got = tpipe.unpack_rows(torch.from_numpy(rows[k]), D)
        for g, want in zip(got, (boxes[k], scores[k], classes[k],
                                 valid[k])):
            assert g.numpy().tobytes() == np.asarray(want).tobytes()
    tid = torch.from_numpy(rng.integers(-1, 9, (B, D)).astype(np.int32))
    out = (torch.from_numpy(rng.normal(size=(B, T, 4)).astype(np.float32)),
           torch.from_numpy(rng.normal(size=(B, T)).astype(np.float32)),
           torch.from_numpy(rng.integers(0, 3, (B, T)).astype(np.int32)),
           torch.from_numpy(rng.integers(-1, 99, (B, T)).astype(np.int32)),
           torch.from_numpy(rng.random((B, T)) > 0.5))
    packed = tpipe.pack_outputs(tid, out).numpy()
    assert packed.shape == (B, D + 8 * T)
    got_tid, got = tpipe.unpack_outputs(packed, D, T)
    assert got_tid.tobytes() == tid.numpy().tobytes()
    for g, want in zip(got, out):
        assert g.dtype == want.numpy().dtype
        assert g.tobytes() == want.numpy().tobytes()
