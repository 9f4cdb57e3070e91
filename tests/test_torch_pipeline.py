"""The port's fused tracker tick (``repro_torch.serving.pipeline``)
against the staged chain of the ``tracking`` functions and against the
JAX package, on the CPU.

* ``TickPipeline`` (the fused tick) against the staged chain
  (``trk.step`` / ``trk.coast``, then ``trk.output``), bit for bit: tick
  by tick with a detection-free tick in the middle, the all-invalid row
  against ``coast``, a K-tick ``fused_window``, and whole serves against
  serves whose ticks run the staged chain (``StagedPipeline``).
* The port against the reference's ``_fused_tick`` / ``fused_window``
  on the same numpy inputs: ``det_tid``, ``active``, ``track_id`` and
  ``emit`` exact; ``pos``/``vel``/``cov`` within rtol 1e-5 (atol 1e-5
  near zero), the coasted output boxes and scores within the
  interpolated tolerance (rtol 1e-5, atol 1e-4): XLA fuses the float32
  Kalman arithmetic, PyTorch runs it op by op.
* The CUDA-graph holder (``TickGraph``) with ``ops.CountedGraph``'s
  capture replaced by a stand-in that runs the captured body eagerly on
  the CPU: one capture per shape, replays add the captured launches to
  ``ops.launches()``, a foreign state is copied into the static table,
  a stale one raises, a failed capture raises with nothing run in its
  place, and the packed rows and outputs round trip bit for bit.
* ``ops.CountedGraph`` itself, with only ``torch.cuda``'s graph pieces
  stood in, under each of its three users (``TickGraph``, ``MoEGraph``
  and a ``GraphedDecode`` run): the launches counted while capturing
  are taken back, and each replay adds them once.
* ``DetectionEngine(fused_tick=False)`` raises: the staged tick path is
  gone.
"""
from contextlib import nullcontext

import numpy as np
import pytest
import torch

import repro.tracking as jtrk
import repro_torch.tracking as ttrk
from repro.core import proxy_detect_fn_streams as jproxy
from repro.serving import DetectionEngine as JEngine
from repro.serving import make_nvr_streams as jstreams
from repro.serving import pipeline as jpipe
from repro_torch.configs import get_config
from repro_torch.core import proxy_detect_fn_streams as tproxy
from repro_torch.kernels import association, ops
from repro_torch.kernels import decode_attention as kdecode
from repro_torch.kernels import routed_experts as krouted
from repro_torch.models import init_model, moe
from repro_torch.runtime import GraphedDecode, make_prefill_step, steps
from repro_torch.serving import DetectionEngine as TEngine
from repro_torch.serving import TickPipeline
from repro_torch.serving import engine as tengine
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


# ---------------------------------------- fused tick == staged chain
def staged_chain(state, ticks):
    """The staged chain over ``ticks`` (numpy detection rows): a
    ``trk.step`` a tick, then ``trk.output``.  Returns the final state and
    each tick's ``det_tid`` and outputs as numpy."""
    tids, outs = [], []
    for t in ticks:
        state, tid = ttrk.step(state, *(torch.from_numpy(a) for a in t),
                               CFG_T)
        tids.append(tid.numpy())
        outs.append([a.numpy() for a in ttrk.output(state, CFG_T)])
    return state, tids, outs


class StagedPipeline(TickPipeline):
    """``TickPipeline`` with its ticks run by the staged chain of the
    ``tracking`` functions: ``trk.step`` (or ``trk.coast`` on a
    detection-free tick), then ``trk.output``."""

    def tick(self, state, boxes, scores, classes, valid):
        self.launches += 1
        state, tid = ttrk.step(
            state, *(torch.from_numpy(np.asarray(a)).to(self.device)
                     for a in (boxes, scores, classes, valid)), self.cfg)
        return state, tid.cpu().numpy(), self._output(state)

    def coast(self, state, det_width=1):
        self.launches += 1
        state = ttrk.coast(state, self.cfg)
        return state, self._output(state)

    def _output(self, state):
        return tuple(a.cpu().numpy() for a in ttrk.output(state, self.cfg))


def serve(engine, frames, staged=False):
    """``engine.serve(frames)``; with ``staged`` the engine's tracker
    ticks run the staged chain (``StagedPipeline``)."""
    with pytest.MonkeyPatch.context() as m:
        if staged:
            m.setattr(tengine, "TickPipeline", StagedPipeline)
        return engine.serve(frames)


@pytest.mark.parametrize("B,D", [(1, 4), (3, 5)])
def test_fused_tick_bit_identical_to_staged_chain(B, D):
    rng = np.random.default_rng(42)
    pipe = TickPipeline(CFG_T, device="cpu")
    s1 = ttrk.init_state(B, CFG_T, device="cpu")
    s2 = pipe.seed(list(range(B)))
    for k in range(8):
        dets = random_dets(rng, B, D)
        if k == 5:            # a detection-free tick mid-sequence
            s1 = ttrk.coast(s1, CFG_T)
            s2, o2 = pipe.coast(s2, det_width=D)
        else:
            s1, tid1 = ttrk.step(s1, *(torch.from_numpy(a) for a in dets),
                                 CFG_T)
            s2, tid2, o2 = pipe.tick(s2, *dets)
            assert isinstance(tid2, np.ndarray) and tid2.shape == (B, D)
            np.testing.assert_array_equal(tid1.numpy(), tid2,
                                          err_msg=str(k))
        assert_states_equal(s1, s2)
        assert_outputs_equal([a.numpy() for a in ttrk.output(s1, CFG_T)],
                             o2, f"tick {k}")
    assert pipe.launches == 8
    assert tpipe.export_track_rows(s1, range(B)).keys() \
        == tpipe.export_track_rows(s2, range(B)).keys()


def test_fused_all_invalid_row_equals_coast():
    rng = np.random.default_rng(3)
    B, D = 2, 6
    pipe = TickPipeline(CFG_T, device="cpu")
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
    s1, tids, outs = staged_chain(ttrk.init_state(B, CFG_T, device="cpu"),
                                  ticks)
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
    for staged in (True, False):
        frames, oracle = random_trace(tstreams, tproxy, seed)
        reps.append(serve(TEngine(detect_fn=oracle, device="cpu", **kw),
                          frames, staged))
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
    staged chain's serve and the reference's fused serve."""
    kw = dict(n_replicas=1, service_time=0.4, track_and_interpolate=True)
    f, fo, v, d = jstreams(3, 16, rate=4.0)
    base = JEngine(detect_fn=jproxy(v, d, fo), fused_tick=True,
                   **kw).serve(f)
    reps = []
    for staged in (True, False):
        f, fo, v, d = tstreams(3, 16, rate=4.0)
        reps.append(serve(TEngine(detect_fn=tproxy(v, d, fo),
                                  device="cpu", **kw), f, staged))
    assert reps[1]["interpolated"] > 0 and reps[1]["coverage"] == 1.0
    assert_reports_match(*reps)
    assert_reports_match(base, reps[1])


def test_staged_tick_path_is_gone():
    with pytest.raises(ValueError, match="staged tick path is gone"):
        TEngine(detect_fn=lambda *a: None, fused_tick=False, device="cpu")
    assert not hasattr(TEngine(device="cpu"), "fused_tick")


# ---------------------------------------- the CUDA-graph holder, stood in
class Rerun:
    """Stands in for a captured CUDA graph on the CPU: ``replay`` runs
    the captured body again into the tensors the capture returned, and
    holds the wrappers' counters as they were, as a real replay (which
    calls no wrapper) would."""

    def __init__(self, body, out):
        self.body, self.out = body, out

    def replay(self):
        held = ops.launches()
        self.out.copy_(self.body())
        ops.add_launches({k: held[k] - n for k, n in ops.launches().items()})


class EagerGraph(ops.CountedGraph):
    """``ops.CountedGraph`` with the capture stood in: the body runs once
    (a capture runs the Python once) and the graph is a ``Rerun``; the
    launch accounting is ``CountedGraph``'s own.  ``captures`` lists
    the devices captured on."""
    captures: list = []

    def _capture(self, body, device, pool):
        self.captures.append(device)
        out = body()
        self.graph = Rerun(body, out)
        return out


@pytest.fixture
def stand_in(monkeypatch):
    """``ops.CountedGraph`` replaced by ``EagerGraph``; the CPU plain
    assignment counted as if it were the kernel's wrapper; the graph
    cache and counters emptied before and after.  Yields the list of
    captures made."""
    captures = []
    plain = ops.greedy_assign_torch

    def counted(*a, **k):
        association.LAUNCHES += 1
        return plain(*a, **k)

    monkeypatch.setattr(EagerGraph, "captures", captures)
    monkeypatch.setattr(ops, "CountedGraph", EagerGraph)
    monkeypatch.setattr(ops, "greedy_assign_torch", counted)
    tpipe.clear_tick_graphs()
    ops.reset_launches()
    yield captures
    tpipe.clear_tick_graphs()
    ops.reset_launches()


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

    def failing(body, device, pool=None):
        raise RuntimeError("operation not permitted when stream is "
                           "capturing")

    monkeypatch.setattr(ttrk, "step", step)
    monkeypatch.setattr(ops, "CountedGraph", failing)
    state = ttrk.init_state(2, CFG_T, device="cpu")
    with pytest.raises(RuntimeError, match="capturing"):
        tpipe.graph_ticks(state, *(a[None] for a in empty_dets(2, 4)),
                          CFG_T)
    assert ran == [1]            # the warm-up, and nothing after it
    assert tpipe.tick_graphs() == []
    assert ops.launches()["greedy_assign"] == 1     # the warm-up's


# ----------------------------------- ops.CountedGraph under its users
class NoGraph:
    """Stands in for ``torch.cuda.CUDAGraph``: a replay runs nothing."""

    def replay(self):
        pass


class NoDevice(nullcontext):
    """Stands in for ``torch.cuda.device`` (a class: torch checks
    instances of it): entering it changes nothing."""

    def __init__(self, device):
        super().__init__()


def _counting(monkeypatch, owner, name, module, attr, n=1):
    """``owner.name`` replaced by a call that adds ``n`` to
    ``module.attr``, as a kernel's wrapper counts, then runs the real
    one."""
    real = getattr(owner, name)

    def counted(*a, **k):
        setattr(module, attr, getattr(module, attr) + n)
        return real(*a, **k)
    monkeypatch.setattr(owner, name, counted)


def _tick_graph_user(monkeypatch):
    _counting(monkeypatch, ops, "greedy_assign_torch", association,
              "LAUNCHES")
    rows = tpipe.pack_rows(*(np.stack([a, a]) for a in empty_dets(1, 4)))
    held = {"state": ttrk.init_state(1, CFG_T, device="cpu")}

    def capture():
        held["g"] = tpipe.TickGraph(CFG_T, 2, 1, 4, torch.device("cpu"))
        return [held["g"].graph]

    def replay():
        held["state"], _ = held["g"](held["state"], rows)

    return "greedy_assign", capture, replay, 1      # and one warm-up


def _moe_graph_user(monkeypatch):
    cfg = get_config("grok-1-314b", preset="smoke")
    p = moe.init_moe(torch.Generator().manual_seed(3), cfg)
    x = torch.randn((1, 1, cfg.d_model),
                    generator=torch.Generator().manual_seed(5))
    _counting(monkeypatch, moe.ops, "routed_expert_ffn", krouted,
              "LAUNCHES", 2)
    monkeypatch.setattr(moe, "_decode_shaped", lambda x_disp, we: True)
    choices = [moe.route(x[0], p["router"]["w"], cfg.moe)[:2]]
    experts = steps.MoEGraph()
    experts(p, cfg, x, choices)            # fixes the router's inputs

    def capture():
        experts.capture(p, cfg, x, None)
        return [experts.graph]

    return ("routed_experts", capture,
            lambda: experts(p, cfg, x, choices), 0)


def _graphed_decode_user(monkeypatch):
    cfg = get_config("qwen3-4b", preset="smoke")
    params = init_model(cfg, torch.Generator().manual_seed(0),
                        device="cpu")
    toks = torch.arange(1, 6)[None]
    logits, cache = make_prefill_step(cfg, cache_len=16)(
        params, {"tokens": toks})
    step = GraphedDecode(cfg)
    batch = {"tokens": torch.argmax(logits, -1)[:, None], "cache": cache,
             "decode_pos": 5}
    step(params, batch)                    # eager on the CPU: no capture
    assert not step.graphs
    # a counted launch inside the run, which no wrapper makes today
    _counting(monkeypatch, steps, "decode_run", kdecode, "LAUNCHES")

    def capture():
        with torch.no_grad():
            step._capture()
        return step.graphs

    def replay():
        step(params, dict(batch, cache=step.cache, decode_pos=6))

    return "decode_attention", capture, replay, 0


GRAPH_USERS = {"TickGraph": _tick_graph_user, "MoEGraph": _moe_graph_user,
               "GraphedDecode": _graphed_decode_user}


@pytest.mark.parametrize("user", sorted(GRAPH_USERS))
def test_counted_graph_takes_back_capture_and_adds_each_replay(monkeypatch,
                                                               user):
    """Each user captures through the real ``ops.CountedGraph``, with
    ``torch.cuda``'s graph pieces stood in (a replay runs nothing): the
    launches counted while capturing are taken back and kept, and each
    replay adds them once."""
    monkeypatch.setattr(torch.cuda, "CUDAGraph", NoGraph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, pool=None: nullcontext())
    monkeypatch.setattr(torch.cuda, "device", NoDevice)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", lambda: None)
    tpipe.clear_tick_graphs()
    ops.reset_launches()
    key, capture, replay, warm_ups = GRAPH_USERS[user](monkeypatch)
    before = ops.launches()
    graphs = capture()
    assert graphs and all(type(g) is ops.CountedGraph
                          and isinstance(g.graph, NoGraph) for g in graphs)
    per = sum(g.captured.get(key, 0) for g in graphs)
    assert per > 0 and all(set(g.captured) <= {key} for g in graphs)
    for n in range(4):                     # no other counter moves
        assert ops.launches() == dict(
            before, **{key: before[key] + (warm_ups + n) * per})
        replay()
    tpipe.clear_tick_graphs()
    ops.reset_launches()


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
