"""Wall-clock spans of the port (``repro_torch.obs.trace``), on the CPU:
under a ``torch.profiler`` every span of the NVR and token paths is a
host range ``repro.<name>`` (a host operation, not a user annotation,
so no device mirror), the ranges nest as the work does, and every
garbage collection is a ``repro.gc`` range; with no profiler no range
opens and a span allocates nothing; a serve gives the same report with
and without a profiler; the stage walls are read inside their ranges."""
import doctest
import gc
import itertools
import time
import tracemalloc

import numpy as np
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.core import proxy_detect_fn_streams
from repro_torch.obs import TraceRecorder
from repro_torch.obs import trace as trace_mod
from repro_torch.obs.trace import Timed, span, spanned
from repro_torch.serving import (DetectionEngine, Request, ServingEngine,
                                 ServingRuntime, make_cascade_detect_fn,
                                 make_nvr_streams, paper_catalog)

NVR_SPANS = {"runtime.ingest", "runtime.batch", "runtime.epoch", "detect",
             "track", "track.tick"}
LLM_SPANS = {"llm.prefill", "llm.decode", "llm.read"}


def _canon(x):
    """A report as plain data: responses as their fields, arrays as
    lists."""
    if isinstance(x, dict):
        return {k: _canon(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_canon(v) for v in x]
    if isinstance(x, np.ndarray):
        return x.tolist()
    if hasattr(x, "__dict__"):
        return _canon(vars(x))
    return x


def _nvr_serve(rec=None, epochs=2):
    """Three cameras at 4 fps on one replica pinned at 0.4 s: drops,
    tracker fill, a runtime cut into ``epochs`` epochs."""
    frames, frame_of, videos, dets = make_nvr_streams(3, 12, rate=4.0)
    eng = DetectionEngine(detect_fn=proxy_detect_fn_streams(
        videos, dets, frame_of), n_replicas=1, service_time=0.4,
        track_and_interpolate=True, recorder=rec, device="cpu")
    rt = ServingRuntime(eng)
    step = len(frames) // epochs
    reps = []
    for i in range(0, len(frames), step):
        rt.ingest(frames[i:i + step])
        reps.append(rt.epoch_boundary())
    return reps


def _llm_engine():
    cfg = get_config("qwen3-4b", preset="smoke")
    eng = ServingEngine(cfg, n_replicas=2, cache_len=32, device="cpu")
    eng.warmup(6)
    return eng


def _requests(n_out=(3, 5)):
    rng = np.random.default_rng(0)
    return [Request(i, rng.integers(0, 100, 6).astype(np.int32), n)
            for i, n in enumerate(n_out)]


def _ranges(work):
    """``(name, t0_ns, t1_ns)`` of each ``repro.`` range that ``work()``
    opens under a CPU profiler, with the name's prefix cut, in start
    order, and the result of ``work()``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = work()
    evs = [e for e in prof.profiler.kineto_results.events()
           if e.name().startswith("repro.")]
    assert not any(e.is_user_annotation() for e in evs)
    got = sorted((e.start_ns(), e.start_ns() + e.duration_ns(),
                  e.name()[len("repro."):]) for e in evs)
    return [(n, a, b) for a, b, n in got], out


def _named(rs, name):
    return [(a, b) for n, a, b in rs if n == name]


def _inside(inner, outer):
    x, y = inner
    return any(a <= x and y <= b for a, b in outer)


class _Core:
    @spanned("runtime.batch")
    def batch(self, n):
        """One batch."""
        with span("detect"):
            time.sleep(0.002)
        return n


def test_spans_nest_and_keep_their_own_intervals():
    rs, out = _ranges(lambda: _Core().batch(4))
    assert out == 4 and _Core.batch.__doc__ == "One batch."
    (n1, a1, b1), (n2, a2, b2) = rs
    assert (n1, n2) == ("runtime.batch", "detect")
    assert a1 <= a2 < b2 <= b1 and b2 - a2 >= 2e6


def test_a_span_without_a_profiler_opens_nothing_and_allocates_nothing():
    """Every span is one shared no-op context; 10,000 of them keep
    nothing and peak as high as 10."""
    assert span("detect") is span("track.tick")

    def calls(n):
        for _ in itertools.repeat(None, n):
            with span("llm.decode"):
                pass

    calls(10)                                   # warm every code path
    tracemalloc.start()
    try:
        peaks = []
        for n in (10, 10_000):
            base = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            calls(n)
            cur, peak = tracemalloc.get_traced_memory()
            assert cur == base
            peaks.append(peak - base)
    finally:
        tracemalloc.stop()
    assert peaks[0] == peaks[1]


def test_detection_serve_has_every_range_and_keeps_its_report():
    plain = _nvr_serve()
    rs, traced = _ranges(_nvr_serve)
    assert _canon(traced) == _canon(plain)
    assert {n for n, _, _ in rs} - {"gc"} == NVR_SPANS
    assert len(_named(rs, "runtime.ingest")) == 2
    assert len(_named(rs, "runtime.epoch")) == 2
    assert len(_named(rs, "track.tick")) == 12
    batches, detects = _named(rs, "runtime.batch"), _named(rs, "detect")
    assert 0 < len(detects) <= len(batches)
    # each detect inside a batch, each batch and fill inside an epoch
    epochs = _named(rs, "runtime.epoch")
    assert all(_inside(d, batches) for d in detects)
    assert all(_inside(b, epochs) for b in batches)
    assert all(_inside(t, epochs) for t in _named(rs, "track"))
    assert all(_inside(t, _named(rs, "track"))
               for t in _named(rs, "track.tick"))


def test_cascade_roi_pass_is_a_range_around_its_detect():
    frames, frame_of, videos, _ = make_nvr_streams(2, 16, rate=12.0)
    cat = paper_catalog(0.5)
    eng = DetectionEngine(
        detect_fn=make_cascade_detect_fn(videos, frame_of, cat),
        catalog=cat, n_replicas=2, roi=True, roi_bounds=(640, 480),
        device="cpu")
    rs, _ = _ranges(lambda: eng.serve(frames))
    roi, det = _named(rs, "roi"), _named(rs, "detect")
    assert roi
    assert all(any(_inside(d, [r]) for d in det) for r in roi)
    assert len(det) > len(roi)


def test_token_serve_has_every_range_and_keeps_its_tokens():
    eng = _llm_engine()
    plain = eng.serve(_requests())
    rs, traced = _ranges(lambda: eng.serve(_requests()))
    assert [r.tokens.tolist() for r in traced["responses"]] == \
        [r.tokens.tolist() for r in plain["responses"]]
    assert {n for n, _, _ in rs} - {"gc"} == LLM_SPANS
    # one prefill a request, one decode and one read a token (no
    # synchronize on the CPU)
    assert len(_named(rs, "llm.prefill")) == 2
    assert len(_named(rs, "llm.decode")) == len(_named(rs, "llm.read")) == 8


def test_moe_layers_open_a_range_and_their_router_one_inside_it():
    """An MoE model's serve (deepseek-v3's smoke preset: 1 MoE layer)
    opens one ``repro.moe`` range a layer call and one ``repro.moe.route``
    inside each, in the prefill and in every decode step alike."""
    eng = ServingEngine(get_config("deepseek-v3-671b", preset="smoke"),
                        n_replicas=2, cache_len=32, device="cpu")
    eng.warmup(6)
    plain = eng.serve(_requests())
    rs, traced = _ranges(lambda: eng.serve(_requests()))
    assert [r.tokens.tolist() for r in traced["responses"]] == \
        [r.tokens.tolist() for r in plain["responses"]]
    assert {n for n, _, _ in rs} - {"gc"} == LLM_SPANS | {"moe",
                                                         "moe.route"}
    moes, routes = _named(rs, "moe"), _named(rs, "moe.route")
    assert len(moes) == len(routes) == 2 + 8    # 2 prefills, 8 steps
    assert all(_inside(r, moes) for r in routes)
    steps = _named(rs, "llm.prefill") + _named(rs, "llm.decode")
    assert all(_inside(m, steps) for m in moes)


def test_one_token_requests_make_one_decode_range_each():
    eng = _llm_engine()
    rs, rep = _ranges(lambda: eng.serve(_requests(n_out=(1, 1, 1))))
    assert [len(r.tokens) for r in rep["responses"]] == [1, 1, 1]
    assert len(_named(rs, "llm.prefill")) == \
        len(_named(rs, "llm.decode")) == 3


def test_each_collection_is_a_range_while_a_profiler_runs():
    def work():
        gc.collect()
        gc.collect(0)

    rs, _ = _ranges(work)
    assert len(_named(rs, "gc")) >= 2
    assert all(a <= b for _, a, b in rs)


def test_no_range_opens_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"a range {name} opened with no profiler")
    monkeypatch.setattr(trace_mod, "_range", refuse)
    _nvr_serve()
    _llm_engine().serve(_requests())
    gc.collect()
    with span("detect"):
        pass
    assert Timed("detect").stop() >= 0


def test_stage_walls_are_read_inside_their_ranges():
    """``stage_ms_detect`` and ``stage_ms_track`` are the readings of the
    ``detect`` and ``track`` timers, taken inside their ranges: one
    sample a range, each no longer than its range."""
    rec = TraceRecorder()
    rs, _ = _ranges(lambda: _nvr_serve(rec))
    for stage in ("detect", "track"):
        spans = _named(rs, stage)
        got = [v for _, v in rec.series[f"stage_ms_{stage}/0"]]
        assert len(got) == len(spans)
        assert all(0 <= v <= (b - a) / 1e6 + 1e-3
                   for v, (a, b) in zip(got, spans))


def test_trace_module_doctests():
    res = doctest.testmod(trace_mod)
    assert res.attempted >= 2 and res.failed == 0
