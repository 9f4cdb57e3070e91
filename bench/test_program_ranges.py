"""CPU tests of the readers of the program's own ranges (``ranges.py``,
``metrics/runtime_ms_per_frame.py``, ``track_tick_ms.py``,
``decode_enqueue_ms.py``, ``decode_device_ms.py``, ``decode_wait_ms.py``,
``prefill_enqueue_ms.py``, ``gc_ms_per_s.py``).

A traced window here is a CPU ``torch.profiler`` over a small serve of
the cell's system, with the harness's ``bench.window`` range and its
wrappers, read by the harness's own ``TraceReading``; device events are
stand-ins (the CPU has none), placed where a test needs them."""
import gc
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bench import harness, ranges, traffic
from bench.systems import nvr as sys_nvr
from bench.trace import Spans, TraceReading

NVR = ("runtime_ms_per_frame", "track_tick_ms", "gc_ms_per_s.nvr")
LLM = ("decode_enqueue_ms", "decode_device_ms", "decode_wait_ms",
       "prefill_enqueue_ms", "gc_ms_per_s.decode", "gc_ms_per_s.prefill")


class _Event:
    """A profiler event as ``TraceReading`` reads one."""

    def __init__(self, t0, t1, name, cuda, cid=0, tid=0):
        self._a, self._b, self._n = t0, t1, name
        self._cuda, self._cid, self._tid = cuda, cid, tid

    def name(self):
        return self._n

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def correlation_id(self):
        return self._cid

    def start_thread_id(self):
        return self._tid


def _window(work):
    """The host events of ``work()`` run inside the harness's window
    range under a CPU profiler."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("bench.window"):
            work()
    return list(prof.profiler.kineto_results.events())


def _reading(events, extra=()):
    """``TraceReading`` over ``events`` plus ``extra``, with a stand-in
    kernel at each edge of the window (a reading needs device events)."""
    w = next(e for e in events if e.name() == "bench.window")
    a, b = w.start_ns(), w.start_ns() + w.duration_ns()
    edges = [_Event(a, a + 1, "kernel", True, -1),
             _Event(b - 1, b, "kernel", True, -2)]
    return TraceReading(list(events) + edges + list(extra))


@pytest.fixture(scope="module")
def nvr():
    """nvr16-detect cut to 4 cameras, two epochs, with the harness's
    wrappers on and one forced collection in the window."""
    _, _, cfg, mix = harness.cell_of("nvr16-detect")
    mix = dict(mix, cameras=4, pool_frames=20,
               engine=dict(mix["engine"], micro_batch=4))
    cams = traffic.Cameras(mix, 5, cfg["detector"]["image_size"])
    cpu = torch.device("cpu")
    engine = sys_nvr.make_engine(
        cfg, mix, sys_nvr.make_source(cfg, cams, 5, cpu), cpu)
    spans = Spans(cpu)
    spans.wrap(engine, "_detect_batch", "bench.detect")
    spans.wrap(engine, "_interpolate", "bench.track")
    feed = sys_nvr.Feed(cams, engine, mix)

    def work():
        feed.epoch()
        gc.collect()
        feed.epoch()

    events = _window(work)
    spans.unwrap()
    return SimpleNamespace(mix=mix, config=cfg), events, feed


@pytest.fixture(scope="module")
def llm():
    from repro_torch.configs import get_config
    from repro_torch.serving import Request, ServingEngine
    eng = ServingEngine(get_config("qwen3-4b", preset="smoke"),
                        cache_len=32, device="cpu")
    eng.warmup(6)
    reqs = [Request(i, np.arange(6, dtype=np.int32) + i, 4)
            for i in range(3)]

    def work():
        eng.serve(reqs)
        gc.collect()

    return SimpleNamespace(mix={}, config={}), _window(work)


def _read(name, ctx, reading):
    return harness.load_reader(name)(ctx, {"trace": reading})


def test_nvr_readers_read_the_programs_ranges(nvr):
    ctx, events, feed = nvr
    t = _reading(events)
    got = {n: _read(n, ctx, t) for n in NVR}
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got
    ingests = ranges.named(t, ("repro.runtime.ingest",))
    assert len(ingests) == feed.k == 20
    ticks = ranges.named(t, ("repro.track.tick",))
    assert len(ticks) == 20
    assert got["track_tick_ms"] == pytest.approx(
        sum(b - a for a, b in ticks) / 20 / 1e6)
    # the runtime's share excludes everything under detect and track
    outer = ranges.named(t, ("repro.runtime.ingest", "repro.runtime.batch",
                             "repro.runtime.epoch"))
    inner = ranges.named(t, ("bench.detect", "bench.track"))
    assert ranges.measure(inner) > 0
    assert got["runtime_ms_per_frame"] * 1e6 * 80 == pytest.approx(
        ranges.minus(outer, inner))
    assert got["runtime_ms_per_frame"] * 1e6 * 80 < ranges.measure(outer)


def test_llm_readers_read_the_programs_ranges(llm):
    ctx, events = llm
    decode = [e for e in events if e.name() == "repro.llm.decode"]
    assert len(decode) == 12
    # a stand-in launch inside the first step, and its 2 us kernel
    d = decode[0]
    launch = _Event(d.start_ns() + 1, d.start_ns() + 2, "cudaLaunchKernel",
                    False, cid=77, tid=d.start_thread_id())
    w = next(e for e in events if e.name() == "bench.window")
    kernel = _Event(w.start_ns() + 10, w.start_ns() + 2010, "gemm", True,
                    cid=77)
    t = _reading(events, [launch, kernel])
    got = {n: _read(n, ctx, t) for n in LLM}
    assert all(isinstance(v, float) for v in got.values()), got
    assert got["decode_enqueue_ms"] == pytest.approx(
        sum(e.duration_ns() for e in decode) / 12 / 1e6)
    assert got["decode_device_ms"] == pytest.approx(2e-3 / 12)
    reads = [e for e in events if e.name() == "repro.llm.read"]
    assert len(reads) == 12
    assert got["decode_wait_ms"] == pytest.approx(
        sum(e.duration_ns() for e in reads) / 12 / 1e6)
    prefills = [e for e in events if e.name() == "repro.llm.prefill"]
    assert len(prefills) == 3
    assert got["prefill_enqueue_ms"] == pytest.approx(
        sum(e.duration_ns() for e in prefills) / 3 / 1e6)
    assert got["gc_ms_per_s.decode"] == got["gc_ms_per_s.prefill"] > 0


def test_readers_read_nothing_where_the_program_has_no_ranges(nvr, llm):
    """A program without spans (the parent commit) leaves no
    ``repro.`` range: every reader returns None and none raises."""
    for (ctx, events, *_), names in ((nvr, NVR), (llm, LLM)):
        t = _reading([e for e in events
                      if not e.name().startswith("repro.")])
        assert {n: _read(n, ctx, t) for n in names} == dict.fromkeys(names)


def test_gc_before_the_programs_first_range_is_left_out(nvr):
    """The harness's own ``gc.collect()`` between the profiler's start
    and the first epoch (``open_window`` in an NVR run) is not read."""
    ctx, events, _ = nvr
    t = _reading(events)
    first = min(a for a, b, n, *_ in t.cpu
                if n.startswith("repro.") and n != "repro.gc")
    early = _Event(t.w0 + 5, first - 5, "repro.gc", False)
    t2 = _reading(events, [early])
    assert _read("gc_ms_per_s.nvr", ctx, t2) == \
        _read("gc_ms_per_s.nvr", ctx, t)


def test_program_ranges_are_not_device_time(nvr):
    """The program's ranges are host operations: the reading's device
    events are the stand-in kernels alone, so the busy time, the busy
    share and the device ops do not move."""
    _, events, _ = nvr
    t = _reading(events)
    assert ranges.named(t, ("repro.detect",))
    assert [d[2] for d in t.device] == ["kernel", "kernel"]
    assert t.busy_s == 2e-9
    assert [n for n, _ in t.top_ops()] == ["kernel"]


def test_idle_gaps_name_a_gap_by_the_program_span_around_it():
    events = _window(_sleep_in_a_span)
    gaps = _reading(events).idle_gaps()
    assert gaps[0][0] == "harness/repro.runtime.epoch"


def _sleep_in_a_span():
    from repro_torch.obs.trace import span
    with span("runtime.epoch"):
        time.sleep(0.02)


def test_a_trace_0_run_builds_no_recorder(monkeypatch):
    """The ``--trace 0`` path builds its engine with no recorder, and no
    program range opens: the port's range constructor is never called."""
    from repro_torch.obs import trace as trace_mod
    from repro_torch.serving import DetectionEngine
    made = []
    real = DetectionEngine.__init__

    def init(self, *a, **kw):
        made.append(kw.get("recorder"))
        real(self, *a, **kw)

    def refuse(name):
        raise AssertionError(f"range {name} opened in a --trace 0 run")
    monkeypatch.setattr(DetectionEngine, "__init__", init)
    monkeypatch.setattr(trace_mod, "_range", refuse)
    small = lambda m: dict(m, cameras=4, pool_frames=20, warmup_epochs=1,
                           sample_frames=32,
                           engine=dict(m["engine"], micro_batch=4))
    res = harness.run_cell("nvr16-detect", 81, 0.2, False, "cpu",
                           time.perf_counter(), mix_override=small)
    assert res["correct"], res["compared"]
    assert made == [None]
