"""The port's always-on serving (``repro_torch.serving.events``,
``repro_torch.launch.daemon``, ``repro_torch.launch.serve``) against the
JAX package, on the CPU.

* Event bus: on the oracle serves of ``test_torch_obs.py`` (single
  engine, sharded with faults under ``Watchdog``, the cascade with the
  ROI pass), each built with ``recorder=bus.recorder()`` in both
  packages, the per-topic ``bus.counts`` and the ``JsonlSink`` lines are
  equal to the reference's, string for string; every recorded event is
  published once, shard views (``_TapShardView``) included; an unknown
  topic raises.
* Daemon (mirroring ``tests/test_runtime.py``): the virtual-clock run of
  a rebalancing sharded engine drains to the port's one-shot batch
  report exactly and to the reference daemon's report (the reference
  tests' ``assert_reports_match``: discrete fields exact, the Kalman
  floats of interpolated responses within rtol 1e-5 + atol 1e-4), for
  chunks of 1, 3 and 7 frames; a graceful stop drains what was
  ingested; the clocks; the CLI with ``--device cpu`` prints the
  reference CLI's lines and writes its JSONL byte for byte.
* ``launch.serve --payload frames --device cpu`` prints the reference
  launcher's lines for the proxy oracle and the cascade
  (``--models fast,heavy --roi``) and writes a trace that both trace
  checkers pass; ``--spmd`` serves the mini-SSD on a mesh of ``cpu``
  devices with an audited trace.
"""
import io
import json
import sys

import pytest

from repro.core import proxy_detect_fn_streams as jproxy
from repro.launch import daemon as jdaemon
from repro.launch import serve as jserve
from repro.serving import EventBus as JBus
from repro.serving import JsonlSink as JSink
from repro.serving import ServingRuntime as JRuntime
from repro.serving import ShardedDetectionEngine as JSharded
from repro.serving import make_nvr_streams as jstreams
from repro_torch.core import proxy_detect_fn_streams as tproxy
from repro_torch.launch import daemon as tdaemon
from repro_torch.launch import serve as tserve
from repro_torch.launch.daemon import ServingDaemon, VirtualClock, WallClock
from repro_torch.obs import audit_recorder
from repro_torch.serving import DetectionEngine as TEngine
from repro_torch.serving import EventBus, JsonlSink, ServingRuntime
from repro_torch.serving import ShardedDetectionEngine as TSharded
from repro_torch.serving import make_nvr_streams as tstreams
from repro_torch.serving import topic_of
from repro_torch.serving.events import TOPICS, TapRecorder, _TapShardView
from test_sharded_serving import assert_reports_identical
from test_torch_obs import J, SERVES, T, _load_tool
from test_torch_serving import assert_reports_match


def _bus_serve(pkg, Bus, Sink, case):
    bus = Bus()
    buf = io.StringIO()
    sink = Sink(buf)
    bus.subscribe(sink)
    rec = bus.recorder()
    SERVES[case](pkg, rec)
    return bus, buf.getvalue().splitlines(), rec


@pytest.mark.parametrize("case", sorted(SERVES))
def test_bus_counts_and_jsonl_equal_reference(case):
    jbus, jlines, _ = _bus_serve(J, JBus, JSink, case)
    tbus, tlines, trec = _bus_serve(T, EventBus, JsonlSink, case)
    assert tbus.counts == jbus.counts
    assert tlines == jlines
    # every recorded event published exactly once, shard events included
    assert sum(tbus.counts.values()) == len(trec.events) == len(tlines)
    assert set(tbus.counts) <= set(TOPICS)
    lines = [json.loads(s) for s in tlines]
    assert all(ln["topic"] == topic_of(ln["kind"]) for ln in lines)
    if case == "sharded-faults":
        assert any("shard" in ln for ln in lines)
    assert audit_recorder(trec).ok    # the tapped log is still the log


def test_tap_shard_views_publish_and_unknown_topics_raise():
    bus = EventBus()
    got = []
    h = bus.subscribe(lambda t, e: got.append((t, e["kind"], e["shard"])),
                      topics=("drop", "fault"))
    rec = bus.recorder()
    assert isinstance(rec, TapRecorder)
    view = rec.shard_view(2)
    assert isinstance(view, _TapShardView)
    view.record("drop", 1.0, rid=3)
    view.shard_view(4).record("shard_down", 2.0)
    view.record("arrive", 0.5, rid=4)            # lifecycle: not routed
    assert got == [("drop", "drop", 2), ("fault", "shard_down", 4)]
    assert bus.counts == {"drop": 1, "fault": 1, "lifecycle": 1}
    assert [e["i"] for e in rec.events] == [0, 1, 2]
    bus.unsubscribe(h)
    bus.publish({"kind": "drop", "t": 0.0, "shard": 0})
    assert len(got) == 2
    with pytest.raises(ValueError, match="unknown topics"):
        bus.subscribe(lambda *a: None, topics=("nope",))
    assert topic_of("some_future_kind") == "lifecycle"


# --------------------------------------------------------------- daemon
def _sharded(pkg, rec=None):
    frames, frame_of, videos, dets = pkg["streams"](4, 8, rate=2.0)
    kw = dict(detect_fn=pkg["proxy"](videos, dets, frame_of), n_shards=2,
              n_replicas=2, service_time=0.3, track_and_interpolate=True,
              rebalance=True, epoch_s=2.0, **pkg["kw"])
    if rec is not None:
        kw["recorder"] = rec
    return sorted(frames, key=lambda f: f.t_arrival), kw


JPKG = dict(streams=jstreams, proxy=jproxy, kw={}, Sharded=JSharded,
            Runtime=JRuntime, Daemon=jdaemon.ServingDaemon,
            Clock=jdaemon.VirtualClock)
TPKG = dict(streams=tstreams, proxy=tproxy, kw={"device": "cpu"},
            Sharded=TSharded, Runtime=ServingRuntime, Daemon=ServingDaemon,
            Clock=VirtualClock)


@pytest.mark.parametrize("chunk", [1, 3, 7])
def test_daemon_virtual_clock_matches_batch_and_reference(chunk):
    out = {}
    for name, pkg in (("ref", JPKG), ("port", TPKG)):
        frames, kw = _sharded(pkg)
        eng = pkg["Sharded"](**kw)
        daemon = pkg["Daemon"](pkg["Runtime"](eng, streams=range(4)),
                               clock=pkg["Clock"](), chunk=chunk)
        out[name] = daemon.run(frames)
        assert daemon.frames_ingested == len(frames)
        assert daemon.runtime.frames_pending == 0
    frames, kw = _sharded(TPKG)
    base = TSharded(**kw).serve(frames)
    assert_reports_identical(base, out["port"])
    assert_reports_match(out["ref"], out["port"])
    assert out["port"]["migrations"] == out["ref"]["migrations"]


class _BehindClock:
    """A clock far ahead of the trace, as a ``WallClock`` reads on a host
    that fell behind it: it never sleeps, and ``now()`` is past every
    arrival."""

    def now(self):
        return 1e6

    def sleep_until(self, t):
        pass


@pytest.mark.parametrize("chunk", [1, 3])
def test_daemon_behind_the_clock_matches_batch(chunk):
    """A daemon whose clock ran ahead still serves the batch report: it
    never advances past a frame it has not ingested."""
    frames, kw = _sharded(TPKG)
    daemon = ServingDaemon(ServingRuntime(TSharded(**kw), streams=range(4)),
                           clock=_BehindClock(), chunk=chunk)
    out = daemon.run(frames)
    assert_reports_identical(TSharded(**kw).serve(frames), out)


def test_daemon_audits_clean_with_the_bus():
    bus = EventBus()
    rec = bus.recorder()
    frames, kw = _sharded(TPKG, rec)
    daemon = ServingDaemon(ServingRuntime(TSharded(**kw), streams=range(4)),
                           clock=VirtualClock(), chunk=3)
    daemon.run(frames)
    res = audit_recorder(rec)
    assert res.ok, res.violations[:3]
    assert res.stats["arrive"] == len(frames)
    assert bus.counts.get("detection", 0) > 0
    assert sum(bus.counts.values()) == len(rec.events)


def test_daemon_graceful_stop_drains_ingested_frames():
    frames, frame_of, videos, dets = tstreams(3, 8, rate=4.0)
    frames = sorted(frames, key=lambda f: f.t_arrival)
    rt = ServingRuntime(TEngine(detect_fn=tproxy(videos, dets, frame_of),
                                n_replicas=2, service_time=0.3,
                                track_and_interpolate=True, device="cpu"))
    daemon = ServingDaemon(rt, clock=VirtualClock(), chunk=2)

    def feed():
        for k, f in enumerate(frames):
            if k == 10:
                daemon.request_stop()
            yield f

    out = daemon.run(feed())
    n = daemon.frames_ingested
    assert 0 < n <= 10
    assert rt.frames_pending == 0     # in-flight frames were drained
    accounted = {r.rid for r in out["responses"]} | set(out["dropped"])
    assert accounted == {f.rid for f in frames[:n]}


def test_clocks():
    c = VirtualClock()
    assert c.now() == 0.0
    c.sleep_until(2.5)
    c.sleep_until(1.0)                # never goes backwards
    assert c.now() == 2.5
    w = WallClock()
    t0 = w.now()
    w.sleep_until(t0 - 1.0)           # already past: returns immediately
    assert w.now() >= t0
    w.sleep_until(w.now() + 0.01)
    assert w.now() >= t0 + 0.01
    frames, kw = _sharded(TPKG)
    with pytest.raises(ValueError):
        ServingDaemon(ServingRuntime(TSharded(**kw)), chunk=0)


@pytest.mark.parametrize("extra", [[], ["--watchdog"], ["--rebalance",
                                                        "--chunk", "5"]])
def test_daemon_cli_prints_the_reference_lines(tmp_path, capsys, extra):
    argv = ["--cameras", "3", "--frames", "6", "--shards", "2",
            "--clock", "virtual", "--chunk", "2"] + extra
    jdaemon.main(argv + ["--events", str(tmp_path / "j.jsonl")])
    want = capsys.readouterr().out.replace("j.jsonl", "X.jsonl")
    tdaemon.main(argv + ["--events", str(tmp_path / "t.jsonl"),
                         "--device", "cpu"])
    got = capsys.readouterr().out.replace("t.jsonl", "X.jsonl")
    assert got == want
    assert "audit=ok" in got and "pending=0" in got
    assert (tmp_path / "t.jsonl").read_bytes() == \
        (tmp_path / "j.jsonl").read_bytes()


# ------------------------------------------------------ serve --payload
def _ref_serve(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    return capsys.readouterr().out


@pytest.mark.parametrize("extra", [[], ["--models", "fast,heavy", "--roi"]],
                         ids=["proxy", "cascade"])
def test_serve_frames_prints_the_reference_lines(tmp_path, monkeypatch,
                                                 capsys, extra):
    argv = ["--payload", "frames", "--shards", "2", "--cameras", "3",
            "--frames", "8"] + extra
    want = _ref_serve(monkeypatch, capsys,
                      argv + ["--trace", str(tmp_path / "j.json")])
    tserve.main(argv + ["--trace", str(tmp_path / "t.json"),
                        "--device", "cpu"])
    got = capsys.readouterr().out
    assert got.replace("t.json", "X") == want.replace("j.json", "X")
    assert "audit=ok" in got
    for tool in ("check_trace_torch", "check_trace"):
        assert _load_tool(tool).main([str(tmp_path / "t.json")]) == 0
    capsys.readouterr()


def test_serve_frames_spmd_on_a_mesh_of_cpu_devices(tmp_path, capsys):
    """The reference's mesh path needs as many XLA devices as shards; the
    port's mesh is ``("cpu", "cpu")``: the real mini-SSD, its micro-
    batches split over the two entries."""
    assert tserve.serving_mesh(2, "cpu") == ("cpu", "cpu")
    path = tmp_path / "spmd.json"
    tserve.main(["--payload", "frames", "--shards", "2", "--cameras", "2",
                 "--frames", "3", "--spmd", "--device", "cpu",
                 "--trace", str(path)])
    out = capsys.readouterr().out
    assert "spmd=True" in out and "coverage=1.000" in out
    assert "audit=ok" in out
    assert _load_tool("check_trace_torch").main([str(path)]) == 0
    capsys.readouterr()
