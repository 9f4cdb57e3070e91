"""The port's trace audit and Perfetto export (``repro_torch.obs.audit``,
``repro_torch.obs.export``) against the JAX package, on the CPU.

Inputs are oracle serves of both packages (numpy proxy detectors, pinned
service times), each with its own ``TraceRecorder``:

* ``single``: one ``DetectionEngine`` with the tracker, in the drop
  regime (interpolated frames);
* ``sharded-faults``: two rebalancing shards, a shard kill and a replica
  kill under ``Watchdog`` (lost frames, retries, a restart, migrations);
* ``cascade``: the transprecise cascade with the ROI second pass (model
  switches, ``roi_pass`` events).

On each the port's event list equals the reference's exactly (every
field of every event, in code order), and so do the sampled series but
the host wall times (``stage_ms_*``: equal sample times, the values are
each package's own measurement); ``audit_events`` gives equal
``ok``, violations and stats; ``to_chrome_trace`` gives the same JSON
document; ``events_from_chrome`` gives back the raw events.  The audit's
negative cases of the reference tests (a vanished frame, a double emit,
an emit-time regression, a dispatch to a dead replica, loans never or
not LIFO returned) are caught by the port's audit with the reference's
violations, and ``tools/check_trace_torch.py`` prints the reference
tool's lines and exit codes on the same files.
"""
import functools
import importlib.util
import json
from pathlib import Path

import pytest

from repro.core import proxy_detect_fn_streams as jproxy
from repro.obs import TraceRecorder as JRecorder
from repro.obs import audit as jaudit
from repro.obs import export as jexport
from repro.serving import DetectionEngine as JEngine
from repro.serving import FaultSchedule as JSchedule
from repro.serving import ShardedDetectionEngine as JSharded
from repro.serving import Watchdog as JWatchdog
from repro.serving import make_cascade_detect_fn as jcascade_fn
from repro.serving import make_nvr_streams as jstreams
from repro.serving import paper_catalog as jpaper
from repro_torch.core import proxy_detect_fn_streams as tproxy
from repro_torch.obs import TraceRecorder as TRecorder
from repro_torch.obs import (audit_events, audit_recorder,
                             events_from_chrome, to_chrome_trace,
                             write_chrome_trace)
from repro_torch.serving import DetectionEngine as TEngine
from repro_torch.serving import FaultSchedule as TSchedule
from repro_torch.serving import ShardedDetectionEngine as TSharded
from repro_torch.serving import Watchdog as TWatchdog
from repro_torch.serving import make_cascade_detect_fn as tcascade_fn
from repro_torch.serving import make_nvr_streams as tstreams
from repro_torch.serving import paper_catalog as tpaper
from test_cascade import fast_videos
from test_torch_cascade import _port_videos, _trace

REPO = Path(__file__).resolve().parents[1]
J = dict(Engine=JEngine, Sharded=JSharded, Schedule=JSchedule,
         Watchdog=JWatchdog, streams=jstreams, proxy=jproxy,
         cascade_fn=jcascade_fn, paper=jpaper, Recorder=JRecorder, kw={})
T = dict(Engine=TEngine, Sharded=TSharded, Schedule=TSchedule,
         Watchdog=TWatchdog, streams=tstreams, proxy=tproxy,
         cascade_fn=tcascade_fn, paper=tpaper, Recorder=TRecorder,
         kw={"device": "cpu"})


def _single(pkg, rec):
    frames, frame_of, videos, dets = pkg["streams"](3, 12, rate=4.0)
    eng = pkg["Engine"](detect_fn=pkg["proxy"](videos, dets, frame_of),
                        n_replicas=1, service_time=0.4,
                        track_and_interpolate=True, recorder=rec,
                        **pkg["kw"])
    return eng.serve(frames)


def _sharded_faults(pkg, rec):
    frames, frame_of, videos, dets = pkg["streams"](4, 24, rate=4.0)
    S = pkg["Schedule"]
    faults = S.shard_kill(2.5, shard=1) + S.replica_kill(
        1.0, replica=0, shard=0, revive_t=3.0)
    eng = pkg["Sharded"](detect_fn=pkg["proxy"](videos, dets, frame_of),
                         n_replicas=2, service_time=0.02, n_shards=2,
                         rebalance=True, epoch_s=2.0,
                         track_and_interpolate=True, faults=faults,
                         supervisor=pkg["Watchdog"](), recorder=rec,
                         **pkg["kw"])
    return eng.serve(frames)


def _cascade(pkg, rec):
    jf, tf, frame_of = _trace("lull_burst_lull")
    videos = fast_videos()
    if pkg is T:
        videos, frames = _port_videos(videos), tf
    else:
        frames = jf
    cat = pkg["paper"](0.5)
    eng = pkg["Engine"](detect_fn=pkg["cascade_fn"](videos, frame_of, cat),
                        catalog=cat, n_replicas=2,
                        track_and_interpolate=True, roi=True,
                        roi_bounds=(640, 480), recorder=rec, **pkg["kw"])
    return eng.serve(frames)


SERVES = {"single": _single, "sharded-faults": _sharded_faults,
          "cascade": _cascade}


@functools.cache
def recorded(case):
    """(reference recorder, port recorder) of one serve, built once per
    process; read only."""
    recs = []
    for pkg in (J, T):
        rec = pkg["Recorder"]()
        SERVES[case](pkg, rec)
        recs.append(rec)
    return tuple(recs)


def _canon(obj):
    """A JSON-comparable form (tuples as lists, numpy scalars as
    numbers), as ``write_chrome_trace`` would write it."""
    return json.loads(json.dumps(obj, default=float))


@pytest.mark.parametrize("case", sorted(SERVES))
def test_events_equal_reference(case):
    jrec, trec = recorded(case)
    assert _canon(trec.events) == _canon(jrec.events)
    assert trec.series.keys() == jrec.series.keys()
    for k, pts in _canon(trec.series).items():
        want = _canon(jrec.series[k])
        if k.startswith("stage_ms_"):          # measured host wall
            assert [t for t, _ in pts] == [t for t, _ in want], k
        else:
            assert pts == want, k
    kinds = {e["kind"] for e in trec.events}
    want = {"single": {"drop", "interp_emit", "track_export"},
            "sharded-faults": {"shard_lost", "retry", "shard_restart",
                               "migrate", "track_import", "health_mark"},
            "cascade": {"model_switch", "roi_pass"}}[case]
    assert want <= kinds, want - kinds


@pytest.mark.parametrize("case", sorted(SERVES))
def test_audit_equals_reference(case):
    jrec, trec = recorded(case)
    want = jaudit.audit_recorder(jrec)
    got = audit_recorder(trec)
    assert got.ok and want.ok
    assert got.violations == want.violations
    assert got.stats == want.stats
    assert got.stats["arrive"] == got.stats["emitted"] + \
        got.stats["dropped_final"] + got.stats["shard_lost"]


@pytest.mark.parametrize("case", sorted(SERVES))
def test_chrome_export_equals_reference_and_round_trips(case, tmp_path):
    jrec, trec = recorded(case)
    doc = to_chrome_trace(trec.events, trec.series)
    # the events are equal (test above); the series carry each
    # package's own wall times, so both exports take the port's
    assert _canon(doc) == _canon(jexport.to_chrome_trace(jrec.events,
                                                         trec.series))
    spans = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    assert len(spans) == sum(e["kind"] == "complete" for e in trec.events)
    back = events_from_chrome(_canon(doc))
    assert sorted(back, key=lambda e: e["i"]) == _canon(trec.events)
    assert audit_events(back).stats == audit_recorder(trec).stats
    path = tmp_path / "trace.json"
    write_chrome_trace(str(path), trec)
    assert json.loads(path.read_text()) == _canon(doc)


# ------------------------------------------------------ negative cases
def _clean():
    return [dict(e) for e in recorded("single")[1].events]


def _vanished(ev):
    return [e for e in ev if not (e["kind"] == "emit" and e["rid"] == 0)]


def _double_emit(ev):
    dup = dict(next(e for e in ev if e["kind"] == "emit"))
    dup["i"] = len(ev)
    return ev + [dup]


def _emit_regression(ev):
    emits = [e for e in ev if e["kind"] in ("emit", "interp_emit")]
    emits[-1]["t"] = emits[0]["t"] - 1.0
    return ev


def _dead_dispatch(ev):
    disp = next(e for e in ev if e["kind"] == "dispatch")
    return [{"i": -1, "kind": "health_mark", "t": 0.0,
             "replica": disp["replica"]}] + ev


LOANS = [{"i": 0, "kind": "loan", "t": 1.0, "lender": 1, "borrower": 0,
          "guest": 2},
         {"i": 1, "kind": "loan", "t": 2.0, "lender": 3, "borrower": 0,
          "guest": 3}]
FIFO = [{"i": 2, "kind": "loan_return", "t": 3.0, "lender": 1,
         "borrower": 0, "guest": 2},
        {"i": 3, "kind": "loan_return", "t": 3.0, "lender": 3,
         "borrower": 0, "guest": 3}]

NEGATIVE = {
    "vanished-frame": (lambda: _vanished(_clean()), "frame_conservation",
                       None),
    "double-emit": (lambda: _double_emit(_clean()), "frame_conservation",
                    "terminal"),
    "emit-time-regression": (lambda: _emit_regression(_clean()),
                             "emit_monotonicity", "decreased"),
    "dead-replica-dispatch": (lambda: _dead_dispatch(_clean()),
                              "dead_replica_dispatch", None),
    "loans-never-returned": (lambda: [dict(e) for e in LOANS], "loan_lifo",
                             "never returned"),
    "loans-not-lifo": (lambda: [dict(e) for e in LOANS + FIFO],
                       "loan_lifo", "LIFO"),
}


@pytest.mark.parametrize("case", sorted(NEGATIVE))
def test_audit_catches_corrupted_traces_like_reference(case):
    make, rule, why = NEGATIVE[case]
    got, want = audit_events(make()), jaudit.audit_events(make())
    assert not got.ok
    assert any(v["rule"] == rule and (why is None or why in v.get("why", ""))
               for v in got.violations), got.violations
    assert _canon(got.violations) == _canon(want.violations)
    assert got.stats == want.stats


# ---------------------------------------------------------- the checker
def _load_tool(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_check_trace_torch_prints_the_reference_tools_lines(tmp_path,
                                                            capsys):
    """Both trace formats of a clean serve, a corrupted trace, a file
    that is no trace and a missing file: the same lines and exit codes
    from both tools."""
    trec = recorded("sharded-faults")[1]
    raw = tmp_path / "raw.json"
    raw.write_text(json.dumps(trec.to_json(), default=float))
    chrome = tmp_path / "chrome.json"
    write_chrome_trace(str(chrome), trec)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"events": _vanished(_clean())},
                              default=float))
    empty = tmp_path / "empty.json"
    empty.write_text(json.dumps({"events": []}))
    other = tmp_path / "other.json"
    other.write_text("[1, 2]")
    cases = [[raw, chrome], [bad], [empty], [other],
             [tmp_path / "missing.json"], []]
    port, ref = _load_tool("check_trace_torch"), _load_tool("check_trace")
    assert "repro_torch.obs" in port.audit_events.__module__
    for paths in cases:
        argv = [str(p) for p in paths]
        rc_port = port.main(argv)
        out_port = capsys.readouterr().out
        rc_ref = ref.main(argv)
        out_ref = capsys.readouterr().out
        assert rc_port == rc_ref, paths
        if paths:
            assert out_port == out_ref, paths
    assert port.main([str(raw), str(chrome)]) == 0
    assert port.main([str(bad)]) == 1
    capsys.readouterr()
