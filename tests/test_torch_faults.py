"""Fault injection and supervision on the port (``repro_torch.serving.
faults``, ``.supervisor`` and the engines' ``faults=``) against the JAX
package, on the CPU and the oracle path (numpy proxy detector, pinned
service times): the fault model draws, folds and cursor transitions
equal the reference's, and every fault-injected serve gives the
reference's report key for key (``assert_reports_match``: discrete
fields exact, only the Kalman floats of ``interpolated`` responses
within rtol 1e-5 + atol 1e-4), its ``faults``, ``recovered_coverage``,
``migrations`` and drops included."""
import dataclasses

import numpy as np
import pytest

from repro.core import proxy_detect_fn_streams as jproxy
from repro.serving import DetectionEngine as JEngine
from repro.serving import FaultEvent as JEvent
from repro.serving import FaultSchedule as JSchedule
from repro.serving import FrameRequest as JFrame
from repro.serving import ShardedDetectionEngine as JSharded
from repro.serving import ShardFaultCursor as JCursor
from repro.serving import Watchdog as JWatchdog
from repro.serving import make_nvr_streams as jstreams
from repro_torch.core import proxy_detect_fn_streams as tproxy
from repro_torch.serving import DetectionEngine as TEngine
from repro_torch.serving import FaultEvent as TEvent
from repro_torch.serving import FaultSchedule as TSchedule
from repro_torch.serving import FrameRequest as TFrame
from repro_torch.serving import ShardedDetectionEngine as TSharded
from repro_torch.serving import ShardFaultCursor as TCursor
from repro_torch.serving import Watchdog as TWatchdog
from repro_torch.serving import make_nvr_streams as tstreams
from test_torch_serving import assert_reports_match

pytestmark = pytest.mark.chaos

J = dict(Event=JEvent, Schedule=JSchedule, Engine=JEngine,
         Sharded=JSharded, Watchdog=JWatchdog, streams=jstreams,
         proxy=jproxy, Frame=JFrame, kw={})
T = dict(Event=TEvent, Schedule=TSchedule, Engine=TEngine,
         Sharded=TSharded, Watchdog=TWatchdog, streams=tstreams,
         proxy=tproxy, Frame=TFrame, kw={"device": "cpu"})


def events(schedule):
    return [dataclasses.astuple(e) for e in schedule]


def both(build):
    """``build(pkg)`` for the reference and the port."""
    return build(J), build(T)


# ------------------------------------------------------ the fault model
def test_fault_event_validation_matches_reference():
    bad = [dict(t=1.0, kind="explode", replica=0), dict(t=1.0, kind="kill"),
           dict(t=1.0, kind="shard_kill", replica=0),
           dict(t=1.0, kind="slow", replica=0, factor=0.5)]
    for kw in bad:
        for Event in (JEvent, TEvent):
            with pytest.raises(ValueError):
                Event(**kw)


@pytest.mark.parametrize("seed", [0, 3, 7, 11])
def test_random_schedule_matches_reference(seed):
    kw = dict(n_shards=3, n_replicas=4, n_replica_events=5,
              n_shard_events=2, max_factor=6.0)
    j = JSchedule.random(seed, 10.0, **kw)
    t = TSchedule.random(seed, 10.0, **kw)
    assert events(t) == events(j) and len(t) == len(j)
    assert t.last_event_t == j.last_event_t
    assert t.has_shard_events == j.has_shard_events
    combined = t + TSchedule.replica_kill(2.0, replica=1, revive_t=4.0)
    assert events(combined) == events(
        j + JSchedule.replica_kill(2.0, replica=1, revive_t=4.0))
    assert not TSchedule() and len(TSchedule()) == 0


@pytest.mark.parametrize("seed", [1, 2, 5])
def test_replica_views_fold_like_reference(seed):
    j = JSchedule.random(seed, 8.0, n_shards=2, n_replicas=3,
                         n_replica_events=6)
    t = TSchedule.random(seed, 8.0, n_shards=2, n_replicas=3,
                         n_replica_events=6)
    ts = np.linspace(-0.5, 8.5, 61)
    for shard in range(2):
        for rep in range(3):
            jv, tv = j.view(shard, rep), t.view(shard, rep)
            assert events(tv.events) == events(jv.events)
            for a in ts:
                assert tv.alive(a) == jv.alive(a)
                assert tv.factor(a) == jv.factor(a)
                for b in (a + 0.1, a + 1.3):
                    assert tv.alive_through(a, b) == jv.alive_through(a, b)


@pytest.mark.parametrize("seed", [0, 4, 9])
def test_shard_cursor_transitions_match_reference(seed):
    """Both cursors driven through the same epoch grid, restarting where
    a coin says so: every ``begin_epoch``, ``is_down`` and ``restart``
    answer equal."""
    kw = dict(n_shards=2, n_replicas=2, n_replica_events=0,
              n_shard_events=3)
    j = JSchedule.random(seed, 20.0, **kw) + JSchedule.shard_kill(
        5.0, shard=1, permanent=True)
    t = TSchedule.random(seed, 20.0, **kw) + TSchedule.shard_kill(
        5.0, shard=1, permanent=True)
    jc, tc = JCursor(j, 2), TCursor(t, 2)
    coin = np.random.default_rng(seed)
    for e in range(12):
        ws, we = 2.0 * e, 2.0 * (e + 1)
        for h in range(2):
            assert tc.begin_epoch(h, ws, we) == jc.begin_epoch(h, ws, we)
            assert tc.is_down(h) == jc.is_down(h)
            if tc.is_down(h) and coin.random() < 0.5:
                assert tc.restart(h, we) == jc.restart(h, we)


# --------------------------------------------------------- engine level
def nvr_engine(pkg, sched_of, n=16, **kw):
    frames, frame_of, videos, dets = pkg["streams"](2, n, rate=4.0)
    eng = pkg["Engine"](detect_fn=pkg["proxy"](videos, dets, frame_of),
                        n_replicas=2, service_time=0.05,
                        faults=sched_of(pkg["Schedule"]), **kw, **pkg["kw"])
    return eng, frames


ENGINE_CASES = {
    "kill": (lambda S: S.replica_kill(0.5, replica=1), {}),
    "kill-track": (lambda S: S.replica_kill(0.5, replica=1),
                   {"track_and_interpolate": True}),
    "all-dead": (lambda S: S.replica_kill(0.2, replica=0)
                 + S.replica_kill(0.2, replica=1), {}),
    "slow-revive": (lambda S: S.replica_slowdown(0.3, replica=0, factor=3.0,
                                                 until=2.0)
                    + S.replica_kill(1.0, replica=1, revive_t=2.5),
                    {"drop_when_busy": True}),
    "empty": (lambda S: S(), {}),
}


@pytest.mark.parametrize("case", sorted(ENGINE_CASES))
def test_engine_fault_serve_matches_reference(case):
    sched_of, kw = ENGINE_CASES[case]
    (je, jf), (te, tf) = both(lambda p: nvr_engine(p, sched_of, **kw))
    base, port = je.serve(jf), te.serve(tf)
    assert_reports_match(base, port)
    if case != "empty":
        assert port["retries"] or port["frames_lost"]
    else:
        assert te.faults is None
        assert all(r.faults is None for r in te.replicas)
    assert_reports_match(port, te.serve(tf))          # replays identically


# -------------------------------------------------------- sharded chaos
def sharded_nvr(pkg, n_frames=24, **kw):
    frames, frame_of, videos, dets = pkg["streams"](4, n_frames, rate=4.0)
    eng = pkg["Sharded"](detect_fn=pkg["proxy"](videos, dets, frame_of),
                         n_replicas=2, service_time=0.02, n_shards=2,
                         rebalance=True, epoch_s=2.0,
                         track_and_interpolate=True, **kw, **pkg["kw"])
    return eng, frames


SHARD_CASES = {
    "kill-watchdog": (lambda S: S.shard_kill(2.5, shard=0), True),
    "permanent": (lambda S: S.shard_kill(2.5, shard=0, permanent=True),
                  True),
    "unsupervised": (lambda S: S.shard_kill(2.5, shard=0, revive_t=4.5),
                     False),
    "shard-and-replica": (lambda S: S.shard_kill(2.5, shard=1)
                          + S.replica_kill(1.0, replica=0, shard=0,
                                           revive_t=3.0), True),
    "seeded-chaos": (lambda S: S.random(3, 6.0, n_shards=2, n_replicas=2,
                                        n_replica_events=2,
                                        n_shard_events=1), True),
}


@pytest.mark.parametrize("case", sorted(SHARD_CASES))
def test_sharded_fault_serve_matches_reference(case):
    sched_of, supervised = SHARD_CASES[case]

    def build(pkg):
        sup = pkg["Watchdog"]() if supervised else None
        return sharded_nvr(pkg, faults=sched_of(pkg["Schedule"]),
                           supervisor=sup)

    (je, jf), (te, tf) = both(build)
    base, port = je.serve(jf), te.serve(tf)
    assert port["faults"]["frames_lost_shard"] > 0
    for k in ("faults", "recovered_coverage", "migrations", "dropped"):
        assert port[k] == base[k], k
    assert_reports_match(base, port)
    assert all(len(e.replicas) == 2 for e in te.engines)
    assert_reports_match(port, te.serve(tf))          # replays identically


def hot_stream_trace(Frame):
    """One 30 fps camera on shard 0, one 1 fps camera on shard 1 (the
    reference tests' single-hot-stream trace)."""
    evs = sorted([(k / 30.0, 0, k) for k in range(240)]
                 + [(k + 0.5, 1, k) for k in range(8)])
    return [Frame(rid, np.zeros((4, 4, 3), np.float32), t, stream_id=s)
            for rid, (t, s, k) in enumerate(evs)]


def stub_detect(images, rids=None):
    b = len(images)
    return (np.zeros((b, 4, 4), np.float32), np.zeros((b, 4), np.float32),
            np.zeros((b, 4), np.int32), np.zeros((b, 4), bool))


@pytest.mark.parametrize("lend", [True, False])
def test_replica_lending_matches_reference(lend):
    def build(pkg):
        sup = pkg["Watchdog"](lend=lend, idle_backlog_s=0.5)
        eng = pkg["Sharded"](detect_fn=stub_detect, n_replicas=2,
                             service_time=0.1, drop_when_busy=True,
                             micro_batch=1, max_micro_batch=1, n_shards=2,
                             rebalance=True, epoch_s=2.0, supervisor=sup,
                             **pkg["kw"])
        return eng, hot_stream_trace(pkg["Frame"])

    (je, jf), (te, tf) = both(build)
    base, port = je.serve(jf), te.serve(tf)
    assert port["faults"] == base["faults"]
    assert bool(port["faults"]["loans"]) == lend
    assert_reports_match(base, port)
    assert all(len(e.replicas) == 2 for e in te.engines)


def test_shard_events_need_the_epoch_loop():
    with pytest.raises(ValueError, match="rebalance"):
        TSharded(detect_fn=stub_detect, n_shards=2, device="cpu",
                 faults=TSchedule.shard_kill(1.0, shard=0))
    with pytest.raises(ValueError, match="supervisor"):
        TSharded(detect_fn=stub_detect, n_shards=2, device="cpu",
                 supervisor=TWatchdog())
    TSharded(detect_fn=stub_detect, n_shards=2, device="cpu",
             faults=TSchedule.replica_kill(1.0, replica=0))
