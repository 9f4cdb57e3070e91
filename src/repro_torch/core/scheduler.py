"""Parallel detection scheduling algorithms (paper §III-C).

All schedulers operate on a deterministic virtual clock (the simulator in
``simulator.py`` drives them with arrival events).  Semantics calibrated to
the paper's measurements:

* LockstepRR — the paper's Round-Robin: the thread pool dispatches one
  frame per model per round and joins the round before starting the next
  (this is what makes heterogeneous RR degrade to n x min(mu): Table VII
  shows 8 x 0.4 ≈ 3.4 FPS for slow-CPU + 7 NCS2).  Frames arriving while
  all round slots are taken are dropped.
* WeightedRR — static weights ∝ configured device rates (compile-time).
* FCFS — work-conserving: a frame goes to the first available executor
  (each executor holds at most one queued frame, i.e. the frame currently
  being transferred); throughput approaches Σ mu_i (Table VII: 29 FPS for
  fast-CPU + 7 NCS2 vs 20.1 for RR).
* Proportional — performance-aware: WeightedRR whose weights are
  re-derived every ``update_period`` rounds from EWMA-measured service
  times (handles runtime drift the static WRR cannot).

A host-dispatch serialization term models the paper's Table X language
study: Python's GIL serializes pre/post-processing (h ≈ 102 ms/frame caps
the pipeline at ~9.8 FPS no matter how many sticks); the C++ thread pool
has h ≈ 2 ms and scales.

Failure detection (``serving.faults`` integration)
--------------------------------------------------
Executors may carry a ``faults`` attribute (a
``serving.faults.ReplicaFaultView``); when present, ``_dispatch``
applies the timeout rule a real dispatcher uses — a dispatch whose
completion would exceed ``timeout_k x 1/mu_effective`` (or whose
executor dies before finishing) marks the executor *suspect*: its
``healthy`` flag drops, the in-flight frame is retried once (bounded by
``max_retries``) on the least-busy healthy executor at the detection
time, and the ``retries`` / ``failovers`` / ``frames_lost`` counters
record the outcome per executor.  Assign paths skip unhealthy
executors; ``probe_health`` restores one whose fault view says it came
back.  Executors WITHOUT a fault view (the default everywhere) never
enter any of this machinery, so the fault-free virtual timeline is
bit-identical to the pre-fault scheduler.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from .executor import DetectorExecutor
from ..obs.trace import NULL_RECORDER


@dataclass
class Assignment:
    frame_idx: int
    executor_idx: int
    t_start: float
    t_done: float


class NoHealthyExecutorError(RuntimeError):
    """Raised by ``blocking_assign`` when no executor can EVER accept the
    frame — an empty pool, or every member marked unhealthy with no
    fault view promising a comeback.  Blocking dispatch means "wait
    until the policy can take it"; with nothing to wait FOR, failing
    fast beats committing the frame to a replica that will never run
    it (the all-replicas-dead hang)."""


class _Base:
    def __init__(self, executors: List[DetectorExecutor],
                 host_overhead: float = 0.001, sync_overhead: float = 0.005,
                 timeout_k: float = 4.0, max_retries: int = 1):
        self.executors = executors
        self.host_overhead = host_overhead
        self.sync_overhead = sync_overhead
        self.host_free_at = 0.0
        # failure-detection state (inert unless an executor carries a
        # ``faults`` view — see the module docstring)
        self.timeout_k = timeout_k
        self.max_retries = max_retries
        self.healthy = [True] * len(executors)
        self.retries: dict = {}       # executor idx -> suspected dispatches
        self.failovers: dict = {}     # executor idx -> frames rescued
        self.frames_lost: dict = {}   # executor idx -> frames not rescued
        # observability: the owning engine swaps in its TraceRecorder
        # (or shard view); the no-op default adds one attribute read per
        # dispatch and keeps the virtual timeline untouched
        self.recorder = NULL_RECORDER

    @property
    def n(self):
        return len(self.executors)

    # ------------------------------------------------------------- health
    def any_healthy(self) -> bool:
        return any(self.healthy)

    def fault_counts(self) -> dict:
        """Snapshot of the cumulative failure counters (copies, so the
        engine can diff per-serve deltas across warm-started calls)."""
        return {"retries": dict(self.retries),
                "failovers": dict(self.failovers),
                "frames_lost": dict(self.frames_lost)}

    def probe_health(self, t: float):
        """Restore suspects whose fault view says they came back: alive
        at ``t`` and not degraded past the timeout rule (a replica
        slowed by >= timeout_k would be re-suspected on its first
        dispatch, so leaving it out keeps the pool from thrashing)."""
        for j, ex in enumerate(self.executors):
            if not self.healthy[j]:
                view = getattr(ex, "faults", None)
                if view is not None and view.alive(t) \
                        and view.factor(t) < self.timeout_k:
                    self.healthy[j] = True
                    if self.recorder.enabled:
                        self.recorder.record("health_restore", t, replica=j)
                    self._pool_changed()

    def sync_pool(self):
        """Re-size health/round state after the caller changed pool
        MEMBERSHIP (the supervisor's replica lending appends/pops at
        the tail of ``executors``).  New members start healthy."""
        n = len(self.executors)
        if len(self.healthy) < n:
            self.healthy += [True] * (n - len(self.healthy))
        else:
            del self.healthy[n:]
        self._pool_changed()

    def _pool_changed(self):
        """Hook for round-based subclasses to rebuild their slot state
        when pool membership or health changes."""

    def _dispatch(self, ex_idx: int, frame_idx: int, t: float,
                  _attempt: int = 0) -> Optional[Assignment]:
        # executor identified by index — callers pick executors by index,
        # so dispatch is O(1) instead of an O(n) ``executors.index`` scan
        ex = self.executors[ex_idx]
        # host dispatch is serialized (GIL / thread-pool handoff)
        t = max(t, self.host_free_at)
        self.host_free_at = t + self.host_overhead
        t_start = max(t, ex.busy_until)
        # service evaluated at t_start so injected faults (slowdowns /
        # deaths) see the time the work actually runs, not arrival time
        service = ex.service_time(t=t_start) * (1 + self.sync_overhead)
        view = getattr(ex, "faults", None)
        if view is not None:
            # timeout detection: the dispatcher cannot see "dead" — it
            # sees a completion that never arrives within k x the
            # expected service.  An infinite service (killed replica), a
            # completion beyond the timeout (degraded mu), or a kill
            # striking mid-service all fire the same detector.
            expected = self.timeout_k / ex.mu_effective
            failed = (not np.isfinite(service) or service > expected
                      or not view.alive_through(t_start, t_start + service))
            if failed:
                t_detect = t_start + expected
                ex.busy_until = t_detect    # the slot is held until the
                self.healthy[ex_idx] = False  # timeout fires
                self.retries[ex_idx] = self.retries.get(ex_idx, 0) + 1
                if self.recorder.enabled:
                    self.recorder.record("retry", t_detect, rid=frame_idx,
                                         replica=ex_idx, attempt=_attempt)
                    self.recorder.record("health_mark", t_detect,
                                         replica=ex_idx)
                self._pool_changed()
                live = [i for i in range(self.n) if self.healthy[i]]
                if _attempt >= self.max_retries or not live:
                    self.frames_lost[ex_idx] = \
                        self.frames_lost.get(ex_idx, 0) + 1
                    if self.recorder.enabled:
                        self.recorder.record("lost", t_detect,
                                             rid=frame_idx, replica=ex_idx)
                    return None
                j = min(live, key=lambda i: self.executors[i].busy_until)
                a = self._dispatch(j, frame_idx, t_detect,
                                   _attempt=_attempt + 1)
                if a is not None:
                    # a dead retry chain is already charged to the LAST
                    # failing executor, so only rescues count here
                    self.failovers[ex_idx] = \
                        self.failovers.get(ex_idx, 0) + 1
                    if self.recorder.enabled:
                        self.recorder.record("failover", t_detect,
                                             rid=frame_idx, replica=ex_idx,
                                             to=a.executor_idx)
                return a
        t_done = t_start + service
        ex.busy_until = t_done
        ex.record(service)
        if self.recorder.enabled:
            self.recorder.record("dispatch", t_start, rid=frame_idx,
                                 replica=ex_idx)
            self.recorder.record("complete", t_done, rid=frame_idx,
                                 replica=ex_idx, t0=t_start,
                                 service=service)
        return Assignment(frame_idx, ex_idx, t_start, t_done)

    def assign(self, frame_idx: int, t: float) -> Optional[Assignment]:
        raise NotImplementedError

    def reset(self):
        """Clear per-serve dispatch state (the executors are owned by the
        caller and reset separately).  Subclasses extend this with their
        round bookkeeping so repeated ``serve()`` calls start from the
        same virtual-clock origin."""
        self.host_free_at = 0.0
        self.healthy = [True] * len(self.executors)
        self.retries = {}
        self.failovers = {}
        self.frames_lost = {}

    def backlog(self, t: float) -> float:
        """Residual committed work at virtual time ``t``: the summed
        seconds of already-dispatched service that extend past ``t``
        across all executors.  This is the load signal the sharded
        serving layer's work-stealing policy and the watchdog consume —
        0.0 means every executor would be idle at ``t``.

        Only executors that have DISPATCHED something count: an
        untouched executor's ``busy_until`` of 0.0 is a clock origin,
        not a commitment, so probing with ``t < 0`` (or before the
        first arrival) must read zero backlog rather than ``-n x t``."""
        return float(sum(max(0.0, e.busy_until - t)
                         for e in self.executors if e.n_processed > 0))

    def blocking_assign(self, frame_idx: int,
                        t: float = 0.0) -> Optional[Assignment]:
        """Zero-drop dispatch: the frame waits (buffered) until this
        scheduler's policy can take it (no earlier than arrival ``t``).
        FCFS default: first healthy executor to free up.  Raises
        ``NoHealthyExecutorError`` when nothing can ever take the frame
        (empty pool / every member dead); returns ``None`` only when a
        fault strikes mid-dispatch and the bounded retry is exhausted."""
        self.probe_health(t)
        self._require_healthy()
        live = [i for i in range(self.n) if self.healthy[i]]
        j = min(live, key=lambda i: self.executors[i].busy_until)
        return self._dispatch(j, frame_idx,
                              max(self.executors[j].busy_until, t))

    def _require_healthy(self):
        if not self.executors:
            raise NoHealthyExecutorError(
                "blocking_assign on an empty executor pool: there is "
                "nothing to wait for — construct the scheduler with at "
                "least one executor")
        if not self.any_healthy():
            raise NoHealthyExecutorError(
                f"all {self.n} executors are marked unhealthy and none "
                "is scheduled to come back: a blocking dispatch would "
                "hang forever (use drop mode for degraded operation, or "
                "revive a replica in the FaultSchedule)")


class FCFSScheduler(_Base):
    """First-come-first-serve: first available executor; one in-flight +
    one queued frame per executor; drop if every slot is full."""

    def assign(self, frame_idx, t):
        # first available executor; while all are busy, any executor with a
        # free single queued-frame slot (the frame being transferred while
        # the previous one computes) keeps the pipeline work-conserving.
        # Unhealthy (suspected-dead) executors are invisible to both scans.
        self.probe_health(t)
        free = [i for i, e in enumerate(self.executors)
                if self.healthy[i] and e.busy_until <= t]
        if free:
            return self._dispatch(
                min(free, key=lambda i: self.executors[i].busy_until),
                frame_idx, t)
        open_q = [i for i, e in enumerate(self.executors)
                  if self.healthy[i]
                  and e.busy_until - t <= 1.0 / e.mu_effective]
        if open_q:
            return self._dispatch(
                min(open_q, key=lambda i: self.executors[i].busy_until),
                frame_idx, t)
        return None


class LockstepRRScheduler(_Base):
    """Paper's RR: strict order, one frame per model per round, round
    barrier = all models done."""

    def __init__(self, executors, **kw):
        super().__init__(executors, **kw)
        self.rr_idx = 0
        self.round_barrier = 0.0

    def reset(self):
        super().reset()
        self.rr_idx = 0
        self.round_barrier = 0.0

    def _skip_unhealthy(self):
        """Advance ``rr_idx`` past suspected-dead slots (at most one lap)
        so one dead device does not sentence the whole strict-order
        stream; returns False when no healthy slot exists."""
        for _ in range(self.n):
            if self.healthy[self.rr_idx]:
                return True
            self.rr_idx = (self.rr_idx + 1) % self.n
            if self.rr_idx == 0:
                self.round_barrier = max(e.busy_until
                                         for e in self.executors)
        return False

    def assign(self, frame_idx, t):
        self.probe_health(t)
        if not self._skip_unhealthy():
            return None                      # every slot dead -> drop
        ex = self.executors[self.rr_idx]
        # the frame for this slot must wait for the round barrier
        t_eff = max(t, self.round_barrier)
        if ex.busy_until > t:
            return None                      # slot still busy -> drop
        a = self._dispatch(self.rr_idx, frame_idx, t_eff)
        self.rr_idx = (self.rr_idx + 1) % self.n
        if self.rr_idx == 0:                 # round complete: set barrier
            self.round_barrier = max(e.busy_until for e in self.executors)
        return a

    def blocking_assign(self, frame_idx, t: float = 0.0):
        self.probe_health(t)
        self._require_healthy()
        self._skip_unhealthy()
        ex = self.executors[self.rr_idx]
        a = self._dispatch(self.rr_idx, frame_idx, max(self.round_barrier,
                                                       ex.busy_until, t))
        self.rr_idx = (self.rr_idx + 1) % self.n
        if self.rr_idx == 0:
            self.round_barrier = max(e.busy_until for e in self.executors)
        return a

    def _pool_changed(self):
        if self.n:
            self.rr_idx %= self.n


class WeightedRRScheduler(_Base):
    """Static weighted RR: executor j takes w_j consecutive slots per
    round, w ∝ configured device rate."""

    def __init__(self, executors, weights=None, **kw):
        super().__init__(executors, **kw)
        self.weights = weights or self._default_weights()
        self._init_weights = list(self.weights)
        self._slots = self._expand()
        self.slot_idx = 0
        self.round_barrier = 0.0
        self._round_done = 0.0           # latest t_done in the open round
        self.rounds_completed = 0        # counts skip-crossings too

    def reset(self):
        super().reset()
        self.weights = list(self._init_weights)
        self._slots = self._expand()
        self.slot_idx = 0
        self.round_barrier = 0.0
        self._round_done = 0.0
        self.rounds_completed = 0

    def _default_weights(self):
        mus = np.array([e.mu_effective for e in self.executors])
        return np.maximum(1, np.round(mus / mus.min())).astype(int).tolist()

    def _expand(self):
        # smooth (interleaved) weighted round-robin: spreading each
        # executor's slots avoids head-of-line blocking in the strict-order
        # dispatcher (a run of consecutive slots on a busy device would
        # stall dispatch for every executor behind it).  Executor j's k-th
        # slot sits at fractional round position (k + phase_j) / w_j;
        # same-weight executors get distinct sub-phases, which fixes the
        # old expansion's weight-1 clump (every weight-1 executor landed on
        # the same 0.5 key, so [4,1,1,1,1] expanded to the head-of-line
        # block [0,0,1,2,3,4,0,0] instead of [0,1,0,2,0,3,0,4]).
        # A weight of 0 (dead or lent-away replica) simply contributes no
        # slots: the round renormalizes over the live executors.  The old
        # expansion let a zero weight poison the whole round — with
        # weights like [1, 0], min(w)=0 < wmax=1 but NO emitted slot had
        # w[j] < wmax, so the rotation's next() raised StopIteration.
        w = [int(x) for x in self.weights]
        live = [j for j, x in enumerate(w) if x > 0]
        if not live:
            return []
        group = {wj: [j for j in live if w[j] == wj]
                 for wj in set(w[j] for j in live)}
        keyed = []
        for j in live:
            wj = w[j]
            phase = (group[wj].index(j) + 0.5) / len(group[wj])
            keyed += [((k + phase) / wj, j) for k in range(wj)]
        slots = [j for _, j in sorted(keyed, key=lambda x: x[0])]
        # rotate the (cyclic, rotation-invariant) sequence so the round
        # opens with a lighter executor: the blocking dispatcher waits for
        # each slot's device in strict order, so lighter (slower) devices
        # dispatched first overlap their long service with the heavy
        # device's burst instead of queueing behind it
        wmax = max(w[j] for j in live)
        if min(w[j] for j in live) < wmax:
            start = next(i for i, j in enumerate(slots) if w[j] < wmax)
            slots = slots[start:] + slots[:start]
        return slots

    def assign(self, frame_idx, t):
        # a backlogged slot is SKIPPED (it forfeits this turn), not a
        # drop sentence for the whole stream: the old code returned None
        # without advancing slot_idx, so one backlogged executor at the
        # head slot dropped every subsequent arrival until its backlog
        # cleared, no matter how idle the other devices were.  The frame
        # is only dropped when every slot in the round is backlogged.
        # The round barrier is the latest t_done dispatched WITHIN the
        # round (equal to the old max-busy_until rule when nothing is
        # skipped, but immune to a skipped executor's stale backlog).
        self.probe_health(t)
        nslots = len(self._slots)
        barrier, round_done = self.round_barrier, self._round_done
        rounds = 0                       # edges crossed, incl. by skips
        for k in range(nslots):
            idx = (self.slot_idx + k) % nslots
            if idx == 0 and k > 0:       # the scan crossed a round edge
                barrier, round_done, rounds = round_done, 0.0, rounds + 1
            j = self._slots[idx]
            ex = self.executors[j]
            if not self.healthy[j]:
                continue                 # suspected dead -> skip its slot
            if ex.busy_until > t + 1.0 / ex.mu_effective:
                continue                 # slot backlog -> try next slot
            a = self._dispatch(j, frame_idx, max(t, barrier))
            if a is not None:
                round_done = max(round_done, a.t_done)
            self.slot_idx = (idx + 1) % nslots
            if self.slot_idx == 0:
                barrier, round_done, rounds = round_done, 0.0, rounds + 1
            self.round_barrier, self._round_done = barrier, round_done
            self.rounds_completed += rounds
            return a
        # every slot backlogged -> drop.  The scan still visited one full
        # round of slots, so the bookkeeping it accumulated is NOT thrown
        # away (the old code did, so ``rounds_completed`` undercounted and
        # ``ProportionalScheduler`` froze its reweighting clock under
        # exactly the total-backlog condition it exists to fix).  When the
        # scan started at slot 0 the wrap edge sits at its end and was
        # never crossed mid-scan; count it here so a failed full scan
        # always closes exactly one round.
        if self.slot_idx == 0:
            barrier, round_done, rounds = round_done, 0.0, rounds + 1
        self.round_barrier, self._round_done = barrier, round_done
        self.rounds_completed += rounds
        return None

    def blocking_assign(self, frame_idx, t: float = 0.0):
        self.probe_health(t)
        self._require_healthy()
        if not self._slots:
            raise NoHealthyExecutorError(
                "every WRR weight is zero: the round has no slots to "
                "wait on (renormalize the weights or revive a replica)")
        nslots = len(self._slots)
        # scan from the round cursor for the first healthy slot — a dead
        # slot forfeits its turn exactly like the drop-mode scan, and the
        # round edges crossed by skipping still close their rounds
        for k in range(nslots):
            idx = (self.slot_idx + k) % nslots
            if idx == 0 and k > 0:
                self.round_barrier, self._round_done = self._round_done, 0.0
                self.rounds_completed += 1
            j = self._slots[idx]
            if not self.healthy[j]:
                continue
            ex = self.executors[j]
            a = self._dispatch(j, frame_idx, max(self.round_barrier,
                                                 ex.busy_until, t))
            if a is not None:
                self._round_done = max(self._round_done, a.t_done)
            self.slot_idx = (idx + 1) % nslots
            if self.slot_idx == 0:
                self.round_barrier, self._round_done = self._round_done, 0.0
                self.rounds_completed += 1
            return a
        raise NoHealthyExecutorError(
            "every executor with a nonzero WRR weight is unhealthy: "
            "nothing in the round can ever take the frame")

    def _pool_changed(self):
        # pool membership changed (replica lending): renormalize the
        # weight vector to the new length (guests join at weight 1) and
        # rebuild the round.  Health-only changes leave the round state
        # alone — unhealthy executors are skipped by the scans instead.
        if len(self.weights) != self.n:
            ext = [1] * max(0, self.n - len(self.weights))
            self.weights = [int(x) for x in self.weights[:self.n]] + ext
            self._init_weights = list(self._init_weights[:self.n]) + ext
            self._slots = self._expand()
            self.slot_idx = 0


class ProportionalScheduler(WeightedRRScheduler):
    """Performance-aware proportional: re-derive weights from measured EWMA
    service times every ``update_period`` completed rounds."""

    def __init__(self, executors, update_period: int = 4, **kw):
        super().__init__(executors, weights=[1] * len(executors), **kw)
        self.update_period = update_period
        self._last_refresh = 0           # rounds_completed at last refresh

    def reset(self):
        super().reset()
        self._last_refresh = 0

    def _maybe_refresh(self):
        # keyed off rounds_completed (which also counts rounds closed by
        # skip-crossings) rather than slot_idx == 0: a round that ends
        # because the scan skipped past the wrap point — exactly the
        # backlogged-device case this policy exists for — still advances
        # the reweighting clock
        if self.rounds_completed - self._last_refresh >= self.update_period:
            self._last_refresh = self.rounds_completed
            self._refresh_weights()

    def assign(self, frame_idx, t):
        # refresh even when the frame is dropped: a failed scan closes a
        # round too (see WeightedRRScheduler.assign), and the reweighting
        # clock must keep ticking under sustained total backlog — that is
        # the drift condition the policy exists to correct
        a = super().assign(frame_idx, t)
        self._maybe_refresh()
        return a

    def blocking_assign(self, frame_idx, t: float = 0.0):
        a = super().blocking_assign(frame_idx, t)
        self._maybe_refresh()
        return a

    def _refresh_weights(self):
        # explicit None check: an EWMA of 0.0 (zero-cost oracle executor)
        # is a real measurement, not "no data" — `ewma or fallback` used
        # to silently fall back to the configured mu here
        ts = np.array([1.0 / e.mu_effective if e.ewma_service is None
                       else e.ewma_service for e in self.executors])
        rates = 1.0 / np.maximum(ts, 1e-9)
        # an unhealthy (suspected-dead) executor gets weight 0 and the
        # round renormalizes over the live rates — its stale EWMA must
        # not anchor rates.min() either, or every live weight inflates
        alive = np.array(self.healthy[:len(rates)], bool)
        if alive.any():
            w = np.zeros(len(rates), int)
            w[alive] = np.maximum(
                1, np.round(rates[alive] / rates[alive].min())).astype(int)
            self.weights = w.tolist()
        else:
            self.weights = np.maximum(1, np.round(rates / rates.min())) \
                .astype(int).tolist()
        self._slots = self._expand()
        self.slot_idx = 0


def make_scheduler(kind: str, executors, **kw):
    return {
        "rr": LockstepRRScheduler,
        "wrr": WeightedRRScheduler,
        "fcfs": FCFSScheduler,
        "proportional": ProportionalScheduler,
    }[kind](executors, **kw)
