"""Deterministic fault injection for the serving stack (a copy of the
reference package's ``serving/faults.py``, pure numpy: the same seed
draws the same schedule).

The serving layers (``DetectionEngine`` replicas, the sharded epoch
loop) run on a *virtual* clock, so faults are virtual-time events too:
a ``FaultSchedule`` is a sorted, immutable list of ``FaultEvent``s that
the engines fold into the clock exactly like arrivals.  Nothing here is
random at injection time — a schedule (optionally generated from a seed
by ``FaultSchedule.random``) replays bit-identically on every serve, so
every recovery behaviour is a regression-testable function of
``(trace, schedule)``.

Failure domains (matching the serving stack's layers):

* **replica** — one executor of one shard's pool.  ``slow`` degrades
  its service rate by ``factor`` (the paper's mu degradation: a stick
  on a throttled USB hub), ``kill`` makes it stop completing work
  (service time becomes infinite), ``revive`` brings it back clean
  (factor reset to 1).  Injected into ``ReplicaExecutor.service_time``
  via a per-replica ``ReplicaFaultView``; *detected* by the scheduler's
  timeout rule (``core.scheduler``), because a real dispatcher never
  observes "dead", only "did not come back in k x the expected time".
* **shard** — a whole host of ``ShardedDetectionEngine``.
  ``shard_kill`` makes the shard lose every frame arriving while it is
  down (and stop heartbeating); ``shard_revive`` is the schedule-driven
  self-recovery, and the watchdog's ``restart`` is the supervised one.
  Folded into the epoch loop by ``ShardFaultCursor``.

Boundary quantization
---------------------
Shard recovery (revive or watchdog restart) takes effect only at epoch
boundaries, while kills take effect immediately.  That asymmetry is
deliberate: within one epoch a shard is up for a *prefix* of the window
and down for the *suffix*, so the frames a stream loses are a
contiguous suffix of its epoch arrivals — which is exactly the property
that lets the epoch loop advance the per-stream ``seq`` floors past
lost frames without corrupting the arrival-index bookkeeping
``core.quality.evaluate_streams`` keys on.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

REPLICA_KINDS = ("slow", "kill", "revive")
SHARD_KINDS = ("shard_kill", "shard_revive")
KINDS = REPLICA_KINDS + SHARD_KINDS


@dataclass(frozen=True)
class FaultEvent:
    """One virtual-time fault.

    ``t`` is virtual seconds on the serving clock.  Replica-level kinds
    (``slow``/``kill``/``revive``) require ``replica``; shard-level
    kinds (``shard_kill``/``shard_revive``) forbid it.  ``factor`` is
    the service-time multiplier of a ``slow`` event (>= 1: a factor of
    4 quarters the replica's effective mu).  ``permanent`` marks a
    ``shard_kill`` the watchdog cannot repair (restart returns failure
    and the shard stays down) — the evacuation path must carry the
    recovery alone."""
    t: float
    kind: str
    shard: int = 0
    replica: Optional[int] = None
    factor: float = 1.0
    permanent: bool = False

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if self.kind in REPLICA_KINDS and self.replica is None:
            raise ValueError(f"{self.kind!r} is a replica-level fault: "
                             "it requires replica=")
        if self.kind in SHARD_KINDS and self.replica is not None:
            raise ValueError(f"{self.kind!r} is a shard-level fault: "
                             "replica= must be None")
        if self.kind == "slow" and self.factor < 1.0:
            raise ValueError("slow events degrade service: factor must "
                             f"be >= 1.0, got {self.factor}")


@dataclass(frozen=True)
class ReplicaFaultView:
    """One replica's slice of a ``FaultSchedule`` — the object
    ``ReplicaExecutor.faults`` holds.  Pure fold over the (sorted)
    events, so reading it never mutates anything and two replicas of
    the same schedule always agree."""
    events: Tuple[FaultEvent, ...] = ()

    def alive(self, t: float) -> bool:
        """Is the replica up at virtual time ``t``? (kill/revive fold)"""
        up = True
        for e in self.events:
            if e.t > t:
                break
            if e.kind == "kill":
                up = False
            elif e.kind == "revive":
                up = True
        return up

    def alive_through(self, t0: float, t1: float) -> bool:
        """Does an in-flight frame dispatched over ``[t0, t1]`` survive?
        Requires the replica up at ``t0`` and no kill striking inside
        ``(t0, t1]`` — a kill+revive blip inside the window still loses
        the frame that was on the device."""
        if not self.alive(t0):
            return False
        return not any(e.kind == "kill" and t0 < e.t <= t1
                       for e in self.events)

    def factor(self, t: float) -> float:
        """Service-time multiplier at ``t``: the latest ``slow`` factor,
        reset to 1.0 by ``revive`` (a revived replica comes back
        clean)."""
        f = 1.0
        for e in self.events:
            if e.t > t:
                break
            if e.kind == "slow":
                f = e.factor
            elif e.kind == "revive":
                f = 1.0
        return f


class FaultSchedule:
    """Immutable, sorted collection of ``FaultEvent``s.

    Falsy when empty — every injection site in the serving stack gates
    on truthiness, so ``FaultSchedule()`` (or ``faults=None``) keeps the
    fault-free paths bit-identical to an engine built without a
    schedule.

    >>> s = FaultSchedule.replica_kill(1.0, replica=1, revive_t=3.0)
    >>> [e.kind for e in s]
    ['kill', 'revive']
    >>> bool(FaultSchedule())
    False
    """

    def __init__(self, events: Iterable[FaultEvent] = ()):
        evs = list(events)
        # total order (time, shard, replica, kind rank): schedules built
        # from the same event set compare and replay identically no
        # matter the construction order
        evs.sort(key=lambda e: (e.t, e.shard,
                                -1 if e.replica is None else e.replica,
                                KINDS.index(e.kind)))
        self.events: Tuple[FaultEvent, ...] = tuple(evs)

    def __bool__(self) -> bool:
        return bool(self.events)

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self):
        return iter(self.events)

    @property
    def has_shard_events(self) -> bool:
        return any(e.kind in SHARD_KINDS for e in self.events)

    @property
    def last_event_t(self) -> float:
        """Virtual time of the last scheduled event (0.0 when empty) —
        the anchor the sharded report's ``recovered_coverage`` window
        starts after."""
        return self.events[-1].t if self.events else 0.0

    def replica_events(self, shard: int, replica: int) -> List[FaultEvent]:
        return [e for e in self.events if e.kind in REPLICA_KINDS
                and e.shard == shard and e.replica == replica]

    def shard_events(self, shard: int) -> List[FaultEvent]:
        return [e for e in self.events if e.kind in SHARD_KINDS
                and e.shard == shard]

    def view(self, shard: int, replica: int) -> ReplicaFaultView:
        """The per-replica fold ``ReplicaExecutor.faults`` consumes."""
        return ReplicaFaultView(tuple(self.replica_events(shard, replica)))

    # -------------------------------------------------- convenience ctors
    @classmethod
    def replica_kill(cls, t: float, replica: int, shard: int = 0,
                     revive_t: Optional[float] = None) -> "FaultSchedule":
        evs = [FaultEvent(t, "kill", shard=shard, replica=replica)]
        if revive_t is not None:
            evs.append(FaultEvent(revive_t, "revive", shard=shard,
                                  replica=replica))
        return cls(evs)

    @classmethod
    def replica_slowdown(cls, t: float, replica: int, factor: float,
                         shard: int = 0,
                         until: Optional[float] = None) -> "FaultSchedule":
        evs = [FaultEvent(t, "slow", shard=shard, replica=replica,
                          factor=factor)]
        if until is not None:
            evs.append(FaultEvent(until, "slow", shard=shard,
                                  replica=replica, factor=1.0))
        return cls(evs)

    @classmethod
    def shard_kill(cls, t: float, shard: int,
                   revive_t: Optional[float] = None,
                   permanent: bool = False) -> "FaultSchedule":
        evs = [FaultEvent(t, "shard_kill", shard=shard,
                          permanent=permanent)]
        if revive_t is not None:
            evs.append(FaultEvent(revive_t, "shard_revive", shard=shard))
        return cls(evs)

    def __add__(self, other: "FaultSchedule") -> "FaultSchedule":
        return FaultSchedule(self.events + tuple(other))

    @classmethod
    def random(cls, seed: int, horizon_s: float, n_shards: int = 1,
               n_replicas: int = 4, n_replica_events: int = 3,
               n_shard_events: int = 0,
               max_factor: float = 8.0) -> "FaultSchedule":
        """Seeded chaos generator: ``n_replica_events`` slow/kill events
        on random replicas (each kill paired with a revive half way to
        the horizon) plus ``n_shard_events`` shard kills (each paired
        with a revive).  Same seed => same schedule => bit-identical
        serve, which is what makes chaos tests assertable."""
        rng = np.random.default_rng(seed)
        evs: List[FaultEvent] = []
        for _ in range(n_replica_events):
            t = float(rng.uniform(0.05, 0.75) * horizon_s)
            shard = int(rng.integers(n_shards))
            replica = int(rng.integers(n_replicas))
            if rng.random() < 0.5:
                evs.append(FaultEvent(t, "slow", shard=shard,
                                      replica=replica,
                                      factor=float(rng.uniform(
                                          2.0, max_factor))))
            else:
                evs.append(FaultEvent(t, "kill", shard=shard,
                                      replica=replica))
                evs.append(FaultEvent(
                    t + 0.5 * (horizon_s - t), "revive", shard=shard,
                    replica=replica))
        for _ in range(n_shard_events):
            t = float(rng.uniform(0.05, 0.6) * horizon_s)
            shard = int(rng.integers(n_shards))
            evs.append(FaultEvent(t, "shard_kill", shard=shard))
            evs.append(FaultEvent(t + 0.5 * (horizon_s - t),
                                  "shard_revive", shard=shard))
        return cls(evs)


class ShardFaultCursor:
    """Stateful fold of a schedule's shard-level events over the epoch
    loop, one instance per ``serve`` call (so repeated serves replay
    identically).

    ``begin_epoch(h, ws, we)`` is called once per (epoch, shard) in
    epoch order: it first consumes every event with ``t <= ws`` (the
    boundary fold — this is where revives and watchdog restarts take
    effect), then *peeks* for the first mid-window kill without
    consuming it, so the next boundary fold still sees the kill and can
    reconcile it against any restart the watchdog issued in between.
    Returns the virtual time the shard goes (or already is) down within
    the window, or ``None`` if it is up throughout.

    Kills are immediate; recovery is boundary-quantized (see the module
    docstring for why that keeps seq floors exact).
    """

    def __init__(self, schedule: FaultSchedule, n_shards: int):
        self._events: Dict[int, List[FaultEvent]] = {
            h: schedule.shard_events(h) for h in range(n_shards)}
        self._ptr = {h: 0 for h in range(n_shards)}
        self._down_since: Dict[int, Optional[float]] = {
            h: None for h in range(n_shards)}
        self._permanent = {h: False for h in range(n_shards)}
        self._restarts: Dict[int, List[float]] = {
            h: [] for h in range(n_shards)}

    def begin_epoch(self, h: int, window_start: float,
                    window_end: float) -> Optional[float]:
        evs, p = self._events[h], self._ptr[h]
        while p < len(evs) and evs[p].t <= window_start:
            e = evs[p]
            if e.kind == "shard_kill":
                if e.permanent:
                    self._down_since[h] = e.t
                    self._permanent[h] = True
                elif not any(r >= e.t for r in self._restarts[h]):
                    # no watchdog restart repaired this kill yet
                    self._down_since[h] = e.t
            else:                            # shard_revive
                if not self._permanent[h]:
                    self._down_since[h] = None
            p += 1
        self._ptr[h] = p
        if self._down_since[h] is not None:
            return self._down_since[h]       # down entering the window
        for e in evs[p:]:                    # peek, do not consume
            if e.t >= window_end:
                break
            if e.kind == "shard_kill":
                self._down_since[h] = e.t
                self._permanent[h] = self._permanent[h] or e.permanent
                return e.t
            # a mid-window revive is deferred to the next boundary fold
        return None

    def is_down(self, h: int) -> bool:
        return self._down_since[h] is not None

    def restart(self, h: int, t_boundary: float) -> bool:
        """Watchdog repair at an epoch boundary.  Returns ``False`` when
        the shard's kill was permanent (the restart is refused and the
        shard stays down — evacuation must carry the recovery)."""
        self._restarts[h].append(t_boundary)
        if self._permanent[h]:
            return False
        self._down_since[h] = None
        return True
