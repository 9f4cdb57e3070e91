"""Frame-lifecycle trace recording for the serving stack.

The serving engines run on a deterministic *virtual* clock, so a trace
is a deterministic artifact too: re-running the same ``(trace,
FaultSchedule)`` records the same events in the same order, which is
what makes traces regression-assertable (``repro.obs.audit``) and
diffable across PRs.

``TraceRecorder`` is an append-only event log plus named time series.
Every event is a plain dict — cheap to record on the hot path, trivially
JSON-serializable — with at least ``{"i", "kind", "t"}`` where ``i`` is
a monotonically increasing sequence number (the *code-order* tiebreak:
events recorded at equal virtual times sort stably) and ``t`` is virtual
seconds on the serving clock.  The full schema is documented in
``docs/OBSERVABILITY.md``; the kinds are:

frame lifecycle (recorded by ``DetectionEngine`` / ``ServingEngine``
and the schedulers):

* ``arrive``     — frame entered the serve trace (``rid``, ``stream``,
  ``seq``)
* ``enqueue``    — frame admitted to micro-batch ``batch``
* ``dispatch``   — scheduler committed the frame to ``replica`` at
  ``t_start`` (successful assignments only — a faulted attempt records
  ``retry`` instead)
* ``complete``   — service finished (``t0``/``service`` carry the span)
* ``retry`` / ``failover`` / ``lost`` — the scheduler's timeout
  detection outcomes (``core.scheduler``)
* ``drop``       — the engine dropped the frame at arrival
* ``emit`` / ``interp_emit`` — the per-stream reorder buffer released
  the frame (``interp_emit``: a tracker-coasted re-emission)
* ``model_switch`` — the transprecise cascade changed model at a
  micro-batch boundary (``batch``, ``model``); audited: the switch
  must precede every ``enqueue`` of its batch
* ``roi_pass``   — hierarchical second pass over one frame (``rid``,
  ``model``, ``n_rois``, ``px_full``/``px_roi``, the absolute ``rois``
  and ``bounds``, plus the final detections' ``det_extent``); audited
  for containment

control plane (recorded by ``ShardedDetectionEngine`` and ``Watchdog``):

* ``epoch``      — epoch-window boundary (``epoch``)
* ``migrate``    — stream migration (``stream``, ``src``, ``dst``)
* ``loan`` / ``loan_return`` — replica lending (``lender``,
  ``borrower``, ``guest`` = the guest's lane in the borrower's pool)
* ``health_mark`` / ``health_restore`` — a replica suspected dead by
  the timeout rule / restored by ``probe_health``
* ``shard_down`` / ``shard_restart`` — shard-level fault + watchdog
  repair; ``shard_lost`` accounts each frame a down shard lost

The DEFAULT recorder everywhere is ``NULL_RECORDER`` — a no-op whose
``enabled`` flag lets hot paths skip event construction entirely, so an
engine built without a recorder is bit-identical (same virtual clocks,
same report) to one that predates tracing.
"""
from __future__ import annotations

from typing import Dict, List, Tuple


class TraceRecorder:
    """Append-only deterministic event log + named time series.

    ``record`` appends one event dict; ``sample`` appends one ``(t,
    value)`` point to a named series (the engines sample queue depth and
    scheduler backlog at every micro-batch dispatch).  ``shard_view``
    returns a lightweight proxy that stamps ``shard=h`` on everything it
    forwards — the sharded engine hands one view to each shard engine so
    replica/frame events carry their failure domain.

    >>> rec = TraceRecorder()
    >>> rec.record("arrive", 0.5, rid=7, stream=1)
    >>> rec.shard_view(2).record("drop", 1.0, rid=8)
    >>> [(e["kind"], e.get("shard", 0)) for e in rec.events]
    [('arrive', 0), ('drop', 2)]
    """

    enabled = True

    def __init__(self):
        self.events: List[dict] = []
        self.series: Dict[str, List[Tuple[float, float]]] = {}
        self._i = 0

    def record(self, kind: str, t: float, **fields):
        # the kwargs dict is already a fresh allocation — annotate it in
        # place instead of merging into a second dict (this runs once
        # per lifecycle event on the serve hot path)
        fields["kind"] = kind
        fields["t"] = t
        fields["i"] = self._i
        self._i += 1
        self.events.append(fields)

    def sample(self, name: str, t: float, value: float, shard: int = 0):
        """Append one point to the per-shard series ``name`` (stored
        under ``"name/shard"`` so shards never interleave samples)."""
        key = f"{name}/{shard}"
        s = self.series.get(key)
        if s is None:
            s = self.series[key] = []
        s.append((t, value))

    def shard_view(self, shard: int) -> "_ShardView":
        return _ShardView(self, shard)

    def sorted_events(self) -> List[dict]:
        """Events in virtual-time order (code order ``i`` breaks ties),
        the canonical order export and human inspection use.  The audit
        checker uses raw code order — the order decisions were made in."""
        return sorted(self.events, key=lambda e: (e["t"], e["i"]))

    def to_json(self) -> dict:
        """The raw-trace serialization ``tools/check_trace.py`` accepts
        (the Chrome export in ``repro.obs.export`` is the other one)."""
        return {"events": list(self.events),
                "series": {k: [list(p) for p in v]
                           for k, v in self.series.items()}}


class _ShardView:
    """Forwarding proxy that stamps ``shard=h`` on records and samples.
    Shares the parent's log, counter and ``enabled`` flag, so events
    from every shard interleave into one totally-ordered trace."""

    def __init__(self, parent: TraceRecorder, shard: int):
        self._parent = parent
        self.shard = shard

    @property
    def enabled(self) -> bool:
        return self._parent.enabled

    def record(self, kind: str, t: float, **fields):
        # stamp + annotate in place (one kwargs dict per event, no
        # re-expansion through the parent's signature)
        fields.setdefault("shard", self.shard)
        fields["kind"] = kind
        fields["t"] = t
        p = self._parent
        fields["i"] = p._i
        p._i += 1
        p.events.append(fields)

    def sample(self, name: str, t: float, value: float, shard=None):
        self._parent.sample(name, t, value,
                            self.shard if shard is None else shard)

    def shard_view(self, shard: int) -> "_ShardView":
        return _ShardView(self._parent, shard)


class NullRecorder:
    """The default no-op recorder: ``enabled`` is False so every hot
    path skips event construction, keeping the untraced engine
    bit-identical to the pre-tracing one (and paying ~one attribute
    read per would-be event)."""

    enabled = False

    def record(self, kind: str, t: float, **fields):
        pass

    def sample(self, name: str, t: float, value: float, shard: int = 0):
        pass

    def shard_view(self, shard: int) -> "NullRecorder":
        return self

    def sorted_events(self):
        return []

    def to_json(self) -> dict:
        return {"events": [], "series": {}}


#: process-wide default; engines use it whenever ``recorder=None``
NULL_RECORDER = NullRecorder()
