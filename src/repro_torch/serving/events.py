"""Subscriber event bus over the serving trace — one source of truth.

The engines already record every frame-lifecycle and control-plane
event into ``obs.TraceRecorder`` (deterministic on the virtual clock,
audited by ``obs.audit``).  This module derives the *push* side from
that same log instead of inventing a second event schema:
``EventBus.recorder()`` returns a ``TapRecorder`` — a drop-in
``TraceRecorder`` that publishes every event it records to the bus's
subscribers, grouped into coarse topics:

=============  =====================================================
topic          trace kinds (``obs.trace``)
=============  =====================================================
``detection``  ``complete``, ``emit``, ``interp_emit``
``drop``       ``drop``, ``shard_lost``, ``lost``
``migration``  ``migrate``
``fault``      ``retry``, ``failover``, ``health_mark``,
               ``health_restore``, ``shard_down``, ``shard_restart``
``loan``       ``loan``, ``loan_return``
``epoch``      ``epoch``
``lifecycle``  ``arrive``, ``enqueue``, ``dispatch`` (and any
               future kind not mapped above)
=============  =====================================================

Because the tap IS the trace recorder, subscribers see exactly the
events the audit replays and the Perfetto export draws — same dicts,
same code order — and an engine built with a plain ``TraceRecorder``
(or none) is untouched: the bus is opt-in per engine construction.

``JsonlSink`` is the daemon's streaming subscriber: one JSON object
per line, ``topic`` added to the raw event fields.
"""
from __future__ import annotations

import json
from typing import Callable, Dict, List, Optional, Sequence

from ..obs.trace import TraceRecorder, _ShardView

#: the seven event topics, in the order the daemon summarizes them
TOPICS = ("detection", "drop", "migration", "fault", "loan", "epoch",
          "lifecycle")

_TOPIC_OF_KIND = {
    "complete": "detection", "emit": "detection",
    "interp_emit": "detection",
    "drop": "drop", "shard_lost": "drop", "lost": "drop",
    "migrate": "migration",
    "track_export": "migration", "track_import": "migration",
    "retry": "fault", "failover": "fault", "health_mark": "fault",
    "health_restore": "fault", "shard_down": "fault",
    "shard_restart": "fault",
    "loan": "loan", "loan_return": "loan",
    "epoch": "epoch",
    "arrive": "lifecycle", "enqueue": "lifecycle",
    "dispatch": "lifecycle",
}


def topic_of(kind: str) -> str:
    """Map a trace event ``kind`` to its bus topic.  Unmapped kinds
    (future additions) land in ``lifecycle`` so no event is ever
    silently unroutable.

    >>> topic_of("interp_emit"), topic_of("shard_down"), topic_of("x")
    ('detection', 'fault', 'lifecycle')
    """
    return _TOPIC_OF_KIND.get(kind, "lifecycle")


class EventBus:
    """Topic-routed fan-out of serving trace events to subscribers.

    ``subscribe(cb, topics=...)`` registers ``cb(topic, event)`` for a
    topic subset (``None`` or ``"*"`` = every topic) and returns a
    handle for ``unsubscribe``.  ``publish`` routes one raw trace-event
    dict by ``topic_of(event["kind"])`` and counts it in ``counts``
    (per topic, subscribers or not).  Subscriber errors propagate: the
    bus runs on the deterministic serve path, where a silently dropped
    event would be a debugging trap.

    Wire it to an engine by constructing the engine with
    ``recorder=bus.recorder()``::

        bus = EventBus()
        bus.subscribe(lambda topic, e: print(topic, e["kind"]),
                      topics=("drop", "fault"))
        eng = DetectionEngine(recorder=bus.recorder(), ...)
    """

    def __init__(self):
        self._subs: List[Optional[tuple]] = []   # (topics|None, cb)
        self.counts: Dict[str, int] = {}

    def subscribe(self, callback: Callable[[str, dict], None],
                  topics: Optional[Sequence[str]] = None) -> int:
        """Register ``callback(topic, event)``; returns an unsubscribe
        handle.  ``topics=None`` (or ``"*"``) delivers every topic."""
        if topics is None or topics == "*":
            tset = None
        else:
            tset = frozenset([topics] if isinstance(topics, str)
                             else topics)
            unknown = tset - frozenset(TOPICS)
            if unknown:
                raise ValueError(f"unknown topics {sorted(unknown)}; "
                                 f"valid: {TOPICS}")
        self._subs.append((tset, callback))
        return len(self._subs) - 1

    def unsubscribe(self, handle: int):
        """Remove the subscription returned by ``subscribe``."""
        self._subs[handle] = None

    def publish(self, event: dict):
        """Route one raw trace-event dict to the matching subscribers
        (called by ``TapRecorder`` for every recorded event)."""
        topic = topic_of(event["kind"])
        self.counts[topic] = self.counts.get(topic, 0) + 1
        for sub in self._subs:
            if sub is not None and (sub[0] is None or topic in sub[0]):
                sub[1](topic, event)

    def recorder(self) -> "TapRecorder":
        """A ``TraceRecorder`` wired to this bus: hand it to an engine
        as ``recorder=`` and every recorded event is also published."""
        return TapRecorder(self)


class TapRecorder(TraceRecorder):
    """A ``TraceRecorder`` that additionally publishes every event to
    an ``EventBus`` — the log stays the source of truth (audit/export
    replay it unchanged); the bus is a live view of the same dicts.

    ``shard_view`` must be overridden here: the base ``_ShardView``
    appends to the parent's event list *directly* (hot-path
    optimization), which would silently bypass the tap for every
    shard-engine event."""

    def __init__(self, bus: EventBus):
        super().__init__()
        self.bus = bus

    def record(self, kind: str, t: float, **fields):
        super().record(kind, t, **fields)
        self.bus.publish(self.events[-1])

    def shard_view(self, shard: int) -> "_TapShardView":
        return _TapShardView(self, shard)


class _TapShardView(_ShardView):
    """Shard-stamping proxy that keeps the tap: records through the
    base proxy (direct append, same dict layout) then publishes."""

    def record(self, kind: str, t: float, **fields):
        super().record(kind, t, **fields)
        self._parent.bus.publish(self._parent.events[-1])

    def shard_view(self, shard: int) -> "_TapShardView":
        return _TapShardView(self._parent, shard)


class JsonlSink:
    """Streaming JSONL subscriber: one line per event, the raw trace
    fields plus ``topic``.  Subscribe it to a bus (usually to ``"*"``)
    and close it on shutdown; usable as a context manager.

    >>> import io
    >>> bus = EventBus()
    >>> sink = JsonlSink(io.StringIO())
    >>> _ = bus.subscribe(sink)
    >>> bus.publish({"kind": "drop", "t": 1.0, "i": 0, "rid": 7})
    >>> sink.n_written
    1
    """

    def __init__(self, path_or_file):
        if hasattr(path_or_file, "write"):
            self._fh = path_or_file
            self._own = False
        else:
            self._fh = open(path_or_file, "w")
            self._own = True
        self.n_written = 0

    def __call__(self, topic: str, event: dict):
        self._fh.write(json.dumps({"topic": topic, **event},
                                  default=float) + "\n")
        self.n_written += 1

    def close(self):
        self._fh.flush()
        if self._own:
            self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False
