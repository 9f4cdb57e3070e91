"""Chrome-trace-event export: open a serving trace in Perfetto (copied
from the reference package's ``obs/export.py``; only this docstring
differs).

``to_chrome_trace`` converts a recorded event list (plus optional time
series) into the Chrome Trace Event JSON format — load the file at
https://ui.perfetto.dev (or ``chrome://tracing``) to get a zoomable
timeline of the whole serve run:

* one *process* lane per shard (``pid`` = shard index, named
  ``shard<h>``) and one *thread* lane per replica (``tid`` = replica
  index within the shard, named ``replica<r>``; lane 0 of each shard
  doubles as the control/stream lane for instants with no replica),
* a complete-event span (``"ph": "X"``) per completed frame covering
  its service window ``[t0, t0 + service]`` — exactly one span per
  ``complete`` event,
* instant markers (``"ph": "i"``) for drops, retries, failovers, lost
  frames, migrations, loans, health marks and shard kills/restarts,
* counter tracks (``"ph": "C"``) from the recorder's sampled series
  (queue depth, scheduler backlog).

Virtual-time seconds map to microseconds (``ts = t * 1e6``) — the
trace-event format's native unit.  Every emitted traceEvent embeds the
raw recorder event under ``args`` untouched, so a Chrome-format file
round-trips back to an auditable event list via ``events_from_chrome``
(``tools/check_trace_torch.py`` accepts either format).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

#: event kinds rendered as instant markers, and the lane they pin to
_INSTANT_KINDS = ("arrive", "enqueue", "drop", "emit", "interp_emit",
                  "retry", "failover", "lost", "epoch", "migrate",
                  "loan", "loan_return", "health_mark", "health_restore",
                  "shard_down", "shard_restart", "shard_lost")


def _us(t: float) -> float:
    return t * 1e6


def _lane(ev: dict) -> Tuple[int, int]:
    """(pid, tid) for an event: shard lane + replica lane (0 when the
    event has no replica — control-plane / stream events)."""
    pid = ev.get("shard", ev.get("borrower", 0))
    tid = ev.get("replica", ev.get("guest", 0))
    return pid, max(0, tid)


def to_chrome_trace(events: List[dict],
                    series: Optional[Dict[str, list]] = None) -> dict:
    """Build the ``{"traceEvents": [...]}`` document (JSON-ready)."""
    out: List[dict] = []
    lanes = set()

    for ev in sorted(events, key=lambda e: (e["t"], e["i"])):
        kind = ev["kind"]
        pid, tid = _lane(ev)
        lanes.add((pid, tid))
        if kind == "complete":
            t0 = ev.get("t0", ev["t"])
            dur = ev.get("service", max(0.0, ev["t"] - t0))
            out.append({"name": f"frame {ev.get('rid', '?')}",
                        "cat": "service", "ph": "X",
                        "ts": _us(t0), "dur": _us(dur),
                        "pid": pid, "tid": tid, "args": ev})
        elif kind == "dispatch":
            # dispatch marks the span's start; the span itself comes
            # from the matching complete event — keep dispatch as a
            # thin instant so faulted dispatch-less retries stand out
            out.append({"name": "dispatch", "cat": "sched", "ph": "i",
                        "s": "t", "ts": _us(ev["t"]),
                        "pid": pid, "tid": tid, "args": ev})
        elif kind in _INSTANT_KINDS:
            scope = "p" if kind in ("epoch", "shard_down",
                                    "shard_restart") else "t"
            out.append({"name": kind, "cat": "lifecycle", "ph": "i",
                        "s": scope, "ts": _us(ev["t"]),
                        "pid": pid, "tid": tid, "args": ev})
        else:   # unknown kinds still export (forward compatibility)
            out.append({"name": kind, "cat": "other", "ph": "i",
                        "s": "t", "ts": _us(ev["t"]),
                        "pid": pid, "tid": tid, "args": ev})

    for name, pts in (series or {}).items():
        base, _, shard = name.rpartition("/")
        pid = int(shard) if base else 0
        cname = base or name
        for t, v in pts:
            out.append({"name": cname, "cat": "series", "ph": "C",
                        "ts": _us(t), "pid": pid,
                        "args": {cname: v}})

    meta: List[dict] = []
    for pid in sorted({p for p, _ in lanes}):
        meta.append({"name": "process_name", "ph": "M", "pid": pid,
                     "args": {"name": f"shard{pid}"}})
    for pid, tid in sorted(lanes):
        meta.append({"name": "thread_name", "ph": "M", "pid": pid,
                     "tid": tid, "args": {"name": f"replica{tid}"}})

    return {"traceEvents": meta + out, "displayTimeUnit": "ms"}


def events_from_chrome(doc: dict) -> List[dict]:
    """Recover the raw recorder events embedded in a Chrome-format
    document's ``args`` (inverse of ``to_chrome_trace`` for auditing)."""
    evs = []
    for te in doc.get("traceEvents", []):
        args = te.get("args")
        if isinstance(args, dict) and "kind" in args and "i" in args:
            evs.append(args)
    return evs


def write_chrome_trace(path: str, recorder) -> dict:
    """Export a live recorder to ``path``; returns the document."""
    doc = to_chrome_trace(recorder.events, recorder.series)
    with open(path, "w") as f:
        # event fields are stored unconverted on the hot path; numpy
        # scalars (if a caller's clocks carry them) coerce here instead
        json.dump(doc, f, default=float)
    return doc
