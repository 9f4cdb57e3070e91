"""Standalone trace audit of the PyTorch port: replay a saved serving
trace file against the stack's invariants (``repro_torch.obs.audit``,
the port's copy of the reference's audit; ``tools/check_trace.py`` is
the reference package's tool, with the same lines and exit codes):

1. frame conservation — arrived == emitted + dropped + lost,
2. per-stream emit monotonicity,
3. no dispatch to a dead replica,
4. loans LIFO-returned (and all returned by trace end),
5. model switches only at micro-batch boundaries,
6. ROI containment — second-pass windows/detections stay inside the
   parent frame,
7. track-identity continuity — a ``track_import`` must reproduce the
   stream's latest ``track_export`` (same ``next_id`` + confirmed id
   set), and a migrated stream must import its exported table before
   emitting again (a re-seeded tracker fails this).

Accepts either trace serialization:

* the raw recorder dump (``TraceRecorder.to_json``: ``{"events":
  [...], "series": {...}}``), or
* the Chrome-trace-event export (``repro_torch.obs.export``) — the
  raw events are recovered from each traceEvent's ``args``.

  PYTHONPATH=src python tools/check_trace_torch.py out.json [more.json ...]

Exit code 0 = every trace clean, 1 = violations (each printed on its
own line) or no auditable events found.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.obs.audit import audit_events          # noqa: E402
from repro_torch.obs.export import events_from_chrome   # noqa: E402


def load_events(path: str) -> list:
    """Raw recorder events from either trace format (see module doc)."""
    with open(path) as f:
        doc = json.load(f)
    if isinstance(doc, dict) and "traceEvents" in doc:
        return events_from_chrome(doc)
    if isinstance(doc, dict) and "events" in doc:
        return doc["events"]
    raise ValueError(
        f"{path}: neither a raw trace ('events') nor a Chrome trace "
        "('traceEvents') — is this a serving trace file?")


def check(path: str) -> int:
    """Audit one file; prints the verdict, returns the problem count."""
    events = load_events(path)
    if not events:
        print(f"{path}: no auditable events (was the recorder enabled?)")
        return 1
    res = audit_events(events)
    s = res.stats
    print(f"{path}: {len(events)} events, arrived={s['arrive']} "
          f"emitted={s['emitted']} dropped={s['dropped_final']} "
          f"lost={s['shard_lost']} -> "
          f"{'OK' if res.ok else f'{len(res.violations)} violation(s)'}")
    for v in res.violations:
        print(f"  {v['rule']}: {v.get('why', '')} {v.get('event', '')}")
    return len(res.violations)


def main(argv) -> int:
    if not argv:
        print(__doc__)
        return 1
    problems = 0
    for path in argv:
        try:
            problems += check(path)
        except (OSError, ValueError, json.JSONDecodeError) as e:
            print(f"{path}: {e}")
            problems += 1
    return 1 if problems else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
