"""Trace-replay invariant checking (copied from the reference package's
``obs/audit.py``; only this docstring differs).

A serving trace is a deterministic artifact (virtual clock), so the
invariants the stack is *supposed* to uphold can be re-checked from the
event log alone — no engine state, no re-run.  ``audit_events`` replays
a recorded event list and verifies:

1. **Frame conservation** — every ``arrive`` reaches exactly one
   terminal state: ``emit`` (detected), ``interp_emit``
   (tracker-coasted re-emission of a drop), ``drop`` with no
   re-emission, or ``shard_lost`` (a down shard swallowed it).  No
   frame vanishes; no frame is emitted twice.
2. **Per-stream emit monotonicity** — within each stream the emitted
   sequence numbers strictly increase and emit times never decrease
   (the reorder buffer's contract, including across epoch migrations
   where the emit clock is carried as a floor).
3. **No dispatch to a dead replica** — between a ``health_mark`` and
   the matching ``health_restore`` for a ``(shard, replica)`` lane,
   the scheduler must not ``dispatch`` to that lane.  A
   ``shard_restart`` closes every open mark on its shard (the watchdog
   resets the whole scheduler health mask), and a ``loan_return``
   closes the borrower's retired guest lane.  Checked in *code order*
   (the event sequence number ``i``), the order decisions were
   actually made in — virtual timestamps of a retry's detection and
   the rescuing dispatch can legitimately interleave.
4. **Loans are LIFO-returned** — ``loan_return`` events per borrower
   must pop the most recent outstanding ``loan`` (the tail-replica
   lending discipline), and every loan must be returned by trace end.
5. **Model switches only at micro-batch boundaries** — a
   ``model_switch`` names the micro-batch it takes effect for
   (``batch``); it must be recorded BEFORE any frame is enqueued to
   that ``(shard, batch)``.  A switch after the batch started filling
   would mean frames priced/detected under two different models in one
   batch.  (Batch numbers are monotone across epoch segments, so the
   pair never repeats within a trace.)
6. **ROI containment** — every ``roi_pass`` window must lie inside its
   parent frame ``bounds``, the pixels read must not exceed the full
   frame, and the second pass's detections (``det_extent``) must land
   inside the frame — a cropped re-detection can never escape the
   image it came from.
7. **Track-identity continuity** — track identities must survive
   segment boundaries and shard migration.  Every tracker segment
   records a ``track_export`` per stream (its ``next_id`` counter +
   confirmed track-id set) and, when seeded from carried rows, a
   matching ``track_import``.  An import must reproduce the stream's
   latest prior export exactly (same ``next_id``, same ``tids`` — a
   fresh table restarting ids at 0 can never fake it), and a stream
   that keeps emitting after a ``migrate`` without importing its
   exported table was re-seeded: a violation.  Traces from engines
   that never ran a tracker carry no export events and pass vacuously.

``audit_events`` returns an ``AuditResult`` whose ``violations`` list
is empty on a clean trace; each violation is a dict with a ``rule``
key naming the broken invariant.  ``tools/check_trace_torch.py`` is the CLI
over saved trace files.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple


class AuditResult:
    """Outcome of a trace audit: per-rule violation dicts + tallies."""

    def __init__(self, violations: List[dict], stats: dict):
        self.violations = violations
        self.stats = stats

    @property
    def ok(self) -> bool:
        return not self.violations

    def __repr__(self):
        return (f"AuditResult(ok={self.ok}, "
                f"violations={len(self.violations)}, stats={self.stats})")


def _lane(ev: dict) -> Tuple[int, int]:
    return (ev.get("shard", 0), ev["replica"])


def audit_events(events: List[dict],
                 max_violations: int = 50) -> AuditResult:
    """Replay ``events`` (raw recorder order) and check the seven
    invariants in the module docstring.  Events may be passed in any
    order; they are re-sorted by code order ``i`` first."""
    evs = sorted(events, key=lambda e: e["i"])
    violations: List[dict] = []

    def flag(rule: str, ev: Optional[dict] = None, **detail):
        if len(violations) < max_violations:
            v = {"rule": rule}
            if ev is not None:
                v["event"] = ev
            v.update(detail)
            violations.append(v)

    # -- per-frame terminal-state machine ------------------------------
    # rid -> one of None (arrived, pending), "emit", "interp_emit",
    # "drop", "shard_lost"
    state: Dict[int, Optional[str]] = {}
    # -- per-stream emit clock -----------------------------------------
    last_emit: Dict[int, Tuple[int, float]] = {}   # stream -> (seq, t)
    # -- replica health (code-order intervals) -------------------------
    dead: Dict[Tuple[int, int], dict] = {}          # lane -> mark event
    # -- loan stacks ---------------------------------------------------
    loans: Dict[int, List[dict]] = {}               # borrower -> stack
    # -- micro-batches already filling (model switches must precede) ---
    started: set = set()                            # (shard, batch)
    # -- track-identity continuity -------------------------------------
    last_export: Dict[int, dict] = {}   # stream -> latest export event
    # migrated streams whose exported table has not been imported yet:
    # an emit for one of them means the destination re-seeded
    pending_migrate: Dict[int, dict] = {}

    n = {"arrive": 0, "emit": 0, "interp_emit": 0, "drop": 0,
         "shard_lost": 0, "dispatch": 0, "loan": 0, "model_switch": 0,
         "roi_pass": 0, "track_export": 0, "track_import": 0}

    for ev in evs:
        kind = ev["kind"]
        if kind == "arrive":
            n["arrive"] += 1
            rid = ev["rid"]
            if rid in state:
                flag("frame_conservation", ev, why="duplicate arrive")
            state.setdefault(rid, None)
        elif kind in ("emit", "interp_emit"):
            n[kind] += 1
            rid = ev["rid"]
            if rid not in state:
                flag("frame_conservation", ev, why="emit without arrive")
            elif state[rid] == "drop" and kind == "interp_emit":
                pass   # a dropped frame MAY be coasted back by the tracker
            elif state[rid] is not None:
                flag("frame_conservation", ev,
                     why=f"{kind} after terminal {state[rid]}")
            state[rid] = kind
            s, seq, t = ev["stream"], ev["seq"], ev["t"]
            if s in last_emit:
                pseq, pt = last_emit[s]
                if seq <= pseq:
                    flag("emit_monotonicity", ev, prev_seq=pseq,
                         why="sequence not increasing")
                if t < pt:
                    flag("emit_monotonicity", ev, prev_t=pt,
                         why="emit time decreased")
            last_emit[s] = (seq, t)
            if s in pending_migrate:
                flag("track_continuity", pending_migrate.pop(s),
                     why="stream served after migration without "
                         "importing its exported track table")
        elif kind == "drop":
            n["drop"] += 1
            rid = ev["rid"]
            if state.get(rid) is not None:
                flag("frame_conservation", ev,
                     why=f"drop after terminal {state[rid]}")
            state[rid] = "drop"
        elif kind == "shard_lost":
            n["shard_lost"] += 1
            rid = ev["rid"]
            if state.get(rid) is not None:
                flag("frame_conservation", ev,
                     why=f"lost after terminal {state[rid]}")
            state[rid] = "shard_lost"
        elif kind == "enqueue":
            started.add((ev.get("shard", 0), ev.get("batch")))
        elif kind == "model_switch":
            n["model_switch"] += 1
            key = (ev.get("shard", 0), ev.get("batch"))
            if key in started:
                flag("model_switch_boundary", ev,
                     why="switch after the micro-batch started filling")
        elif kind == "roi_pass":
            n["roi_pass"] += 1
            W, H = ev.get("bounds", (float("inf"), float("inf")))
            eps = 1e-6 * max(W, H, 1.0)
            for r in ev.get("rois", ()):
                if (r[0] < -eps or r[1] < -eps
                        or r[2] > W + eps or r[3] > H + eps
                        or r[2] < r[0] or r[3] < r[1]):
                    flag("roi_containment", ev, roi=list(r),
                         why="ROI window escapes the parent frame")
            if ev.get("px_roi", 0.0) > ev.get("px_full", 0.0) + eps:
                flag("roi_containment", ev,
                     why="ROI pixels exceed the full frame")
            ext = ev.get("det_extent")
            if ext is not None and (ext[0] < -eps or ext[1] < -eps
                                    or ext[2] > W + eps
                                    or ext[3] > H + eps):
                flag("roi_containment", ev, det_extent=list(ext),
                     why="second-pass detection outside the parent frame")
        elif kind == "dispatch":
            n["dispatch"] += 1
            lane = _lane(ev)
            if lane in dead:
                flag("dead_replica_dispatch", ev,
                     marked_at=dead[lane]["t"])
        elif kind == "health_mark":
            dead[_lane(ev)] = ev
        elif kind == "health_restore":
            dead.pop(_lane(ev), None)
        elif kind == "shard_restart":
            # the watchdog restart resets the shard's whole scheduler
            # health mask: every open mark on that shard closes
            for lane in [ln for ln in dead if ln[0] == ev.get("shard")]:
                dead.pop(lane)
        elif kind == "track_export":
            n["track_export"] += 1
            last_export[ev["stream"]] = ev
        elif kind == "track_import":
            n["track_import"] += 1
            s = ev["stream"]
            prev = last_export.get(s)
            if prev is not None and (
                    ev.get("next_id") != prev.get("next_id")
                    or list(ev.get("tids", ())) != list(
                        prev.get("tids", ()))):
                flag("track_continuity", ev,
                     exported={"next_id": prev.get("next_id"),
                               "tids": list(prev.get("tids", ()))},
                     why="imported table does not match the stream's "
                         "latest export")
            pending_migrate.pop(s, None)
        elif kind == "migrate":
            s = ev["stream"]
            if s in last_export:
                # the stream owes its next segment an import of this
                # table; emitting again without one is a re-seed
                pending_migrate[s] = ev
        elif kind == "loan":
            n["loan"] += 1
            loans.setdefault(ev["borrower"], []).append(ev)
        elif kind == "loan_return":
            stack = loans.get(ev["borrower"], [])
            if not stack:
                flag("loan_lifo", ev, why="return without loan")
            elif stack[-1]["lender"] != ev["lender"]:
                flag("loan_lifo", ev, expected=stack[-1]["lender"],
                     why="not the most recent loan (LIFO broken)")
                stack.pop()
            else:
                stack.pop()
            # the returned guest lane is retired; close any open death
            # mark on it so a FUTURE loan creating a fresh guest at the
            # same index isn't falsely flagged
            dead.pop((ev["borrower"], ev["guest"]), None)

    for rid, st in state.items():
        if st is None:
            flag("frame_conservation", None, rid=rid,
                 why="arrived but never emitted/dropped/lost")
    for borrower, stack in loans.items():
        for ev in stack:
            flag("loan_lifo", ev, why="loan never returned")

    emitted = n["emit"] + n["interp_emit"]
    # drops that were later coasted back count as interp_emit terminals,
    # so conservation is over terminal states, not raw counters
    terminal = sum(1 for st in state.values() if st is not None)
    if terminal != n["arrive"] and not violations:
        flag("frame_conservation", None, arrived=n["arrive"],
             terminal=terminal, why="terminal-state count mismatch")

    stats = dict(n)
    stats["emitted"] = emitted
    stats["dropped_final"] = sum(1 for st in state.values()
                                 if st == "drop")
    return AuditResult(violations, stats)


def audit_recorder(recorder) -> AuditResult:
    """Convenience: audit a live ``TraceRecorder``."""
    return audit_events(recorder.events)
