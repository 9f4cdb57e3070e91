"""Epoch-boundary watchdog for ``ShardedDetectionEngine``: shard
restart + camera re-homing + replica lending (a copy of the reference
package's ``serving/supervisor.py``, recording through the port's
``obs.trace``).

The sharded epoch loop is the supervision point the serving stack
already has — every shard reports once per epoch (its serve report +
``backlog_snapshot``), so the watchdog runs where the observations
land: at epoch boundaries, on pure per-epoch data, with no extra
channel.  Everything here is a deterministic function of those
observations; re-running the same (trace, FaultSchedule) replays the
same restarts and loans bit-for-bit.

Detection
---------
A shard is *dead* when it had frames to serve this epoch but missed its
heartbeat (the epoch loop stamps a heartbeat only for shards that are
up at the window's end — a host that died mid-epoch never stamps).  A
shard is *straggling* (lending-hot, below) when its epoch observation
shows drops, or residual backlog at the epoch's last arrival beyond
``straggler_backlog_s`` — the two pressure signals
``rebalance_streams`` already ranks shards by.

Dead-shard recovery
-------------------
On detection the watchdog (1) restarts the shard — ``engine.reset()``
plus clearing the fault cursor, refused for ``permanent`` kills — and
(2) evacuates every camera the dead shard owned through
``sharding.serving_rules.rebalance_streams(evacuate=[shard])``: each
stream re-homes to the least-loaded live shard, and the next epoch
serves it there with its ``seq``/emit floors warm-started through the
engines' ``serve(stream_seq0=, stream_emit0=)`` hooks (the same
machinery a stolen stream migrates by).  Evacuation runs even when the
restart succeeds: the restarted shard is an empty host that re-earns
streams through the normal stealing policy, which is simpler to reason
about than guessing which cameras survived the outage.

Replica lending
---------------
Stream migration cannot help a shard whose load is ONE hot camera
(``rebalance_streams`` rule 3 refuses moves that merely relocate the
overload).  Lending is the dual: move capacity to the load instead.
When no migration happened at a boundary and the pressure gradient
persists, the most idle shard (zero drops, backlog under
``idle_backlog_s``, pool larger than ``min_donor_pool - 1``) lends the
TAIL replica of its pool to the hottest shard (drops >= ``hot_drops``
or backlog >= ``straggler_backlog_s``):

    lender pool  [r0 r1]  --pop-->  r1
    borrower pool [r0 r1] --append--> [r0 r1 g2]   (guest idx = 2)

Tail-only pop/append keeps every executor's list position equal to its
``idx``, which is what the engines' per-replica accounting keys on;
``scheduler.sync_pool()`` renormalizes the health mask and any WRR
weights on both sides.  A loan returns (LIFO, same tail discipline) at
a later boundary once the borrower stops dropping or the lender itself
comes under pressure, and unconditionally when the serve ends — pools
always end the serve at their constructed sizes.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from ..obs.trace import NULL_RECORDER


@dataclass
class _Loan:
    lender: int
    borrower: int
    ex: object                    # the ReplicaExecutor on loan
    home_idx: int                 # its idx in the lender's pool
    record: Dict                  # the log entry (gains "returned_epoch")


class Watchdog:
    """Epoch-boundary supervisor (see module docstring).  One instance
    is bound to one ``ShardedDetectionEngine`` via ``supervisor=``; its
    per-serve state (loans, logs, pool high-water marks) resets on
    ``begin`` so repeated serves replay identically."""

    def __init__(self, lend: bool = True, max_loans: int = 1,
                 min_donor_pool: int = 2, hot_drops: int = 1,
                 idle_backlog_s: float = 1e-9,
                 straggler_backlog_s: Optional[float] = None):
        self.lend = lend
        self.max_loans = max_loans
        self.min_donor_pool = min_donor_pool
        self.hot_drops = hot_drops
        self.idle_backlog_s = idle_backlog_s
        self.straggler_backlog_s = straggler_backlog_s
        self.restart_log: List[Dict] = []
        self.loan_log: List[Dict] = []
        self._loans: List[_Loan] = []
        self._max_pool: List[int] = []
        # observability: the owning ShardedDetectionEngine swaps in its
        # TraceRecorder so restarts and loans land on the shared trace
        self.recorder = NULL_RECORDER

    # ------------------------------------------------------------ lifecycle
    def begin(self, engines: Sequence):
        """Reset per-serve state; called by the epoch loop on entry."""
        self.restart_log = []
        self.loan_log = []
        self._loans = []
        self._max_pool = [len(e.replicas) for e in engines]

    def finish(self, engines: Sequence, epoch: int,
               t: Optional[float] = None):
        """Return every outstanding loan (LIFO) so pools end the serve
        at their constructed sizes.  ``t`` (optional, additive) is the
        virtual boundary time the returns are recorded at."""
        while self._loans:
            self._return(engines, self._loans[-1], epoch, t=t)

    def pool_sizes(self, engines: Sequence) -> List[int]:
        """Per-shard replica-id space for the report merge: the HIGH
        WATER mark each pool reached, so a guest replica's renumbered
        id never collides with a neighbor shard's offset range."""
        return list(self._max_pool)

    # ------------------------------------------------------------ dead shards
    def detect_dead(self, heartbeat: Dict[int, int], epoch: int,
                    had_frames: Sequence[bool]) -> List[int]:
        """Shards that had frames this epoch but missed the heartbeat."""
        return [h for h, hb in sorted(heartbeat.items())
                if had_frames[h] and hb < epoch]

    def handle_dead(self, engines: Sequence, h: int, cursor, epoch: int,
                    t_boundary: float) -> bool:
        """Restart a dead shard: reset its engine (virtual clock, round
        state, health mask) and clear the fault cursor.  Returns the
        restart outcome (``False`` for permanent kills — the shard
        stays down and evacuation carries the recovery alone)."""
        ok = cursor.restart(h, t_boundary)
        engines[h].reset()
        self.restart_log.append({"epoch": epoch, "shard": h, "ok": ok,
                                 "t": t_boundary})
        if self.recorder.enabled:
            self.recorder.record("shard_restart", t_boundary, shard=h,
                                 epoch=epoch, ok=ok)
        return ok

    # ------------------------------------------------------------ lending
    def _pressure(self, observations: Sequence[Dict], epoch_s: float):
        thresh = (self.straggler_backlog_s if self.straggler_backlog_s
                  is not None else epoch_s)
        pres = [(int(o["drops"]), float(o["backlog_s"]))
                for o in observations]
        hot = [h for h, (d, b) in enumerate(pres)
               if d >= self.hot_drops or b >= thresh]
        idle = [h for h, (d, b) in enumerate(pres)
                if d == 0 and b <= self.idle_backlog_s]
        return pres, hot, idle

    def rebalance_loans(self, engines: Sequence,
                        observations: Sequence[Dict], moved: bool,
                        down: Sequence[int], epoch: int,
                        epoch_s: float,
                        t: Optional[float] = None) -> List[Dict]:
        """One boundary's lending decisions: first return loans whose
        reason expired, then — only if stream migration did NOT act
        this boundary (migration is the cheaper fix: no pool churn) —
        open at most one new loan along the steepest pressure
        gradient.  Down shards neither lend nor borrow.  ``t``
        (optional, additive) is the virtual boundary time loan events
        are recorded at."""
        if not self.lend:
            return []
        actions: List[Dict] = []
        pres, hot, idle = self._pressure(observations, epoch_s)
        for loan in list(reversed(self._loans)):     # LIFO returns
            borrower_cool = pres[loan.borrower][0] == 0
            lender_hot = loan.lender in hot or loan.lender in down
            if borrower_cool or lender_hot or loan.borrower in down:
                self._return(engines, loan, epoch, t=t)
                actions.append(loan.record)
        if moved or len(self._loans) >= self.max_loans:
            return actions
        lenders = {ln.lender for ln in self._loans}
        borrowers = {ln.borrower for ln in self._loans}
        cand_hot = [h for h in hot if h not in down and h not in lenders]
        cand_idle = [h for h in idle
                     if h not in down and h not in borrowers
                     and len(engines[h].replicas) >= self.min_donor_pool]
        if not cand_hot or not cand_idle:
            return actions
        borrower = max(cand_hot, key=lambda h: (pres[h], -h))
        lender = min(cand_idle,
                     key=lambda h: (pres[h], -len(engines[h].replicas), h))
        if borrower == lender or pres[borrower] <= pres[lender]:
            return actions
        actions.append(self._lend(engines, lender, borrower, epoch, t=t))
        return actions

    def _lend(self, engines: Sequence, lender: int, borrower: int,
              epoch: int, t: Optional[float] = None) -> Dict:
        ex = engines[lender].replicas.pop()          # tail only: every
        home_idx = ex.idx                            # survivor keeps its
        ex.idx = len(engines[borrower].replicas)     # idx == position
        engines[borrower].replicas.append(ex)
        engines[lender].scheduler.sync_pool()
        engines[borrower].scheduler.sync_pool()
        record = {"epoch": epoch, "lender": lender, "borrower": borrower,
                  "returned_epoch": None}
        self._loans.append(_Loan(lender, borrower, ex, home_idx, record))
        self.loan_log.append(record)
        self._max_pool[borrower] = max(self._max_pool[borrower],
                                       len(engines[borrower].replicas))
        if self.recorder.enabled:
            self.recorder.record("loan", 0.0 if t is None else t,
                                 lender=lender, borrower=borrower,
                                 guest=ex.idx, epoch=epoch)
        return record

    def _return(self, engines: Sequence, loan: _Loan, epoch: int,
                t: Optional[float] = None):
        ex = engines[loan.borrower].replicas.pop()
        assert ex is loan.ex, "loan return must be LIFO (tail discipline)"
        if self.recorder.enabled:
            # guest = the lane the borrower just retired: the audit uses
            # it to close any open health mark on that (shard, lane)
            self.recorder.record("loan_return", 0.0 if t is None else t,
                                 lender=loan.lender,
                                 borrower=loan.borrower, guest=ex.idx,
                                 epoch=epoch)
        ex.idx = loan.home_idx
        # the guest's virtual clock may run ahead of its home pool (it
        # was absorbing a hot shard's backlog); busy_until rides along —
        # the lender simply cannot use it until its borrowed work drains
        engines[loan.lender].replicas.append(ex)
        engines[loan.borrower].scheduler.sync_pool()
        engines[loan.lender].scheduler.sync_pool()
        loan.record["returned_epoch"] = epoch
        self._loans.remove(loan)
