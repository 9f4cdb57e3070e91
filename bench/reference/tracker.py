"""Plain reference of the served tracker, in numpy: a fixed table of
``capacity`` track slots per camera, constant-velocity Kalman filtering
of (cx, cy, w, h), class-gated greedy IoU association, birth into free
slots (evicting the lowest-scored coasting tracks when full), death
after ``max_coast`` frames without a match, and the confirmed tracks as
output.  Written from the tracker's description, one camera table per
batch row, every float operation in float32, in the order the
description gives it.  ``bf16=True`` rounds every result to bfloat16
instead: the control of the tracker cells.
"""
from __future__ import annotations

import numpy as np

F32 = np.float32


def r(x):
    """A float32 result (numpy keeps float32 operands in float32)."""
    return np.asarray(x, np.float32)


def bf16_round(x):
    """A result rounded to bfloat16 (8 mantissa bits, nearest even) and
    held in float32: the control's arithmetic."""
    u = np.array(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> np.uint32(16)) & np.uint32(1))) \
        & np.uint32(0xFFFF0000)
    return u.view(np.float32)


class Tracker:
    """``B`` camera tables advanced in lockstep, one tick at a time."""

    def __init__(self, B: int, cfg: dict, bf16: bool = False):
        self.cfg = cfg
        self._r = bf16_round if bf16 else r
        T = cfg["capacity"]
        self.pos = np.zeros((B, T, 4), F32)
        self.vel = np.zeros((B, T, 4), F32)
        self.cov = np.zeros((B, T, 4, 3), F32)    # p_xx, p_xv, p_vv
        self.score = np.zeros((B, T), F32)
        self.cls = np.zeros((B, T), np.int32)
        self.tid = np.full((B, T), -1, np.int32)
        self.hits = np.zeros((B, T), np.int32)
        self.tsu = np.zeros((B, T), np.int32)
        self.active = np.zeros((B, T), bool)
        self.next_id = np.zeros(B, np.int32)

    # ------------------------------------------------------------ pieces
    def _predict(self):
        r = self._r
        q, c = F32(self.cfg["q"]), self.cfg
        pxx, pxv, pvv = (self.cov[..., i] for i in range(3))
        self.pos = r(self.pos + self.vel)
        pxx = r(r(pxx + r(r(F32(2.0) * pxv) + pvv)) + r(q / F32(4.0)))
        pxv = r(r(pxv + pvv) + r(q / F32(2.0)))
        pvv = r(pvv + q)
        self.cov = np.stack([pxx, pxv, pvv], -1)
        self.tsu = self.tsu + self.active.astype(np.int32)
        self.score = np.where(self.active,
                              r(self.score * F32(c["score_decay"])),
                              self.score)
        self.active = self.active & (self.tsu <= c["max_coast"])

    def _xyxy(self):
        r = self._r
        wh = np.maximum(self.pos[..., 2:], F32(1.0))
        half = r(wh / F32(2.0))
        c = self.pos[..., :2]
        return np.concatenate([r(c - half), r(c + half)], -1)

    def _associate(self, boxes, valid, classes):
        """(B, T) detection index of each slot, -1 if unmatched: the best
        remaining (slot, detection) pair of the same class is committed
        while its IoU is at least ``iou_thr`` (ties: the first in
        row-major order)."""
        from .detector import iou
        B, T = self.active.shape
        D = boxes.shape[1]
        match = np.full((B, T), -1, np.int32)
        rows = np.flatnonzero(valid.any(-1) & self.active.any(-1))
        if not len(rows):
            return match
        tb = self._xyxy()
        thr = F32(self.cfg["iou_thr"])
        ok = (self.active[rows][:, :, None] & valid[rows][:, None, :] &
              (self.cls[rows][:, :, None] == classes[rows][:, None, :]))
        cost = np.where(ok, iou(tb[rows], boxes[rows]), F32(-1.0))
        flat = cost.reshape(len(rows), T * D)
        for _ in range(min(T, D)):
            f = np.argmax(flat, -1)
            best = flat[np.arange(len(rows)), f]
            go = np.flatnonzero(best >= thr)
            if not len(go):
                break
            i, j = f[go] // D, f[go] % D
            match[rows[go], i] = j
            cost[go, i, :] = -1.0
            cost[go, :, j] = -1.0
        return match

    # -------------------------------------------------------------- tick
    def tick(self, boxes, scores, classes, valid):
        """One frame per camera: rows (B, D[, 4]) with ``valid`` marking
        real detections (an all-invalid row is a frame with none).
        Returns the (B, D) track id each detection landed on, -1 for
        invalid rows."""
        r = self._r
        c = self.cfg
        boxes = r(boxes)
        scores = r(scores)
        classes = np.asarray(classes, np.int32)
        valid = np.asarray(valid, bool)
        B, T = self.active.shape
        D = boxes.shape[1]
        self._predict()
        if not valid.any():                  # a frame with no detection
            return np.full((B, D), -1, np.int32)
        match = self._associate(boxes, valid, classes)
        matched = match >= 0
        mi = np.maximum(match, 0)
        zb = np.take_along_axis(boxes, mi[..., None], 1)
        z = self._cxcywh(zb)
        # Kalman update of the matched slots
        rr = F32(c["r"])
        pxx, pxv, pvv = (self.cov[..., i] for i in range(3))
        s = r(pxx + rr)
        k1, k2 = r(pxx / s), r(pxv / s)
        y = r(z - self.pos)
        g = matched[..., None]
        pos = np.where(g, r(self.pos + r(k1 * y)), self.pos)
        vel = np.where(g, r(self.vel + r(k2 * y)), self.vel)
        cov_u = np.stack([r(r(F32(1.0) - k1) * pxx),
                          r(r(F32(1.0) - k1) * pxv),
                          r(pvv - r(k2 * pxv))], -1)
        cov = np.where(g[..., None], cov_u, self.cov)
        score = np.where(matched, np.take_along_axis(scores, mi, 1),
                         self.score)
        hits = self.hits + matched.astype(np.int32)
        tsu = np.where(matched, 0, self.tsu)
        # births: the k-th unmatched detection takes the k-th free slot;
        # when short of slots the lowest-scored coasting tracks go
        mb, mt = np.nonzero(matched)
        taken = np.zeros((B, D), bool)
        taken[mb, match[mb, mt]] = True
        unmatched = valid & ~taken & (scores >= F32(c["birth_score_thr"]))
        free = ~self.active
        n_new = unmatched.sum(-1)
        need = np.maximum(n_new - free.sum(-1), 0)
        evictable = self.active & ~matched
        evict = np.zeros((B, T), bool)
        for b in np.flatnonzero(need):
            key = np.where(evictable[b], self.score[b], np.inf)
            evict[b, np.argsort(key, kind="stable")[:need[b]]] = True
        evict &= evictable
        free = free | evict
        rank = np.cumsum(free, -1) - free            # k-th free slot
        by_rank = np.argsort(~unmatched, axis=1, kind="stable")
        birth = free & (rank < n_new[:, None])
        bidx = np.take_along_axis(by_rank, np.minimum(rank, D - 1), 1)
        bz = self._cxcywh(np.take_along_axis(boxes, bidx[..., None], 1))
        b3 = birth[..., None]
        self.pos = np.where(b3, bz, pos)
        self.vel = np.where(b3, F32(0.0), vel)
        fresh = np.zeros((B, T, 4, 3), F32)
        fresh[..., 0] = c["r"]
        fresh[..., 2] = c["p0_vel"]
        self.cov = np.where(b3[..., None], fresh, cov)
        self.score = np.where(birth, np.take_along_axis(scores, bidx, 1),
                              score)
        self.cls = np.where(birth, np.take_along_axis(classes, bidx, 1),
                            self.cls).astype(np.int32)
        new_id = self.next_id[:, None] + rank.astype(np.int32)
        self.tid = np.where(birth, new_id, self.tid).astype(np.int32)
        self.next_id = (self.next_id + birth.sum(-1)).astype(np.int32)
        self.hits = np.where(birth, 1, hits).astype(np.int32)
        self.tsu = np.where(birth, 0, tsu).astype(np.int32)
        self.active = (self.active & ~evict) | birth
        det_tid = np.full((B, D), -1, np.int32)
        det_tid[mb, match[mb, mt]] = self.tid[mb, mt]
        bb, bt = np.nonzero(birth)
        det_tid[bb, bidx[bb, bt]] = self.tid[bb, bt]
        return np.where(valid, det_tid, -1)

    def _cxcywh(self, xyxy):
        r = self._r
        return np.concatenate([r(r(xyxy[..., :2] + xyxy[..., 2:]) /
                                 F32(2.0)),
                               r(xyxy[..., 2:] - xyxy[..., :2])], -1)

    def output(self):
        """Confirmed live tracks: (boxes (B, T, 4) xyxy, scores, classes,
        track ids, emitted mask)."""
        emit = self.active & (self.hits >= self.cfg["min_hits"])
        return self._xyxy(), self.score, self.cls, self.tid, emit
