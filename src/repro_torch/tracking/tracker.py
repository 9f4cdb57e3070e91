"""Batched multi-object tracker: fixed-capacity track table + masked
lifecycle updates (the port of the reference package's
``tracking/tracker.py``).

The track table is a struct-of-tensors ``TrackerState`` with a leading
batch axis (B independent streams tracked in lockstep).  Birth,
confirmation, coasting and death are masked tensor updates inside
``step``:

  predict  — constant-velocity Kalman predict on every slot, score decay
             while coasting, kill after ``max_coast`` frames without a
             matched detection;
  associate— fused IoU cost + greedy assignment (the CUDA kernel for a
             table on the card), class-gated;
  update   — Kalman measurement update on matched slots; hit counters
             drive confirmation (``min_hits``);
  birth    — the k-th unmatched detection lands in the k-th free slot
             (exclusive-cumsum ranks).  When unmatched detections
             outnumber free slots, the lowest-score coasting tracks are
             evicted to make room (ties to the lower slot: a double
             STABLE argsort).

``output`` emits the confirmed, alive slots.  The state lives on the
device of the tensors it was built with; ``export_rows`` /
``rows_to_state`` move it as numpy rows.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..device import resolve_device
from .association import associate, cxcywh_to_xyxy, xyxy_to_cxcywh
from .kalman import init_cov, kf_predict, kf_update


@dataclass(frozen=True)
class TrackerConfig:
    capacity: int = 64         # track-table slots per stream
    iou_thr: float = 0.3       # association gate
    min_hits: int = 2          # matches before a track is emitted
    max_coast: int = 12        # frames without a match before death
    score_decay: float = 0.95  # per-coasted-frame score multiplier
    birth_score_thr: float = 0.0   # detections below never seed tracks
    q: float = 1.0             # process noise intensity (px^2/frame^4)
    r: float = 9.0             # measurement noise variance (px^2)
    p0_vel: float = 25.0       # fresh-track velocity variance


class TrackerState(NamedTuple):
    pos: torch.Tensor        # (B, T, 4) cx, cy, w, h
    vel: torch.Tensor        # (B, T, 4)
    cov: torch.Tensor        # (B, T, 4, 3) [p_xx, p_xv, p_vv] per coord
    score: torch.Tensor      # (B, T) last matched detection score, decayed
    cls: torch.Tensor        # (B, T) int32
    track_id: torch.Tensor   # (B, T) int32 (globally unique per stream)
    hits: torch.Tensor       # (B, T) int32 total matches
    tsu: torch.Tensor        # (B, T) int32 frames since last match
    active: torch.Tensor     # (B, T) bool
    next_id: torch.Tensor    # (B,) int32


def init_state(batch: int, cfg: TrackerConfig, device=None) -> TrackerState:
    """A fresh (B, T) table on ``device`` (None: ``cuda``, raising where
    no CUDA device exists)."""
    device = resolve_device(device)
    B, T = batch, cfg.capacity
    f32, i32 = torch.float32, torch.int32
    return TrackerState(
        pos=torch.zeros((B, T, 4), dtype=f32, device=device),
        vel=torch.zeros((B, T, 4), dtype=f32, device=device),
        cov=torch.zeros((B, T, 4, 3), dtype=f32, device=device),
        score=torch.zeros((B, T), dtype=f32, device=device),
        cls=torch.zeros((B, T), dtype=i32, device=device),
        track_id=torch.full((B, T), -1, dtype=i32, device=device),
        hits=torch.zeros((B, T), dtype=i32, device=device),
        tsu=torch.zeros((B, T), dtype=i32, device=device),
        active=torch.zeros((B, T), dtype=torch.bool, device=device),
        next_id=torch.zeros((B,), dtype=i32, device=device),
    )


def _tick(state: TrackerState, cfg: TrackerConfig) -> TrackerState:
    """One frame of time passing: Kalman predict + coast bookkeeping."""
    pos, vel, cov = kf_predict(state.pos, state.vel, state.cov, cfg.q)
    tsu = state.tsu + state.active.to(torch.int32)
    score = torch.where(state.active, state.score * cfg.score_decay,
                        state.score)
    active = state.active & (tsu <= cfg.max_coast)
    return state._replace(pos=pos, vel=vel, cov=cov, tsu=tsu,
                          score=score, active=active)


def coast(state: TrackerState, cfg: TrackerConfig) -> TrackerState:
    """Advance the table over a frame with no detections (a frame the
    executors never saw)."""
    return _tick(state, cfg)


def _take(x, idx):
    """``take_along_axis(x, idx, axis=1)`` for (B, D[, k]) x and (B, T)
    idx."""
    if x.dim() == 3:
        return torch.gather(x, 1, idx[..., None].expand(*idx.shape,
                                                        x.shape[-1]))
    return torch.gather(x, 1, idx)


def step(state: TrackerState, boxes, scores, classes, valid,
         cfg: TrackerConfig):
    """One detection frame per stream: predict, associate, update,
    birth.

    boxes (B, D, 4) xyxy, scores (B, D), classes (B, D), valid (B, D),
    on the state's device.  Returns (new_state, det_track_id (B, D)
    int32): the track id each detection landed on (matched or newborn),
    -1 for unused slots.
    """
    B, T = state.active.shape
    D = boxes.shape[1]
    dev = state.active.device
    boxes = boxes.float()
    scores = scores.float()
    classes = classes.to(torch.int32)
    valid = valid.bool()

    state = _tick(state, cfg)

    # -------------------------------------------------------- associate
    match = associate(state.pos, state.active, state.cls, boxes, valid,
                      classes, cfg.iou_thr)                  # (B, T)
    matched = match >= 0
    mi = torch.clamp(match, min=0).long()
    z = xyxy_to_cxcywh(_take(boxes, mi))

    # ----------------------------------------------------------- update
    pos, vel, cov = kf_update(state.pos, state.vel, state.cov, z, cfg.r,
                              matched[..., None])
    score = torch.where(matched, _take(scores, mi), state.score)
    hits = state.hits + matched.to(torch.int32)
    tsu = torch.where(matched, torch.zeros_like(state.tsu), state.tsu)

    # ------------------------------------------------------------ birth
    darange = torch.arange(D, dtype=torch.int32, device=dev)
    taken = torch.any((match[..., None] == darange[None, None]) &
                      matched[..., None], dim=1)             # (B, D)
    unmatched = valid & ~taken & (scores >= cfg.birth_score_thr)
    free = ~state.active

    # ---------------------------------------------- overflow eviction
    # the lowest-score coasting tracks give up exactly the missing
    # slots; with no overflow ``need`` is 0 and this is the identity
    need = torch.clamp(unmatched.sum(-1) - free.sum(-1), min=0)[:, None]
    evictable = state.active & ~matched
    key = torch.where(evictable, state.score,
                      torch.full_like(state.score, float("inf")))
    rank = torch.argsort(torch.argsort(key, dim=-1, stable=True), dim=-1,
                         stable=True)                        # (B, T)
    evict = evictable & (rank < need)
    free = free | evict
    ui = unmatched.to(torch.int32)
    fi = free.to(torch.int32)
    d_rank = torch.cumsum(ui, -1, dtype=torch.int32) - ui    # excl. rank
    t_rank = torch.cumsum(fi, -1, dtype=torch.int32) - fi
    pair = (free[:, :, None] & unmatched[:, None, :] &
            (t_rank[:, :, None] == d_rank[:, None, :]))      # (B, T, D)
    birth = torch.any(pair, -1)                              # (B, T)
    bidx = torch.argmax(pair.to(torch.int32), -1)            # first det
    bz = xyxy_to_cxcywh(_take(boxes, bidx))
    b3 = birth[..., None]
    pos = torch.where(b3, bz, pos)
    vel = torch.where(b3, torch.zeros_like(vel), vel)
    cov = torch.where(b3[..., None],
                      init_cov((B, T, 4), cfg.r, cfg.p0_vel, device=dev),
                      cov)
    score = torch.where(birth, _take(scores, bidx), score)
    cls = torch.where(birth, _take(classes, bidx), state.cls)
    new_id = state.next_id[:, None] + t_rank
    track_id = torch.where(birth, new_id, state.track_id)
    next_id = state.next_id + birth.sum(-1, dtype=torch.int32)
    hits = torch.where(birth, torch.ones_like(hits), hits)
    tsu = torch.where(birth, torch.zeros_like(tsu), tsu)
    active = (state.active & ~evict) | birth

    # which track id each detection landed on (matched or newborn)
    m_onehot = (match[..., None] == darange[None, None]) & matched[..., None]
    det_tid = torch.amax(
        torch.where(m_onehot | pair, track_id[..., None],
                    torch.full_like(track_id[..., None], -1)), dim=1)
    det_tid = torch.where(valid, det_tid, torch.full_like(det_tid, -1))

    return state._replace(pos=pos, vel=vel, cov=cov, score=score,
                          cls=cls, track_id=track_id, hits=hits,
                          tsu=tsu, active=active,
                          next_id=next_id), det_tid


def export_rows(state: TrackerState) -> list:
    """Split the (B, T) table into B portable per-stream rows: plain
    dicts of numpy copies (one entry per ``TrackerState`` field, the
    batch axis stripped).  ``rows_to_state`` rebuilds a table from any
    subset/reordering of them bit-identically."""
    arrs = {f: getattr(state, f).cpu().numpy()
            for f in TrackerState._fields}
    B = arrs["active"].shape[0]
    return [{f: arrs[f][b].copy() for f in TrackerState._fields}
            for b in range(B)]


def rows_to_state(rows, cfg: TrackerConfig, device=None) -> TrackerState:
    """Rebuild a (B, T) table on ``device`` (as in ``init_state``) from
    ``len(rows)`` portable rows; a None entry seeds that batch row fresh
    (== ``init_state``)."""
    device = resolve_device(device)
    fresh = init_state(len(rows), cfg, device=device)
    if all(r is None for r in rows):
        return fresh
    cols = {f: getattr(fresh, f).cpu().numpy().copy()
            for f in TrackerState._fields}
    for b, r in enumerate(rows):
        if r is None:
            continue
        for f in TrackerState._fields:
            cols[f][b] = r[f]
    return TrackerState(**{f: torch.from_numpy(v).to(device)
                           for f, v in cols.items()})


def output(state: TrackerState, cfg: TrackerConfig):
    """Emit the confirmed, alive tracks: (boxes (B, T, 4) xyxy, scores,
    classes, track ids, valid)."""
    emit = state.active & (state.hits >= cfg.min_hits)
    return (cxcywh_to_xyxy(state.pos), state.score, state.cls,
            state.track_id, emit)

