"""The port's lockstep tracker against the JAX package on the CPU:
multi-tick ``step``/``coast`` traces from the same numpy inputs, with
the discrete fields (``track_id``, ``active``, ``hits``, ``tsu``,
``next_id``, ``det_tid``, ``cls``) exactly equal and the Kalman floats
(``pos``/``vel``/``cov``/``score``) within rtol 1e-5 (XLA fuses and
reorders the float32 arithmetic; PyTorch runs it op by op)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.tracking import kalman as jkal
from repro.tracking import tracker as jtrk
from repro_torch.tracking import kalman as tkal
from repro_torch.tracking import tracker as ttrk

RTOL = 1e-5
DISCRETE = ("cls", "track_id", "hits", "tsu", "active", "next_id")
FLOATS = ("pos", "vel", "cov", "score")


def assert_states_match(sj, st, where=""):
    for f in DISCRETE:
        np.testing.assert_array_equal(getattr(st, f).numpy(),
                                      np.array(getattr(sj, f)),
                                      err_msg=f"{where} {f}")
    for f in FLOATS:
        np.testing.assert_allclose(getattr(st, f).numpy(),
                                   np.array(getattr(sj, f)), rtol=RTOL,
                                   atol=1e-5, err_msg=f"{where} {f}")


def _frame(rng, base, t, B, D, jump=False):
    xy = base + 3.0 * t + rng.normal(0, 1.0, base.shape)
    if jump:
        xy = rng.uniform(0, 300, base.shape)
    boxes = np.concatenate([xy, xy + 25.0], -1).astype(np.float32)
    scores = rng.uniform(0.05, 1.0, (B, D)).astype(np.float32)
    classes = rng.integers(0, 2, (B, D)).astype(np.int32)
    valid = rng.uniform(size=(B, D)) < 0.85
    return boxes, scores, classes, valid


def _run_trace(cfg_kw, B, D, ticks, seed, coast_every=4, jump_at=()):
    cfg_j = jtrk.TrackerConfig(**cfg_kw)
    cfg_t = ttrk.TrackerConfig(**cfg_kw)
    rng = np.random.default_rng(seed)
    sj, st = jtrk.init_state(B, cfg_j), ttrk.init_state(B, cfg_t, device="cpu")
    base = rng.uniform(0, 300, (B, D, 2))
    for t in range(ticks):
        if coast_every and t % coast_every == coast_every - 1:
            sj, st = jtrk.coast(sj, cfg_j), ttrk.coast(st, cfg_t)
        else:
            args = _frame(rng, base, t, B, D, jump=t in jump_at)
            sj, dj = jtrk.step(sj, *map(jnp.asarray, args), cfg_j)
            st, dt = ttrk.step(st, *map(torch.from_numpy, args), cfg_t)
            np.testing.assert_array_equal(dt.numpy(), np.array(dj),
                                          err_msg=f"tick {t} det_tid")
        assert_states_match(sj, st, f"tick {t}")
        for a, b in zip(jtrk.output(sj, cfg_j), ttrk.output(st, cfg_t)):
            np.testing.assert_allclose(b.numpy(), np.array(a), rtol=RTOL,
                                       atol=1e-5)
    return sj, st


@pytest.mark.parametrize("B,D,ticks", [(1, 6, 10), (3, 5, 14), (8, 9, 8)])
def test_step_coast_trace_matches_reference(B, D, ticks):
    sj, _ = _run_trace({}, B, D, ticks, seed=B, jump_at=(5,))
    assert int(np.array(sj.next_id).sum()) > 0


def test_overflow_eviction_matches_reference():
    """More unmatched detections than free slots: the lowest-score
    coasting tracks are evicted (double stable argsort rank), every
    eviction reborn; a scene jump each few ticks forces it."""
    sj, st = _run_trace(dict(capacity=6, max_coast=20), 3, 5, 12,
                        seed=9, coast_every=0, jump_at=(3, 6, 9))
    # the table overflowed: ids were handed out past the capacity
    assert (np.array(sj.next_id) > 6).all()


def test_eviction_ties_break_to_the_lower_slot():
    """Equal coasting scores: rank ties go to the lower slot index, so
    the stable argsort matters."""
    cfg_kw = dict(capacity=4, max_coast=20, score_decay=1.0)
    cfg_j, cfg_t = jtrk.TrackerConfig(**cfg_kw), ttrk.TrackerConfig(**cfg_kw)
    B, D = 1, 4
    sj, st = jtrk.init_state(B, cfg_j), ttrk.init_state(B, cfg_t, device="cpu")
    first = np.array([[[0, 0, 10, 10], [50, 0, 60, 10], [100, 0, 110, 10],
                       [150, 0, 160, 10]]], np.float32)
    scores = np.full((B, D), 0.5, np.float32)
    classes = np.zeros((B, D), np.int32)
    valid = np.ones((B, D), bool)
    far = first + 500.0
    for boxes, v in ((first, valid), (far, np.array([[1, 1, 0, 0]], bool))):
        args = (boxes, scores, classes, v)
        sj, dj = jtrk.step(sj, *map(jnp.asarray, args), cfg_j)
        st, dt = ttrk.step(st, *map(torch.from_numpy, args), cfg_t)
        np.testing.assert_array_equal(dt.numpy(), np.array(dj))
        assert_states_match(sj, st)
    np.testing.assert_array_equal(st.track_id.numpy(), [[4, 5, 2, 3]])


def test_export_rows_round_trip():
    _, st = _run_trace({}, 3, 4, 6, seed=4)
    cfg = ttrk.TrackerConfig()
    rows = ttrk.export_rows(st)
    assert len(rows) == 3 and set(rows[0]) == set(ttrk.TrackerState._fields)
    back = ttrk.rows_to_state(rows, cfg, device="cpu")
    for f in ttrk.TrackerState._fields:
        assert torch.equal(getattr(back, f), getattr(st, f)), f
    # subset + reorder + a fresh row, like the reference
    sub = ttrk.rows_to_state([rows[2], None, rows[0]], cfg,
                              device="cpu")
    ref = jtrk.rows_to_state([rows[2], None, rows[0]], jtrk.TrackerConfig())
    for f in ttrk.TrackerState._fields:
        np.testing.assert_array_equal(getattr(sub, f).numpy(),
                                      np.array(getattr(ref, f)), err_msg=f)
    fresh = ttrk.rows_to_state([None, None], cfg, device="cpu")
    assert not fresh.active.any() and (fresh.track_id == -1).all()


def test_kalman_predict_update_match_reference():
    rng = np.random.default_rng(1)
    pos = rng.normal(0, 50, (2, 5, 4)).astype(np.float32)
    vel = rng.normal(0, 2, (2, 5, 4)).astype(np.float32)
    cov = np.abs(rng.normal(1, 0.5, (2, 5, 4, 3))).astype(np.float32)
    z = rng.normal(0, 50, (2, 5, 4)).astype(np.float32)
    gate = rng.uniform(size=(2, 5, 1)) < 0.5
    pj = jkal.kf_predict(*map(jnp.asarray, (pos, vel, cov)), 1.0)
    pt = tkal.kf_predict(*map(torch.from_numpy, (pos, vel, cov)), 1.0)
    for a, b in zip(pj, pt):
        np.testing.assert_allclose(b.numpy(), np.array(a), rtol=RTOL)
    uj = jkal.kf_update(*map(jnp.asarray, (pos, vel, cov, z)), 9.0,
                        jnp.asarray(gate))
    ut = tkal.kf_update(*map(torch.from_numpy, (pos, vel, cov, z)), 9.0,
                        torch.from_numpy(gate))
    for a, b in zip(uj, ut):
        np.testing.assert_allclose(b.numpy(), np.array(a), rtol=RTOL)
    np.testing.assert_array_equal(
        tkal.init_cov((2, 3, 4), 9.0, 25.0, device="cpu").numpy(),
        np.array(jkal.init_cov((2, 3, 4), 9.0, 25.0)))
