"""The port's kernel tier against the JAX package, on the CPU: the plain
PyTorch versions of batched NMS and greedy association must equal the
reference's XLA twins (and the oracles) exactly on every case, and the
Pallas kernels (interpret mode) on one small case each.  The CUDA
kernels themselves are held against these plain versions on the card
by ``chip_smoke.py``."""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import association as jassoc
from repro.kernels import nms as jnms
from repro.kernels import ref as jref
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.association import greedy_assign_torch
from repro_torch.kernels.nms import TILE, batched_nms_torch


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def _boxes(rng, shape, span=1.0, max_wh=0.35):
    xy = rng.uniform(0, span, shape + (2,))
    wh = rng.uniform(0, max_wh * span, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _nms_case(kind, B, A, seed):
    rng = np.random.default_rng(seed)
    boxes = _boxes(rng, (B, A))
    scores = rng.uniform(0, 1, (B, A)).astype(np.float32)
    if kind == "ties":
        scores[:, 1::2] = scores[:, ::2][:, :scores[:, 1::2].shape[1]]
        boxes[:, 1::4] = boxes[:, ::4][:, :boxes[:, 1::4].shape[1]]
    elif kind == "zero_area":
        boxes[:, ::3, 2:] = boxes[:, ::3, :2]
    elif kind == "mixed_tile":
        # few positives above score_thr, the rest below it: the first
        # tile holds both, so zero-score candidates survive inside it
        scores = np.where(rng.uniform(size=(B, A)) < 0.15,
                          rng.uniform(0.4, 1.0, (B, A)),
                          rng.uniform(0.0, 0.39, (B, A))).astype(np.float32)
    return boxes, scores


def _jax_nms(boxes, scores, **kw):
    k, v = jnms.batched_nms_xla(_j(boxes), _j(scores), **kw)
    return np.array(k), np.array(v)


def _port_nms(boxes, scores, **kw):
    k, v = ops.batched_nms(_t(boxes), _t(scores), **kw)
    assert k.dtype == torch.int32 and v.dtype == torch.bool
    return k.numpy(), v.numpy()


# ----------------------------------------------------------------- NMS
@pytest.mark.parametrize(
    "B,A,score_thr,stop_at_zero",
    [(B, A, thr, sz) for (B, A), thr, sz in itertools.product(
        [(1, 7), (3, 160), (8, 200)], [None, 0.4], [False, True])])
def test_nms_plain_equals_xla_twin(B, A, score_thr, stop_at_zero):
    boxes, scores = _nms_case("random", B, A, seed=B * 1000 + A)
    kw = dict(iou_thr=0.5, score_thr=score_thr, max_out=32,
              stop_at_zero=stop_at_zero)
    kj, vj = _jax_nms(boxes, scores, **kw)
    kt, vt = _port_nms(boxes, scores, **kw)
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(vt, vj)


@pytest.mark.parametrize("kind", ["ties", "zero_area", "mixed_tile"])
@pytest.mark.parametrize("stop_at_zero", [False, True])
def test_nms_plain_edge_cases_equal_xla_twin(kind, stop_at_zero):
    boxes, scores = _nms_case(kind, 3, 100, seed=7)
    kw = dict(iou_thr=0.5, score_thr=0.4, max_out=32,
              stop_at_zero=stop_at_zero)
    kj, vj = _jax_nms(boxes, scores, **kw)
    kt, vt = _port_nms(boxes, scores, **kw)
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(vt, vj)


def test_nms_zero_score_survivor_in_a_positive_tile():
    """A tile whose first score is > 0 is processed whole: a zero-score
    candidate in it survives and takes a keep slot (``valid`` counts
    it), exactly like the reference."""
    A = 2 * TILE
    boxes = np.zeros((1, A, 4), np.float32)
    boxes[0, :, 0] = np.arange(A) * 10.0        # disjoint boxes
    boxes[0, :, 2] = boxes[0, :, 0] + 5.0
    boxes[0, :, 3] = 5.0
    scores = np.full((1, A), 0.1, np.float32)   # below score_thr
    scores[0, :3] = [0.9, 0.8, 0.7]
    kw = dict(iou_thr=0.5, score_thr=0.4, max_out=48, stop_at_zero=True)
    kj, vj = _jax_nms(boxes, scores, **kw)
    kt, vt = _port_nms(boxes, scores, **kw)
    np.testing.assert_array_equal(kt, kj)
    np.testing.assert_array_equal(vt, vj)
    assert vt.sum() == TILE                     # whole first tile, no more
    assert (kt[0, TILE:] == 0).all()            # unused slots hold 0


@pytest.mark.parametrize("max_out", [1, 5, 64])
def test_nms_plain_equals_oracle(max_out):
    boxes, scores = _nms_case("random", 3, 70, seed=max_out)
    kt, vt = batched_nms_torch(_t(boxes), _t(scores), iou_thr=0.5,
                               score_thr=0.4, max_out=max_out)
    ko, vo = tref.batched_nms_ref(_t(boxes), _t(scores), iou_thr=0.5,
                                  max_out=max_out, score_thr=0.4)
    kj, vj = jref.batched_nms_ref(_j(boxes), _j(scores), iou_thr=0.5,
                                  max_out=max_out, score_thr=0.4)
    np.testing.assert_array_equal(ko.numpy(), np.array(kj))
    np.testing.assert_array_equal(vo.numpy(), np.array(vj))
    np.testing.assert_array_equal(kt.numpy(), ko.numpy())
    np.testing.assert_array_equal(vt.numpy(), vo.numpy())


@pytest.mark.parametrize("stop_at_zero", [False, True])
def test_nms_plain_equals_pallas_interpret(stop_at_zero):
    """One small case through the Pallas kernel as the JAX package's own
    tests run it.  With ``stop_at_zero`` the Pallas kernel leaves the
    indices of never-visited candidates in the slots past ``valid``
    where the XLA twin (and the port) leave 0, so there only the valid
    slots are compared."""
    boxes, scores = _nms_case("mixed_tile", 2, 70, seed=3)
    kw = dict(iou_thr=0.5, score_thr=0.4, max_out=16,
              stop_at_zero=stop_at_zero)
    kp, vp = jnms.batched_nms_pallas(_j(boxes), _j(scores), interpret=True,
                                     **kw)
    kp, vp = np.array(kp), np.array(vp)
    kt, vt = _port_nms(boxes, scores, **kw)
    np.testing.assert_array_equal(vt, vp)
    if stop_at_zero:
        np.testing.assert_array_equal(np.where(vt, kt, -1),
                                      np.where(vp, kp, -1))
    else:
        np.testing.assert_array_equal(kt, kp)


# --------------------------------------------------------- association
def _assign_case(B, T, D, seed, p_t=0.8, p_d=0.8, n_cls=2):
    rng = np.random.default_rng(seed)
    tb = _boxes(rng, (B, T), span=100.0, max_wh=0.4)
    db = (tb[:, rng.integers(0, T, D)] +
          rng.normal(0, 4, (B, D, 4))).astype(np.float32)
    if D >= 4:
        db[:, D - 2:] = db[:, :2]                       # duplicate dets
    tm = rng.uniform(size=(B, T)) < p_t
    dm = rng.uniform(size=(B, D)) < p_d
    tc = rng.integers(0, n_cls, (B, T)).astype(np.int32)
    dc = rng.integers(0, n_cls, (B, D)).astype(np.int32)
    return tb, db, tm, dm, tc, dc


@pytest.mark.parametrize("B,T,D,p_t,p_d,n_cls", [
    (1, 8, 8, 1.0, 1.0, 1),          # no masks, no class gate
    (3, 13, 11, 0.8, 0.8, 2),        # T/D not multiples of 8
    (4, 64, 32, 0.5, 0.9, 3),        # the engine's shapes
    (2, 5, 40, 1.0, 0.6, 2),         # T < D
    (2, 7, 9, 0.0, 1.0, 1),          # every track slot dead
])
def test_assign_plain_equals_xla_twin_and_oracle(B, T, D, p_t, p_d, n_cls):
    case = _assign_case(B, T, D, seed=B * 100 + T, p_t=p_t, p_d=p_d,
                        n_cls=n_cls)
    mj = np.array(jassoc.greedy_assign_xla(*map(_j, case), iou_thr=0.3))
    tb, db, tm, dm, tc, dc = map(_t, case)
    mt = ops.greedy_assign(tb, db, t_mask=tm, d_mask=dm, t_cls=tc,
                           d_cls=dc, iou_thr=0.3)
    mo = tref.greedy_assign_ref(tb, db, tm, dm, tc, dc, iou_thr=0.3)
    assert mt.dtype == torch.int32
    np.testing.assert_array_equal(mt.numpy(), mj)
    np.testing.assert_array_equal(mo.numpy(), mj)


def test_assign_ties_take_the_first_row_major_pair():
    """Equal costs: the lowest flat index (row-major) wins, like the
    reference argmax."""
    box = np.array([0, 0, 10, 10], np.float32)
    tb = np.stack([box, box, box])[None]
    db = np.stack([box, box])[None]
    ones = lambda n: np.ones((1, n), bool)                  # noqa: E731
    zeros = lambda n: np.zeros((1, n), np.int32)            # noqa: E731
    case = (tb, db, ones(3), ones(2), zeros(3), zeros(2))
    mj = np.array(jassoc.greedy_assign_xla(*map(_j, case), iou_thr=0.3))
    mt = greedy_assign_torch(*map(_t, case), iou_thr=0.3).numpy()
    np.testing.assert_array_equal(mt, mj)
    np.testing.assert_array_equal(mt, [[0, 1, -1]])


def test_assign_default_masks_and_classes():
    tb, db, *_ = _assign_case(2, 6, 6, seed=5)
    mj = np.array(jref.greedy_assign_ref(_j(tb), _j(db),
                                         np.ones((2, 6), bool),
                                         np.ones((2, 6), bool)))
    mt = ops.greedy_assign(_t(tb), _t(db), iou_thr=0.3)
    np.testing.assert_array_equal(mt.numpy(), mj)
    empty = ops.greedy_assign(_t(tb), _t(db)[:, :0])
    np.testing.assert_array_equal(empty.numpy(), np.full((2, 6), -1))


def test_assign_plain_equals_pallas_interpret():
    case = _assign_case(2, 10, 7, seed=11)
    mp = np.array(jassoc.greedy_assign_pallas(*map(_j, case), iou_thr=0.3,
                                              interpret=True))
    mt = greedy_assign_torch(*map(_t, case), iou_thr=0.3)
    np.testing.assert_array_equal(mt.numpy(), mp)


def test_iou_matrix_ref_equals_reference():
    rng = np.random.default_rng(2)
    a, b = _boxes(rng, (9,)), _boxes(rng, (5,))
    a[0, 2:] = a[0, :2]                                     # zero area
    np.testing.assert_array_equal(
        tref.iou_matrix_ref(_t(a), _t(b)).numpy(),
        np.array(jref.iou_matrix_ref(_j(a), _j(b))))
