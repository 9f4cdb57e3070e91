"""The NaN repair and redesign 4 of the assignment and IoU kernels, on the
CPU.

The three IoU kernels (``csrc/nms.cu``, ``csrc/association.cu``,
``csrc/iou.cu``) now carry NaN through every max and min, as the JAX
package's ``jnp.maximum``/``jnp.clip`` and the port's plain versions
(``torch.maximum``/``torch.clamp``) do.  The kernels cannot run here, so
these tests hold what the repair and the designs rest on:

* the plain versions equal the JAX package on boxes with NaN, +-inf and
  -0.0 coordinates, in live and in masked slots: ``iou_matrix_torch``
  against ``ref.iou_matrix_ref`` exactly and the Pallas ``iou_matrix``
  (interpret) at the reference's kernel tolerance, NaN at the same
  places; ``greedy_assign_torch`` against ``greedy_assign_xla`` and
  ``greedy_assign_pallas``; ``batched_nms_torch`` against
  ``batched_nms_xla`` and ``batched_nms_pallas``;
* a numpy emulation of the new assignment kernel (a cost row over G
  lanes, the row-best cache under its order keys, the one-warp argmax, the
  ballot of rows whose best column is retired and whose cached best
  still passes ``iou_thr``, and their recompute)
  equals ``greedy_assign_torch`` for every ``iou_thr`` tried, ties, NaN
  and masks included;
* an emulation of the IoU kernel's strip map (a CTA a tile of 128
  columns by 64, 16 or 8 rows, four columns a lane, a scalar head and tail around 16-byte
  stores where a row does not start on 16 bytes) writes every element
  once, each vector store on 16 bytes, and equals ``iou_matrix_torch``
  bit for bit;
* the wrappers hand ready operands to the launcher untouched and launch
  once.

The emulations live here, not in the package: the package's CPU path is
the plain version.  chip_smoke.py's ``[nan]`` phase holds the kernels
themselves to the plain versions on the card."""
import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.kernels import association as jassoc
from repro.kernels import nms as jnms
from repro.kernels import ref as jref
from repro.kernels.iou import iou_matrix as jiou_pallas
from repro_torch.kernels import association as kassoc
from repro_torch.kernels import build
from repro_torch.kernels import iou as kiou
from repro_torch.kernels import nms as knms
from repro_torch.kernels.association import greedy_assign_torch
from repro_torch.kernels.iou import iou_matrix_torch
from repro_torch.kernels.nms import _pair_iou, batched_nms_torch

try:
    from hypothesis import given, settings, strategies as st
except ModuleNotFoundError:      # optional dep — see requirements-dev.txt
    given = None

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)

ODD = smoke.ODD_BOXES          # NaN, +-inf and -0.0 coordinates
THRESHOLDS = (-1.0, 0.0, 0.3, 1.0)


def _t(a):
    return torch.from_numpy(np.array(a))


def _j(a):
    return jnp.asarray(np.array(a))


def _boxes(rng, shape, span=10.0, max_wh=0.3):
    xy = rng.uniform(0, span, shape + (2,))
    wh = rng.uniform(0, max_wh * span, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _with_odd(rng, shape, share=0.25, span=10.0):
    """Random boxes, ``share`` of them replaced by ``ODD`` boxes."""
    b = _boxes(rng, shape, span)
    pick = rng.uniform(size=shape) < share
    b[pick] = ODD[rng.integers(0, len(ODD), int(pick.sum()))] * (span / 10)
    return b


# ------------------------------------------- plain versions vs the JAX ones
def test_iou_of_the_nan_box_is_nan_in_every_tier():
    a, b = ODD[:1], ODD[1:3]
    want = np.array(jref.iou_matrix_ref(_j(a), _j(b)))
    assert np.isnan(want).all()
    assert np.isnan(iou_matrix_torch(_t(a), _t(b)).numpy()).all()
    assert np.isnan(np.array(jiou_pallas(_j(a), _j(b), interpret=True))).all()


@pytest.mark.parametrize("n,m,seed", [(12, 12, 0), (37, 29, 1), (29, 37, 2),
                                      (5, 130, 3)])
def test_iou_plain_equals_the_reference_on_odd_boxes(n, m, seed):
    rng = np.random.default_rng(seed)
    a, b = _with_odd(rng, (n,)), _with_odd(rng, (m,))
    a[:min(n, len(ODD))] = ODD[:n]            # every odd box against both
    b[-min(m, len(ODD)):] = ODD[:m]
    got = iou_matrix_torch(_t(a), _t(b)).numpy()
    assert np.isnan(got).any() and np.isfinite(got).any()
    oracle = np.array(jref.iou_matrix_ref(_j(a), _j(b)))
    np.testing.assert_array_equal(got, oracle)        # NaN where NaN
    pallas = np.array(jiou_pallas(_j(a), _j(b), interpret=True))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(pallas))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-6)


NMS_KW = {
    "engine": dict(iou_thr=0.5, score_thr=0.4, max_out=32,
                   stop_at_zero=True),
    "no thr": dict(iou_thr=0.5, score_thr=None, max_out=70,
                   stop_at_zero=False),
    "low iou": dict(iou_thr=0.1, score_thr=None, max_out=16,
                    stop_at_zero=False),
}


def test_nms_example_keeps_the_nan_box_and_suppresses_by_the_rest():
    """The NaN box's IoU is NaN, which is not >= iou_thr: it suppresses
    nothing, and box 1 still suppresses box 2."""
    boxes = np.float32([[[np.nan, 0, 10, 10], [0, 0, 10, 10],
                         [1, 1, 10, 10], [50, 50, 60, 60]]])
    scores = np.float32([[0.9, 0.8, 0.7, 0.6]])
    kw = dict(iou_thr=0.5, max_out=4)
    for k, v in (jnms.batched_nms_xla(_j(boxes), _j(scores), **kw),
                 jnms.batched_nms_pallas(_j(boxes), _j(scores), **kw),
                 batched_nms_torch(_t(boxes), _t(scores), **kw)):
        assert np.array(k)[0, :3].tolist() == [0, 1, 3]
        assert np.array(v)[0].tolist() == [True, True, True, False]


@pytest.mark.parametrize("mode", sorted(NMS_KW))
@pytest.mark.parametrize("seed", [0, 1])
def test_nms_plain_equals_the_reference_on_odd_boxes(mode, seed):
    rng = np.random.default_rng(10 + seed)
    boxes = _with_odd(rng, (3, 70), span=1.0)
    scores = rng.uniform(0, 1, (3, 70)).astype(np.float32)
    kw = NMS_KW[mode]
    keep, valid = (x.numpy() for x in batched_nms_torch(
        _t(boxes), _t(scores), **kw))
    jk, jv = jnms.batched_nms_xla(_j(boxes), _j(scores), **kw)
    np.testing.assert_array_equal(keep, np.array(jk))
    np.testing.assert_array_equal(valid, np.array(jv))
    pk, pv = jnms.batched_nms_pallas(_j(boxes), _j(scores), **kw)
    np.testing.assert_array_equal(valid, np.array(pv))
    # under stop_at_zero the Pallas kernel leaves other indices past
    # `valid` (ROADMAP, reference behaviours): compare the valid slots
    np.testing.assert_array_equal(np.where(valid, keep, 0),
                                  np.where(valid, np.array(pk), 0))


def _odd_assign_frames(seed, T=13, D=11):
    """Frame 0: the NaN box in a live pair; 1: in a masked track slot
    and a masked detection slot; 2: tracks with an infinite side; 3: a
    -0.0 track box on the same box with +0.0 corners; 4: odd boxes of
    every kind anywhere, masks random."""
    rng = np.random.default_rng(seed)
    B = 5
    tb = _boxes(rng, (B, T))
    db = tb[:, rng.integers(0, T, D)] + rng.normal(
        0, 0.3, (B, D, 4)).astype(np.float32)
    tm = rng.uniform(size=(B, T)) < 0.8
    dm = rng.uniform(size=(B, D)) < 0.9
    tc = rng.integers(0, 2, (B, T)).astype(np.int32)
    dc = rng.integers(0, 2, (B, D)).astype(np.int32)
    tb[:2, 0] = ODD[0]
    tm[0, 0], dm[0, 0], dc[0, 0] = True, True, tc[0, 0]
    tm[1, 0] = False
    db[1, 1], dm[1, 1] = ODD[8], False
    tb[2, ::3] = ODD[3]
    tb[2, 1::3] = ODD[5]
    tb[3, :2], db[3, :2] = ODD[7], ODD[2]
    tm[3, :2], dm[3, :2], dc[3, :2] = True, True, tc[3, :2]
    tb[4], db[4] = _with_odd(rng, (T,)), _with_odd(rng, (D,))
    return tb, db, tm, dm, tc, dc


@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("seed", [0, 1])
def test_assign_plain_equals_the_reference_on_odd_boxes(thr, seed):
    x = _odd_assign_frames(seed)
    got = greedy_assign_torch(*(_t(a) for a in x), iou_thr=thr).numpy()
    xla = np.array(jassoc.greedy_assign_xla(*(_j(a) for a in x),
                                            iou_thr=thr))
    pallas = np.array(jassoc.greedy_assign_pallas(*(_j(a) for a in x),
                                                  iou_thr=thr,
                                                  interpret=True))
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pallas)
    assert (got[0] == -1).all()            # a live NaN: nothing committed
    if thr <= 0.3:
        assert (got[1] >= 0).any()         # a masked NaN stops nothing


# ----------------------------------------- the assignment kernel, emulated
def order_key(v):
    """association.cu's order_key: uint32 keys whose order is the
    reference's argmax order (NaN above all, -0.0 == 0.0)."""
    v = np.asarray(v, np.float32)
    v = np.where(v == 0, np.float32(0), v)
    b = v.view(np.uint32)
    k = np.where(b & np.uint32(0x80000000), ~b, b | np.uint32(0x80000000))
    return np.where(np.isnan(v), np.uint32(0xFFFFFFFF), k).astype(np.uint32)


def key_value(k):
    """association.cu's key_value: the float a key stands for."""
    k = np.uint32(k)
    b = k & np.uint32(0x7FFFFFFF) if k & np.uint32(0x80000000) else ~k
    return np.uint32(b).view(np.float32)


def box_iou_np(t, d, skip_zero=True):
    """common.cuh's box_iou over (T, 4) x (D, 4) float32 boxes, one
    float32 rounding an operation, NaN carried by every max; a zero
    intersection over a number is returned as it is, undivided, where
    ``skip_zero``."""
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        ix0 = np.maximum(t[:, None, 0], d[None, :, 0])
        iy0 = np.maximum(t[:, None, 1], d[None, :, 1])
        ix1 = np.minimum(t[:, None, 2], d[None, :, 2])
        iy1 = np.minimum(t[:, None, 3], d[None, :, 3])
        inter = (np.maximum(ix1 - ix0, np.float32(0)) *
                 np.maximum(iy1 - iy0, np.float32(0)))
        ta = (t[:, 2] - t[:, 0]) * (t[:, 3] - t[:, 1])
        da = (d[:, 2] - d[:, 0]) * (d[:, 3] - d[:, 1])
        den = np.maximum(ta[:, None] + da[None, :] - inter, np.float32(1e-9))
        q = inter / den
        if skip_zero:
            q = np.where((inter == 0) & (den == den), inter, q)
        return q


def test_a_zero_intersection_needs_no_division():
    """box_iou returns a zero intersection undivided unless the divisor
    is NaN: bit for bit what the division gives, -0.0 and infinite
    divisors included."""
    rng = np.random.default_rng(4)
    t = np.concatenate([ODD, _boxes(rng, (30,))])
    t[::7, 2] = t[::7, 0]                    # zero width: inter = 0
    t[1::7, 2] = -0.0 * t[1::7, 0]
    d = np.concatenate([_with_odd(rng, (25,)), ODD])
    got, want = box_iou_np(t, d), box_iou_np(t, d, skip_zero=False)
    assert (got == 0).sum() > 100 and np.isnan(want).any()
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got.view(np.uint32)[ok],
                                  want.view(np.uint32)[ok])
    np.testing.assert_array_equal(got, iou_matrix_torch(_t(t), _t(d)).numpy())


def warp_first_max(keys, n):
    """A warp's (key, index) of the first maximum of ``keys[:n]``: lane
    l scans l, l + 32, ... keeping its first maximum, then the largest
    key and the lowest index among the lanes holding it."""
    lane_k = np.zeros(32, np.uint32)
    lane_i = np.full(32, n)
    for lane in range(32):
        for i in range(lane, n, 32):
            if keys[i] > lane_k[lane]:
                lane_k[lane], lane_i[lane] = keys[i], i
    top = lane_k.max()
    return top, int(lane_i[lane_k == top].min())


def group_first_max(keys, n, G):
    """The kernel's build: G lanes a row, lane q scanning columns q, q +
    G, ... for its first maximum, then an xor-shuffle tree over the G
    lanes keeping the larger key, the lower column among equal keys."""
    lane_k = np.zeros(G, np.uint32)
    lane_j = np.full(G, n)
    for q in range(G):
        for j in range(q, n, G):
            if keys[j] > lane_k[q]:
                lane_k[q], lane_j[q] = keys[j], j
    o = G // 2
    while o:
        ok, oj = lane_k[np.arange(G) ^ o], lane_j[np.arange(G) ^ o]
        take = (ok > lane_k) | ((ok == lane_k) & (oj < lane_j))
        lane_k, lane_j = np.where(take, ok, lane_k), np.where(take, oj, lane_j)
        o //= 2
    assert (lane_k == lane_k[0]).all() and (lane_j == lane_j[0]).all()
    return lane_k[0], int(lane_j[0])


def build_lanes(T, threads=1024):
    """G, the kernel's lanes a row: 32, halved while G T > threads."""
    G = 32
    while G > 1 and G * T > threads:
        G //= 2
    return G


def assign_emulated(tb, db, tm, dm, tc, dc, iou_thr):
    """association.cu's assign_kernel, step for step."""
    B, T = tm.shape
    D = dm.shape[1]
    thr = np.float32(iou_thr)
    match = np.full((B, T), -1, np.int32)
    retired = order_key(-1.0)
    for b in range(B):
        ok = (tm[b][:, None] & dm[b][None, :] &
              (tc[b][:, None] == dc[b][None, :]))
        cost = np.where(ok, box_iou_np(tb[b], db[b]), np.float32(-1))
        G = build_lanes(T)
        rows = [group_first_max(order_key(cost[i]), D, G) for i in range(T)]
        best_key = np.array([k for k, _ in rows], np.uint32)
        best_col = np.array([c for _, c in rows])
        for _ in range(min(T, D)):
            top, i = warp_first_max(best_key, T)
            if not key_value(top) >= thr:
                break
            j = best_col[i]
            match[b, i] = j
            cost[i, :] = -1
            cost[:, j] = -1
            for r0 in range(0, T, 32):           # a ballot a 32 rows
                todo = [r for r in range(r0, min(r0 + 32, T))
                        if r != i and best_col[r] == j
                        and key_value(best_key[r]) >= thr]
                for q in todo:
                    best_key[q], best_col[q] = warp_first_max(
                        order_key(cost[q]), D)
            best_key[i], best_col[i] = retired, 0
    return match


def _assign_case(seed, B, T, D, *, ties=False, p_t=0.8, p_d=0.8,
                 live_nan=False, odd=False):
    rng = np.random.default_rng(seed)
    tb = _boxes(rng, (B, T))
    if ties:                       # integer corners: many equal IoUs
        tb = np.round(tb).astype(np.float32)
        tb[..., 2:] = np.maximum(tb[..., 2:], tb[..., :2] + 1)
    db = tb[:, rng.integers(0, T, D)].copy()
    if not ties:
        db += rng.normal(0, 0.3, (B, D, 4)).astype(np.float32)
    tm = rng.uniform(size=(B, T)) < p_t
    dm = rng.uniform(size=(B, D)) < p_d
    tc = rng.integers(0, 2, (B, T)).astype(np.int32)
    dc = rng.integers(0, 2, (B, D)).astype(np.int32)
    if odd:
        tb[0] = _with_odd(rng, (T,))
    if live_nan:
        f, i, j = B - 1, T // 2, D - 1
        tb[f, i] = ODD[0]
        tm[f, i], dm[f, j], dc[f, j] = True, True, tc[f, i]
    return tb, db, tm, dm, tc, dc


ASSIGN_CASES = {
    "engine B=4 T=64 D=32": dict(seed=0, B=4, T=64, D=32, p_t=0.5),
    "ties": dict(seed=1, B=2, T=20, D=20, ties=True),
    "all masked": dict(seed=2, B=2, T=16, D=8, p_t=0.0),
    "T<D": dict(seed=3, B=2, T=5, D=40),
    "T>D": dict(seed=4, B=2, T=70, D=6),
    "T=13 D=11": dict(seed=5, B=3, T=13, D=11),
    "live NaN": dict(seed=6, B=3, T=13, D=11, live_nan=True),
    "odd boxes": dict(seed=7, B=2, T=24, D=17, odd=True),
    "T=1 D=1": dict(seed=8, B=2, T=1, D=1),
}


def check_assign_emulation(x, thr):
    tb, db, tm, dm, tc, dc = x
    ok = _t(tm)[:, :, None] & _t(dm)[:, None, :] & (
        _t(tc)[:, :, None] == _t(dc)[:, None, :])
    plain_cost = torch.where(ok, _pair_iou(_t(tb), _t(db)),
                             torch.tensor(-1.0)).numpy()
    emu_cost = np.stack([np.where(ok[b].numpy(), box_iou_np(tb[b], db[b]),
                                  np.float32(-1)) for b in range(len(tb))])
    np.testing.assert_array_equal(emu_cost.view(np.uint32)[
        ~np.isnan(emu_cost)], plain_cost.view(np.uint32)[
        ~np.isnan(plain_cost)])
    np.testing.assert_array_equal(np.isnan(emu_cost), np.isnan(plain_cost))
    want = greedy_assign_torch(*(_t(a) for a in x), iou_thr=thr).numpy()
    np.testing.assert_array_equal(assign_emulated(*x, thr), want)
    return want


@pytest.mark.parametrize("thr", THRESHOLDS)
@pytest.mark.parametrize("name", sorted(ASSIGN_CASES))
def test_assign_emulation_equals_plain(name, thr):
    want = check_assign_emulation(_assign_case(**ASSIGN_CASES[name]), thr)
    if name == "live NaN":
        assert (want[-1] == -1).all() and (want[0] >= 0).any() == (thr <= .3)
    if name == "all masked":     # -1 everywhere: iou_thr -1 re-commits (0, 0)
        assert (want[:, 1:] == -1).all()
        assert (want[:, 0] == 0).all() == (thr <= -1)


if given is not None:
    @settings(max_examples=40, deadline=None)
    @given(seed=st.integers(0, 10_000), B=st.integers(1, 3),
           T=st.integers(1, 70), D=st.integers(1, 40),
           thr=st.sampled_from(THRESHOLDS), ties=st.booleans(),
           live_nan=st.booleans(), odd=st.booleans(),
           p_t=st.sampled_from((0.0, 0.5, 1.0)))
    def test_assign_emulation_equals_plain_property(seed, B, T, D, thr,
                                                    ties, live_nan, odd,
                                                    p_t):
        check_assign_emulation(_assign_case(
            seed, B, T, D, ties=ties, p_t=p_t, live_nan=live_nan, odd=odd),
            thr)


def test_build_lanes_fill_the_cta():
    assert [build_lanes(T) for T in (1, 13, 32, 33, 64, 65, 1024, 1025,
                                     12288)] == [32, 32, 32, 16, 16, 8, 1,
                                                 1, 1]


def test_order_key_is_the_argmax_order():
    vals = np.float32([np.nan, np.inf, 1e30, 1.0, 0.5, 1e-38, 0.0, -0.0,
                       -1e-38, -1.0, -1e30, -np.inf])
    keys = order_key(vals)
    assert keys[0] == 0xFFFFFFFF and keys[6] == keys[7]
    assert all(keys[i] > keys[i + 1] for i in range(len(vals) - 1)
               if i != 6)
    assert keys.min() > 0                  # 0 stays "no column"
    for v, k in zip(vals, keys):
        back = key_value(k)
        assert np.isnan(back) if np.isnan(v) else back == v


# ----------------------------------------------- the IoU kernel, emulated
K_COLS = 128


def iou_strips_emulated(a, b, tile_rows):
    """iou.cu's store map on a flat output: CTA t computes tile t
    (``tile_rows`` rows by 128 columns), its row r going out as
    store_strip writes it.  Returns the output, the write count of each
    element, and the start of every vector store."""
    N, M = len(a), len(b)
    out = np.zeros(N * M, np.float32)
    writes = np.zeros(N * M, np.int64)
    vec = []
    n_strips = -(-M // K_COLS)
    n_tiles = -(-N // tile_rows) * n_strips

    def put(at, vals, vector):
        out[at:at + len(vals)] = vals
        writes[at:at + len(vals)] += 1
        if vector:
            vec.append(at)

    for t in range(n_tiles):
        i0, j0 = (t // n_strips) * tile_rows, (t % n_strips) * K_COLS
        cols = np.minimum(np.arange(j0, j0 + K_COLS), M - 1)
        rows = min(tile_rows, N - i0)
        vals = box_iou_np(a[i0:i0 + rows], b[cols])
        for r in range(rows):
            start = (i0 + r) * M
            h = (4 - start % 4) % 4
            end = min(j0 + K_COLS, M)
            for lane in range(32):
                c0 = j0 + 4 * lane
                v = vals[r, 4 * lane:4 * lane + 4]
                if h == 0:
                    if c0 + 3 < M:
                        put(start + c0, v, True)
                    else:
                        for k in range(4):
                            if c0 + k < M:
                                put(start + c0 + k, v[k:k + 1], False)
                    continue
                # __shfl_down_sync by 1: lane 31 reads its own values
                nxt = vals[r, 4 * lane + 4:4 * lane + 8] if lane < 31 \
                    else v
                if lane == 0:
                    for k in range(3):
                        if k < h and j0 + k < M:
                            put(start + j0 + k, v[k:k + 1], False)
                w = np.concatenate([v[h:], nxt[:h]])
                g = c0 + h
                if g + 3 < end:
                    put(start + g, w, True)
                else:
                    for k in range(4):
                        if g + k < end:
                            put(start + g + k, w[k:k + 1], False)
    return out.reshape(N, M), writes.reshape(N, M), vec


@pytest.mark.parametrize("N,M", [(160, 160), (161, 157), (1, 5), (5, 1),
                                 (300, 333), (7, 130), (65, 255), (3, 129),
                                 (66, 6)])
@pytest.mark.parametrize("tile_rows", [64, 16, 8])
def test_iou_strip_map_writes_once_and_equals_plain(N, M, tile_rows):
    rng = np.random.default_rng(N * 1000 + M)
    a, b = _boxes(rng, (N,)), _boxes(rng, (M,))
    out, writes, vec = iou_strips_emulated(a, b, tile_rows)
    assert (writes == 1).all()
    assert all(s % 4 == 0 and s // M == (s + 3) // M for s in vec)
    if M % 4 == 0:                     # every row starts on 16 bytes
        assert len(vec) * 4 == N * M
    want = iou_matrix_torch(_t(a), _t(b)).numpy()
    np.testing.assert_array_equal(out.view(np.uint32), want.view(np.uint32))


def test_iou_strip_map_carries_nan():
    rng = np.random.default_rng(3)
    a, b = _with_odd(rng, (67,)), _with_odd(rng, (131,))
    out, writes, _ = iou_strips_emulated(a, b, 16)
    want = iou_matrix_torch(_t(a), _t(b)).numpy()
    assert (writes == 1).all() and np.isnan(want).any()
    np.testing.assert_array_equal(out, want)


# ------------------------------------------------------------- wrappers
class _Recorder:
    """Stands in for a launcher: records its arguments, returns 0."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
        self.ops.append(str(func.overloadpacket.__name__))
        return func(*args, **(kwargs or {}))


@pytest.fixture
def host_path(monkeypatch):
    """The wrappers' host path on CPU tensors: the device check passes,
    the stream is 0, the launcher records.  Launch counters restored."""
    rec = _Recorder()
    monkeypatch.setattr(build, "function", lambda *a, **k: rec)
    monkeypatch.setattr(build, "cuda_device", lambda what, *t: t[0].device)
    monkeypatch.setattr(build, "stream", lambda dev: 0)
    for mod in (kassoc, kiou, knms):
        monkeypatch.setattr(mod, "LAUNCHES", 0)
    return rec


def test_assign_wrapper_passes_ready_operands_untouched(host_path):
    x = tuple(_t(a) for a in _assign_case(**ASSIGN_CASES[
        "engine B=4 T=64 D=32"]))
    with _Ops() as seen:
        kassoc.greedy_assign_cuda(*x, iou_thr=0.3)
    (args,) = host_path.calls
    assert args[:6] == tuple(a.data_ptr() for a in x)
    assert args[6:10] == (4, 64, 32, 0.3) and args[11] == 0
    assert seen.ops == ["empty"] and kassoc.LAUNCHES == 1


def test_assign_wrapper_converts_what_is_not_ready(host_path):
    tb, db, tm, dm, tc, dc = (_t(a) for a in _assign_case(seed=9, B=2, T=6,
                                                          D=5))
    kassoc.greedy_assign_cuda(tb.double(), db, tm.to(torch.uint8), dm,
                              tc.long(), dc, iou_thr=0.3)
    (args,) = host_path.calls
    assert args[0] != tb.data_ptr() and args[2] != tm.data_ptr()
    assert args[1] == db.data_ptr() and args[3] == dm.data_ptr()
    assert args[5] == dc.data_ptr() and kassoc.LAUNCHES == 1


def test_assign_wrapper_launches_nothing_for_an_empty_batch(host_path):
    x = tuple(_t(a)[:0] for a in _assign_case(seed=9, B=2, T=6, D=5))
    match = kassoc.greedy_assign_cuda(*x, iou_thr=0.3)
    assert match.shape == (0, 6) and not host_path.calls
    assert kassoc.LAUNCHES == 0


def test_iou_wrapper_passes_ready_operands_and_aligns_the_rest(host_path):
    rng = np.random.default_rng(0)
    a, b = _t(_boxes(rng, (161,))), _t(_boxes(rng, (157,)))
    with _Ops() as seen:
        out = kiou.iou_matrix_cuda(a, b)
    (args,) = host_path.calls
    assert args[:4] == (a.data_ptr(), b.data_ptr(), 161, 157)
    assert args[4] == out.data_ptr() and out.shape == (161, 157)
    assert seen.ops == ["empty"] and kiou.LAUNCHES == 1
    off = torch.cat([torch.zeros(1), a.reshape(-1)])[1:].reshape(161, 4)
    assert off.data_ptr() % 16 == 4             # float4 loads need 16
    kiou.iou_matrix_cuda(off, b)
    assert host_path.calls[1][0] % 16 == 0 and kiou.LAUNCHES == 2


def test_nms_wrapper_passes_ready_operands_untouched(host_path):
    rng = np.random.default_rng(1)
    boxes = _t(_boxes(rng, (2, 40)))
    scores = _t(rng.uniform(0, 1, (2, 40)).astype(np.float32))
    with _Ops() as seen:
        knms.batched_nms_cuda(boxes, scores, iou_thr=0.5, max_out=8)
    (args,) = host_path.calls
    assert args[:5] == (boxes.data_ptr(), scores.data_ptr(), 2, 40, 8)
    assert seen.ops == ["empty", "empty"] and knms.LAUNCHES == 1


@pytest.mark.parametrize("devices", [("cpu",), ("meta",), ("cpu", "meta")])
def test_cuda_device_refuses_other_devices(devices):
    ts = [torch.zeros(2, device=d) for d in devices] + [torch.zeros(2)]
    with pytest.raises(ValueError, match="wrapper_x takes CUDA tensors"):
        build.cuda_device("wrapper_x", *ts)


# ------------------------------------------------------------ chip_smoke
def test_smoke_same_nan_compares_nan_aware():
    x = torch.tensor([1.0, float("nan"), -0.0, float("inf")])
    assert smoke.same_nan(x, torch.tensor([1.0, -float("nan"), 0.0,
                                           float("inf")]))
    assert not smoke.same_nan(x, torch.tensor([1.0, 2.0, 0.0,
                                               float("inf")]))
    assert not smoke.same_nan(x, torch.tensor([1.0, float("nan"), 0.0,
                                               1e38]))
    assert not smoke.same_nan(x, x.double())
    assert smoke.same_nan(torch.tensor([1, 2]), torch.tensor([1, 2]))
