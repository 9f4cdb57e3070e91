"""What surrounds the two kernels of redesign 2, on the CPU.

``csrc/nms.cu`` now sorts each frame's candidates itself, by rank, and
``csrc/rwkv_scan.cu`` cuts the RWKV state into column blocks and row
slices chosen by ``rwkv_scan.scan_split``.  Neither runs here, so these
tests hold what the designs rest on:

* a torch emulation of the kernel's rank sort (rank_i = #{j : key_j >
  key_i, or key_j == key_i and j < i}, keys compared as floats, NaN
  last) gives ``torch.argsort(-key, stable=True)``'s order on ties, -0.0
  beside 0.0, thresholded zeros, all-equal frames, A = 1, A not a
  multiple of 32 and NaN scores; and greedy NMS over that order equals
  ``batched_nms_torch``;
* a torch emulation of the scan kernel's arithmetic (each thread's slice
  of rows summed in row order, the slices' partials added in slice
  order, the state updated element by element) is within 2e-5 (5x for
  the state: it is in fact bit-equal) of ``rwkv_scan_torch``;
* the split reads the width only, so the float32 instance on widened
  bf16 inputs sums in the bf16 instance's order.

The emulations live here, not in the package: the package's CPU path is
the plain version."""
import inspect

import numpy as np
import pytest
import torch

from repro_torch.kernels import nms as knms
from repro_torch.kernels import rwkv_scan as krwkv
from repro_torch.kernels.nms import batched_nms_torch
from repro_torch.kernels.rwkv_scan import rwkv_scan_torch, scan_split


# ------------------------------------------------------------------ NMS
def kernel_keys(scores, score_thr):
    """The kernel's threshold: s >= thr ? s : 0, in float32."""
    s = scores.float()
    if score_thr is None:
        return s
    return torch.where(s >= score_thr, s, torch.zeros_like(s))


def kernel_order(key):
    """The kernel's rank sort (``sorted_rank`` in ``csrc/nms.cu``):
    candidate i goes to position rank_i; returns the candidate at each
    position, (B, A)."""
    B, A = key.shape
    idx = torch.arange(A)
    j_first = idx[None, :] < idx[:, None]                 # [i, j]: j < i
    ki, kj = key[:, :, None], key[:, None, :]
    before = torch.where(torch.isnan(ki), j_first | ~torch.isnan(kj),
                         torch.where(j_first, kj >= ki, kj > ki))
    rank = before.sum(-1)
    assert torch.equal(torch.sort(rank, -1).values, idx.expand(B, A)), \
        "ranks are not a permutation"
    order = torch.empty_like(rank)
    order.scatter_(1, rank, idx.expand(B, A).contiguous())
    return order


def _scores(case, rng):
    """(B, A) float32 scores for each sort case."""
    if case == "ties":
        return rng.choice(np.float32([0.9, 0.7, 0.5, 0.4, 0.2]), (3, 150))
    if case == "signed zeros":
        s = np.where(rng.uniform(size=(3, 70)) < 0.5, np.float32(-0.0),
                     np.float32(0.0)).astype(np.float32)
        s[:, ::7] = rng.uniform(0.3, 1, s[:, ::7].shape)
        return s
    if case == "thresholded zeros":
        return rng.uniform(0, 1, (4, 160)).astype(np.float32)
    if case == "all equal":
        return np.full((2, 96), 0.625, np.float32)
    if case == "A=1":
        return rng.uniform(0, 1, (3, 1)).astype(np.float32)
    if case == "A=45":
        return rng.uniform(0, 1, (2, 45)).astype(np.float32)
    if case == "NaN":
        s = rng.uniform(-1, 1, (3, 100)).astype(np.float32)
        s[rng.uniform(size=s.shape) < 0.2] = np.nan
        s[0, :33] = np.nan
        s[1, 10:20] = np.float32(0.5)
        return s
    raise KeyError(case)


SORT_CASES = ["ties", "signed zeros", "thresholded zeros", "all equal",
              "A=1", "A=45", "NaN"]


@pytest.mark.parametrize("score_thr", [None, 0.4])
@pytest.mark.parametrize("case", SORT_CASES)
def test_rank_sort_is_stable_argsort(case, score_thr):
    s = torch.from_numpy(_scores(case, np.random.default_rng(1)))
    key = kernel_keys(s, score_thr)
    want = torch.argsort(-key, dim=-1, stable=True)
    assert torch.equal(kernel_order(key), want)


def test_rank_sort_ties_signed_zeros_by_index():
    """-0.0 and 0.0 tie: index order decides, not the sign bit (a sort on
    bit patterns would put every 0.0 of -s = -0.0 first)."""
    s = torch.tensor([[0.0, -0.0, 0.5, -0.0, 0.0, 0.5]])
    assert kernel_order(s).tolist() == [[2, 5, 0, 1, 3, 4]]
    assert torch.equal(kernel_order(s), torch.argsort(-s, stable=True))


def test_rank_sort_puts_nan_last_in_index_order():
    s = torch.tensor([[float("nan"), 0.1, float("nan"), -3.0, 0.1]])
    assert kernel_order(s).tolist() == [[1, 4, 3, 0, 2]]


def _kernel_sorted_candidates(boxes, scores, score_thr):
    """``nms._sorted_candidates`` with the kernel's rank sort."""
    B, A = scores.shape
    key = kernel_keys(scores, score_thr)
    order = kernel_order(key)
    bs = torch.gather(boxes.float(), 1, order[..., None].expand(B, A, 4))
    return bs, torch.gather(key, 1, order), order


@pytest.mark.parametrize("kw", [
    dict(iou_thr=0.5, score_thr=0.4, max_out=32, stop_at_zero=True),
    dict(iou_thr=0.5, score_thr=None, max_out=64, stop_at_zero=False),
    dict(iou_thr=0.3, score_thr=0.4, max_out=8, stop_at_zero=False)],
    ids=["serving", "no-threshold", "max_out=8"])
@pytest.mark.parametrize("case", SORT_CASES)
def test_nms_over_the_rank_sort_equals_the_plain_version(monkeypatch, case,
                                                         kw):
    """Greedy NMS over the kernel's order (its first sorted key a tile
    deciding ``stop_at_zero``) keeps what ``batched_nms_torch`` keeps."""
    rng = np.random.default_rng(2)
    s = _scores(case, rng)
    xy = rng.uniform(0, 1, s.shape + (2,))
    wh = rng.uniform(0, 0.3, s.shape + (2,))
    b = torch.from_numpy(np.concatenate([xy, xy + wh], -1).astype(
        np.float32))
    s = torch.from_numpy(s)
    want = batched_nms_torch(b, s, **kw)
    monkeypatch.setattr(knms, "_sorted_candidates",
                        _kernel_sorted_candidates)
    got = batched_nms_torch(b, s, **kw)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_nms_launcher_takes_unsorted_inputs():
    """The wrapper hands the kernel the unsorted boxes and scores and
    the threshold (boxes, scores, B, A, max_out, use_thr, score_thr,
    iou_thr, stop_at_zero, keep, valid, stream): no order argument."""
    import ctypes
    args = knms._LAUNCH_ARGS
    assert len(args) == 12 and args.count(ctypes.c_float) == 2
    src = inspect.getsource(knms.batched_nms_cuda)
    assert "_sorted_candidates" not in src and "argsort" not in src


# ----------------------------------------------------------------- scan
def scan_emulated(r, k, v, w, u, s0):
    """The scan kernel's arithmetic in torch: per step, kv = k_i v_j,
    term = S + u_i kv, each slice of ``scan_split(hs)[1]`` rows summed in
    row order from 0, the slices' partials added in slice order, S = w_i
    S + kv; float32 throughout, out rounded once to r's type."""
    B, H, T, hs = r.shape
    rows = scan_split(hs)[1]
    S = s0.float()
    uf = u.float()[None, :, :, None]
    rf, kf, vf, wf = (x.float() for x in (r, k, v, w))
    outs = []
    for t in range(T):
        kv = kf[:, :, t, :, None] * vf[:, :, t, None, :]
        prod = rf[:, :, t, :, None] * (S + uf * kv)
        parts = []
        for i0 in range(0, hs, rows):
            acc = torch.zeros((B, H, hs))
            for i in range(i0, min(hs, i0 + rows)):
                acc = acc + prod[:, :, i]
            parts.append(acc)
        o = parts[0]
        for p in parts[1:]:
            o = o + p
        outs.append(o)
        S = wf[:, :, t, :, None] * S + kv
    return torch.stack(outs, 2).to(r.dtype), S


def _scan_inputs(B, H, T, hs, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.standard_normal(s).astype(np.float32))
    w = torch.sigmoid(f(B, H, T, hs)) * 0.5 + 0.45
    return f(B, H, T, hs), f(B, H, T, hs), f(B, H, T, hs), w, f(H, hs), \
        f(B, H, hs, hs) * 0.1


@pytest.mark.parametrize("B,H,T,hs", [(1, 2, 64, 64), (2, 3, 40, 36),
                                      (1, 2, 48, 16), (2, 1, 100, 32),
                                      (1, 1, 12, 256), (1, 1, 6, 300)])
def test_scan_slices_within_f32_tolerance(B, H, T, hs):
    x = _scan_inputs(B, H, T, hs)
    out, S = scan_emulated(*x)
    want_out, want_S = rwkv_scan_torch(*x)
    assert torch.allclose(out, want_out, rtol=2e-5, atol=2e-5)
    assert torch.equal(S, want_S)


def test_scan_split_reads_the_width_only():
    assert list(inspect.signature(scan_split).parameters) == ["hs"]
    for hs in range(1, krwkv.MAX_HS + 1):
        cols, rows = scan_split(hs)
        assert rows == krwkv.ROWS and 1 <= cols <= 16
        assert cols * -(-hs // rows) <= 512, hs
    src = inspect.getsource(krwkv.rwkv_scan_cuda)
    assert "scan_split(hs)" in src


def test_scan_bf16_and_widened_f32_share_the_arithmetic():
    """On bf16 inputs widened to float32 the emulated arithmetic is the
    bf16 call's, rounded once: the bit check's premise."""
    x = tuple(t.to(torch.bfloat16) for t in _scan_inputs(1, 2, 32, 64)[:4])
    u, s0 = _scan_inputs(1, 2, 32, 64)[4:]
    out16, S16 = scan_emulated(*x, u, s0)
    out32, S32 = scan_emulated(*(t.float() for t in x), u, s0)
    assert torch.equal(out16, out32.to(torch.bfloat16))
    assert torch.equal(S16, S32)
