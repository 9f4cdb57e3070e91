"""What surrounds the two redesigned attention kernels, on the CPU.

``csrc/decode_attention.cu`` cuts the cache into splits chosen by
``decode_attention.split_rows`` and merges them in a fixed order;
``csrc/flash_attention.cu`` multiplies bf16 pieces of its operands on the
tensor cores.  Neither runs here, so these tests hold what the design
rests on:

* the split depends on the shape alone (so a float32 call on widened
  bf16 inputs cuts the cache the same way) and tiles [0, S) exactly at
  every shape the smoke and the reference's tests use;
* a torch emulation of each kernel's arithmetic (bf16 pieces, products
  exact in float32, float32 sums in the kernels' order, 64-key tiles, P in
  three pieces; decode's splits merged in order 0, 1, ...) is within the
  smoke's float32 tolerance of the plain versions at the smoke's edge
  shapes, which is how the piece counts were chosen;
* for inputs widened from bf16 every piece but the first is exactly 0, so
  the float32 instance's extra products add zeros and its result, rounded,
  is the bf16 instance's bit for bit.

The emulation lives here, not in the package: the package's CPU path is
the plain version."""
import importlib.util
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import decode_attention as kdecode
from repro_torch.kernels.decode_attention import (decode_attention_torch,
                                                  split_rows, tile_rows)
from repro_torch.kernels.flash_attention import flash_attention_torch

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)

NEG_INF = -1e30
BLOCK_K = 64
# the float32 instance's products, smallest first: (Q piece, K piece) and
# (P piece, V piece); the bf16 instance keeps those of its one piece
QK_TERMS = ((2, 0), (0, 2), (1, 1), (1, 0), (0, 1), (0, 0))
PV_TERMS = ((2, 0), (0, 2), (1, 1), (0, 1), (1, 0), (0, 0))
# (B, H, KV, S, D) of the reference's tests/test_kernels.py and of the
# port's tests/test_torch_attention.py
REFERENCE_DECODE_SHAPES = ((1, 8, 2, 512, 64), (2, 16, 16, 1024, 64),
                           (2, 8, 1, 512, 128), (4, 32, 8, 2048, 128),
                           (1, 4, 2, 100, 32))
DECODE_SHAPES = REFERENCE_DECODE_SHAPES + tuple(
    c[1:6] for c in smoke.DECODE_CASES + smoke.DECODE_EDGE_CASES)


def pieces(x, n):
    """The n bf16 pieces of x (as float32): each the bf16 rounding of
    what the earlier ones leave."""
    out, r = [], x.float()
    for _ in range(n):
        h = r.to(torch.bfloat16).float()
        out.append(h)
        r = r - h
    return out


def flash_emulated(q, k, v, causal, n_pieces, p_pieces=3):
    """The flash kernel's arithmetic: ``n_pieces`` = 3 is its float32
    instance, 1 its bf16 instance (inputs are their own hi piece); P in
    ``p_pieces`` pieces."""
    B, H, T, D = q.shape
    S = k.shape[2]
    Q, K, V = (pieces(x, n_pieces) for x in (q, k, v))
    qk = [t for t in QK_TERMS if max(t) < n_pieces]
    pv = [t for t in PV_TERMS if t[1] < n_pieces and t[0] < p_pieces]
    m = torch.full((B, H, T, 1), NEG_INF)
    l = torch.zeros((B, H, T, 1))
    acc = torch.zeros((B, H, T, D))
    t = torch.arange(T)[:, None]
    for k0 in range(0, S, BLOCK_K):
        s = torch.zeros((B, H, T, BLOCK_K))
        for i, j in qk:
            s = s + torch.einsum("bhtd,bhsd->bhts", Q[i],
                                 K[j][:, :, k0:k0 + BLOCK_K])
        s = s * (D ** -0.5)
        seen = (k0 + torch.arange(BLOCK_K))[None, :] <= t + (S - T)
        if not causal:
            seen = torch.ones_like(seen)
        s = torch.where(seen, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        p = torch.where(seen, torch.exp(s - m_new), 0.0)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr
        P = pieces(p, p_pieces)
        for i, j in pv:
            acc = acc + torch.einsum("bhts,bhsd->bhtd", P[i],
                                     V[j][:, :, k0:k0 + BLOCK_K])
        m = m_new
    return (acc / torch.clamp(l, min=1e-30)).to(q.dtype)


def decode_emulated(q, k, v, order=None):
    """The decode kernel's split and merge: each split's (m, l, acc) in
    float32, merged in ``order`` (default 0, 1, ...)."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    n, rows = split_rows(B, KV, S, D)
    qg = q.float().reshape(B, KV, H // KV, D) * D ** -0.5
    parts = []
    for i in range(n):
        s = torch.einsum("bkgd,bskd->bkgs", qg,
                         k[:, i * rows:(i + 1) * rows].float())
        m = s.amax(-1, keepdim=True)
        p = torch.exp(s - m)
        parts.append((m, p.sum(-1, keepdim=True), torch.einsum(
            "bkgs,bskd->bkgd", p, v[:, i * rows:(i + 1) * rows].float())))
    order = range(n) if order is None else order
    mm = torch.stack([parts[i][0] for i in order]).amax(0)
    l = torch.zeros_like(mm)
    acc = torch.zeros((B, KV, H // KV, D))
    for i in order:
        c = torch.exp(parts[i][0] - mm)
        l = l + parts[i][1] * c
        acc = acc + parts[i][2] * c
    return (acc / torch.clamp(l, min=1e-30)).reshape(B, H, D).to(q.dtype)


def _randn(seed, *shapes, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(s, generator=g).to(dtype) for s in shapes)


# ------------------------------------------------------------ decode split
def test_split_rows_reads_the_shape_only():
    """No type reaches the split: its arguments are (B, KV, S, D)."""
    assert list(inspect.signature(split_rows).parameters) == [
        "B", "KV", "S", "D"]
    assert split_rows(4, 8, 32768, 128) == (16, 2048)


@pytest.mark.parametrize("B,H,KV,S,D", sorted(set(DECODE_SHAPES)))
def test_decode_splits_tile_the_cache(B, H, KV, S, D):
    n, rows = split_rows(B, KV, S, D)
    assert n >= 1 and rows % tile_rows(D) == 0
    assert (n - 1) * rows < S <= n * rows       # none empty, all covered
    if B * KV <= kdecode.TARGET_CTAS:
        assert B * KV * n <= kdecode.TARGET_CTAS
    cover = torch.zeros(S, dtype=torch.int32)
    for i in range(n):
        cover[i * rows:min((i + 1) * rows, S)] += 1
    assert bool((cover == 1).all())


@pytest.mark.parametrize("D,lanes", [(32, 4), (36, 8), (64, 8), (100, 16),
                                     (128, 16), (256, 32)])
def test_lane_groups_cover_d(D, lanes):
    """8 values of d a lane, a power-of-two group of lanes a row."""
    assert kdecode.lanes_per_row(D) == lanes and 8 * lanes >= D


# --------------------------------------------------------- the emulations
FLASH_EDGE = [c[1:7] for c in smoke.FLASH_EDGE_CASES] + [
    (1, 2, 128, 128, 128, True), (1, 2, 256, 128, 128, False)]


@pytest.mark.parametrize("B,H,T,S,D,causal", FLASH_EDGE)
def test_flash_pieces_within_f32_tolerance(B, H, T, S, D, causal):
    """Three pieces of Q, K and V with six Q.K terms, P in three pieces
    with six P.V terms: within the smoke's float32 tolerance of the plain
    version on float32 inputs (blind rows included)."""
    q, k, v = _randn(3, (B, H, T, D), (B, H, S, D), (B, H, S, D))
    got = flash_emulated(q, k, v, causal, 3)
    want = flash_attention_torch(q, k, v, causal=causal)
    assert torch.allclose(got, want, rtol=smoke.F32_TOL, atol=smoke.F32_TOL)
    if causal and S < T:
        assert not got[:, :, :T - S].any()


def test_flash_one_piece_of_p_is_refused():
    """P rounded to bf16 (one piece) leaves ~2^-9 of p: the float32
    tolerance refuses it, which is why P goes in as pieces (three)."""
    q, k, v = _randn(4, (1, 2, 256, 64), (1, 2, 256, 64), (1, 2, 256, 64))
    want = flash_attention_torch(q, k, v, causal=True)
    got = flash_emulated(q, k, v, True, 3, p_pieces=1)
    assert not torch.allclose(got, want, rtol=smoke.F32_TOL,
                              atol=smoke.F32_TOL)


def _exact_attention(q, k, v):
    """Causal attention in float64: the function itself, with no float32
    rounding of the logits."""
    T, S, D = q.shape[2], k.shape[2], q.shape[3]
    s = torch.einsum("bhtd,bhsd->bhts", q.double(), k.double()) * D ** -0.5
    seen = torch.arange(S)[None, :] <= torch.arange(T)[:, None] + (S - T)
    return torch.softmax(torch.where(seen, s, -1e300), -1) @ v.double()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_flash_large_logit_gap_is_the_float32_logits(seed):
    """Where the third bf16 piece of P helps and where it does not.  At
    random logits it takes the emulated kernel 5x or more nearer the
    float64 attention (two pieces leave 2^-18 of p, three 2^-27).  At logits up to 60 (qwen3-4b's D = 128, q scaled up) the
    emulated kernel is within 2e-5 of the float64 attention with two
    pieces, the float32 plain version is farther from it, and a third
    piece does not narrow the gap between kernel and plain version: that
    gap is the logits' float32 rounding (|s| ~ 60, ulp 3.8e-6)."""
    q, k, v = _randn(seed, (1, 2, 512, 128), (1, 2, 512, 128),
                     (1, 2, 512, 128))

    def err(a, b):
        return float((a.double() - b.double()).abs().max())
    two = flash_emulated(q, k, v, True, 3, p_pieces=2)
    three = flash_emulated(q, k, v, True, 3, p_pieces=3)
    exact = _exact_attention(q, k, v)
    assert err(three, exact) * 5 <= err(two, exact)
    q = q * (smoke.LARGE_LOGIT / float(_exact_attention_logit_max(q, k)))
    two = flash_emulated(q, k, v, True, 3, p_pieces=2)
    three = flash_emulated(q, k, v, True, 3, p_pieces=3)
    plain = flash_attention_torch(q, k, v, causal=True)
    exact = _exact_attention(q, k, v)
    assert err(two, exact) <= smoke.F32_TOL
    assert err(plain, exact) > err(two, exact)
    assert err(three, plain) >= 0.95 * err(two, plain)


def _exact_attention_logit_max(q, k):
    T, S, D = q.shape[2], k.shape[2], q.shape[3]
    s = torch.einsum("bhtd,bhsd->bhts", q.double(), k.double()) * D ** -0.5
    seen = torch.arange(S)[None, :] <= torch.arange(T)[:, None] + (S - T)
    return torch.where(seen, s, 0.0).abs().max()


@pytest.mark.parametrize("B,H,T,S,D,causal", FLASH_EDGE)
def test_flash_bf16_instance_is_f32_instance_rounded(B, H, T, S, D, causal):
    """On inputs widened from bf16 the float32 instance's extra products
    are products of zeros, so its result rounds to the bf16 instance's
    bit for bit."""
    q, k, v = _randn(5, (B, H, T, D), (B, H, S, D), (B, H, S, D),
                     dtype=torch.bfloat16)
    wide = [x.float() for x in (q, k, v)]
    for x in wide:
        assert all(not p.any() for p in pieces(x, 3)[1:])
    f32 = flash_emulated(*wide, causal, 3)
    bf16 = flash_emulated(*wide, causal, 1).to(torch.bfloat16)
    assert torch.equal(f32.to(torch.bfloat16), bf16)


@pytest.mark.parametrize("B,H,KV,S,D", sorted(set(
    c[1:6] for c in smoke.DECODE_EDGE_CASES + smoke.DECODE_CASES[1:]) | {
        (2, 32, 8, 2048, 128)}))
def test_decode_splits_within_f32_tolerance(B, H, KV, S, D):
    q, k, v = _randn(6, (B, H, D), (B, S, KV, D), (B, S, KV, D))
    got = decode_emulated(q, k, v)
    want = decode_attention_torch(q, k, v)
    assert torch.allclose(got, want, rtol=smoke.F32_TOL, atol=smoke.F32_TOL)


def test_widened_bf16_has_no_lower_pieces():
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        4096).astype(np.float32)).to(torch.bfloat16).float()
    hi, mid, lo = pieces(x, 3)
    assert torch.equal(hi, x) and not mid.any() and not lo.any()
    y = torch.from_numpy(np.random.default_rng(8).standard_normal(
        4096).astype(np.float32))
    hi, mid, lo = pieces(y, 3)
    assert mid.any() and lo.any()
    # 24 bits: what three pieces leave is below 2^-24 of x
    assert bool(((y - hi - mid - lo).abs() <= y.abs() * 2.0 ** -24).all())
