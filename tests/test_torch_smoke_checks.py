"""``chip_smoke.hold_to_plain``, the check that holds the attention and
scan kernels to their plain versions on the card, exercised on the CPU
with stand-ins for the kernels.

The plain version itself must pass, in float32 and in bfloat16.  Two
faulty stand-ins must fail: one that rounds the softmax probabilities to
bfloat16 before PV in its bfloat16 instance only (within the reference's
bf16 oracle tolerance 2e-2 of the plain version, so only the bit check
against the float32 instance catches it), and one that drops the last
eighth of the cache (caught by the float32 tolerance)."""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.decode_attention import decode_attention_torch
from repro_torch.kernels.flash_attention import flash_attention_torch
from repro_torch.kernels.rwkv_scan import rwkv_scan_torch

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)


def _decode_inputs(dtype, B=1, H=8, KV=2, S=4096, D=64):
    g = torch.Generator().manual_seed(0)
    return tuple(torch.randn(s, generator=g).to(dtype)
                 for s in ((B, H, D), (B, S, KV, D), (B, S, KV, D)))


def _rounds_p_in_bf16(q, k, v):
    """Decode attention that rounds p to bfloat16 before PV when its
    inputs are bfloat16, as a faulty kernel instance might."""
    B, H, D = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, D) * D ** -0.5
    p = torch.softmax(torch.einsum("bkgd,bskd->bkgs", qg, k.float()), -1)
    if q.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(B, H, D).to(q.dtype)


def _drops_tail(q, k, v):
    """Decode attention over the first seven eighths of the cache."""
    n = k.shape[1] * 7 // 8
    return decode_attention_torch(q, k[:, :n], v[:, :n])


def _hold(got, x, kernel, plain, tols=(smoke.F32_TOL,)):
    got = (got,) if torch.is_tensor(got) else got
    return smoke.hold_to_plain("test", "case", got, x, kernel, plain, tols)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_pass(dtype):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((1, 2, 128, 32), generator=g).to(dtype)
               for _ in range(3))
    flash = lambda *a: flash_attention_torch(*a, causal=True)  # noqa: E731
    assert _hold(flash(q, k, v), (q, k, v), flash, flash)[2]
    x = _decode_inputs(dtype)
    assert _hold(decode_attention_torch(*x), x, decode_attention_torch,
                 decode_attention_torch)[2]
    r, kk, vv = (torch.randn((1, 2, 32, 16), generator=g).to(dtype)
                 for _ in range(3))
    w = (torch.sigmoid(torch.randn((1, 2, 32, 16), generator=g)) * 0.5
         + 0.45).to(dtype)
    x = (r, kk, vv, w, torch.randn((2, 16), generator=g),
         torch.randn((1, 2, 16, 16), generator=g) * 0.1)
    err, _, ok = _hold(rwkv_scan_torch(*x), x, rwkv_scan_torch,
                    rwkv_scan_torch, (smoke.F32_TOL, 5 * smoke.F32_TOL))
    assert ok and err == 0.0


def test_bf16_rounding_inside_the_kernel_fails():
    x = _decode_inputs(torch.bfloat16)
    got = _rounds_p_in_bf16(*x)
    want = decode_attention_torch(*x)
    # the reference's bf16 oracle tolerance would let it through
    assert torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    assert not _hold(got, x, _rounds_p_in_bf16, decode_attention_torch)[2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropped_cache_rows_fail(dtype):
    x = _decode_inputs(dtype)
    assert not _hold(_drops_tail(*x), x, _drops_tail,
                     decode_attention_torch)[2]
