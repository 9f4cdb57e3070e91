"""The port's attention and scan kernels' plain versions against the JAX
package, on the CPU, at the shapes of ``tests/test_kernels.py``.

``ops.flash_attention``, ``ops.decode_attention`` and ``ops.rwkv_scan``
take their plain PyTorch versions for CPU tensors.  They compute in
float32 and cast once at the end, as the Pallas kernels do, and are held
to the reference's own kernel-vs-oracle tolerances
(``tests/test_kernels.py``): rtol = atol = 2e-5 in float32, 2e-2 in
bfloat16, and five times that for the RWKV state.  Every case runs
against the Pallas kernel in interpret mode and the JAX oracle, except
causal attention with S < T: there a query that sees no key gets 0 from
the Pallas kernel and the mean of v from the oracle, and the port is
pinned to the kernel.  The CUDA kernels are held against these plain
versions on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as jdecode
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.rwkv_scan import rwkv_scan as jrwkv
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.decode_attention import decode_attention_torch
from repro_torch.kernels.flash_attention import flash_attention_torch
from repro_torch.kernels.rwkv_scan import rwkv_scan_torch

TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
JAX = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _pair(x, dtype):
    """One numpy array as a torch tensor and a JAX array of ``dtype``
    holding the same values (bfloat16 rounded once, by torch)."""
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(
        TORCH[dtype])
    return t, jnp.asarray(t.float().numpy()).astype(JAX[dtype])


def _np(x):
    return np.array(x.float() if isinstance(x, torch.Tensor) else
                    jnp.asarray(x, jnp.float32))


# ------------------------------------------------------- flash attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,S,D", [
    (1, 2, 128, 128, 64),
    (2, 4, 256, 256, 64),
    (1, 1, 128, 256, 128),     # cross: S > T (cached prefix)
    (2, 2, 256, 128, 32),      # T > S
])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_matches_pallas_and_oracle(B, H, T, S, D, dtype,
                                                   causal):
    rng = np.random.default_rng(0)
    (q, jq), (k, jk), (v, jv) = (_pair(rng.standard_normal(s), dtype)
                                 for s in ((B, H, T, D), (B, H, S, D),
                                           (B, H, S, D)))
    got = ops.flash_attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == (B, H, T, D)
    assert torch.equal(got, flash_attention_torch(q, k, v, causal=causal))
    pallas = jflash(jq, jk, jv, causal=causal, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    oracle = _np(jref.flash_attention_ref(jq, jk, jv, causal=causal))
    if causal and S < T:
        # rows t < T - S see no key: 0 from the kernel, mean of v from
        # the oracle; the rest agree with both
        blind = T - S
        assert not _np(got)[:, :, :blind].any()
        assert _np(pallas)[:, :, :blind].max() == 0.0
        np.testing.assert_allclose(_np(got)[:, :, blind:],
                                   oracle[:, :, blind:], **TOL[dtype])
    else:
        np.testing.assert_allclose(_np(got), oracle, **TOL[dtype])


def test_explicit_scale_matches_oracle():
    """An explicit ``scale`` (the reference's Pallas wrappers capture a
    traced scale as a constant, which this JAX refuses, so the oracles
    are the reference here)."""
    rng = np.random.default_rng(1)
    (q, jq), (k, jk), (v, jv) = (_pair(rng.standard_normal(
        (1, 2, 128, 64)), "float32") for _ in range(3))
    got = ops.flash_attention(q, k, v, causal=True, scale=0.3)
    want = jref.flash_attention_ref(jq, jk, jv, causal=True, scale=0.3)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])
    (q, jq), (k, jk), (v, jv) = (_pair(rng.standard_normal(s), "float32")
                                 for s in ((2, 8, 64), (2, 512, 2, 64),
                                           (2, 512, 2, 64)))
    got = ops.decode_attention(q, k, v, scale=0.3)
    want = jref.decode_attention_ref(jq, jk, jv, scale=0.3)
    np.testing.assert_allclose(_np(got), _np(want), **TOL["float32"])


# ------------------------------------------------------- decode attention
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,KV,S,D", [
    (1, 8, 2, 512, 64),
    (2, 16, 16, 1024, 64),     # MHA (KV == H)
    (2, 8, 1, 512, 128),       # MQA
    (4, 32, 8, 2048, 128),     # the decode_32k family shape
    (1, 4, 2, 100, 32),        # S < 512: one block of S
])
def test_decode_attention_matches_pallas_and_oracle(B, H, KV, S, D, dtype):
    rng = np.random.default_rng(2)
    (q, jq), (k, jk), (v, jv) = (_pair(rng.standard_normal(s), dtype)
                                 for s in ((B, H, D), (B, S, KV, D),
                                           (B, S, KV, D)))
    got = ops.decode_attention(q, k, v)
    assert got.dtype == q.dtype and got.shape == (B, H, D)
    assert torch.equal(got, decode_attention_torch(q, k, v))
    pallas = jdecode(jq, jk, jv, interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **TOL[dtype])
    np.testing.assert_allclose(_np(got), _np(jref.decode_attention_ref(
        jq, jk, jv)), **TOL[dtype])


# ------------------------------------------------------------ rwkv scan
def _rwkv_inputs(B, H, T, hs, dtype, seed=3):
    rng = np.random.default_rng(seed)
    sig = 1.0 / (1.0 + np.exp(-rng.standard_normal((B, H, T, hs))))
    arrays = [rng.standard_normal((B, H, T, hs)) for _ in range(3)]
    arrays.append(sig * 0.5 + 0.45)
    pairs = [_pair(a, dtype) for a in arrays]
    pairs.append(_pair(rng.standard_normal((H, hs)), "float32"))
    pairs.append(_pair(rng.standard_normal((B, H, hs, hs)) * 0.1,
                       "float32"))
    return [p[0] for p in pairs], [p[1] for p in pairs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,H,T,hs,chunk", [
    (1, 2, 256, 32, 256),
    (2, 3, 512, 64, 256),      # multi-chunk: the state crosses chunks
    (1, 1, 1024, 64, 128),
    (1, 2, 100, 32, 256),      # T < chunk_t: one chunk of T
])
def test_rwkv_scan_matches_pallas_and_oracle(B, H, T, hs, chunk, dtype):
    targs, jargs = _rwkv_inputs(B, H, T, hs, dtype)
    out, s_final = ops.rwkv_scan(*targs, chunk_t=chunk)
    assert out.dtype == targs[0].dtype and out.shape == (B, H, T, hs)
    assert s_final.dtype == torch.float32
    plain = rwkv_scan_torch(*targs, chunk_t=chunk)
    assert torch.equal(out, plain[0]) and torch.equal(s_final, plain[1])
    tol = TOL[dtype]
    stol = dict(rtol=tol["rtol"] * 5, atol=tol["atol"] * 5)
    for want_o, want_s in (jrwkv(*jargs, interpret=True, chunk_t=chunk),
                           jref.rwkv_scan_ref(*jargs)):
        np.testing.assert_allclose(_np(out), _np(want_o), **tol)
        np.testing.assert_allclose(_np(s_final), _np(want_s), **stol)


# ----------------------------------------------- torch oracles vs JAX's
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_torch_oracles_match_jax_oracles(dtype):
    """The RWKV oracle is compared in float32 only: in bfloat16 the JAX
    oracle's jitted scan keeps ``k * v`` in float32 (XLA's excess
    precision), while the copy rounds it to bfloat16 as written."""
    rng = np.random.default_rng(4)
    tol = TOL[dtype]
    (q, jq), (k, jk), (v, jv) = (_pair(rng.standard_normal(
        (1, 2, 128, 32)), dtype) for _ in range(3))
    for causal in (True, False):
        np.testing.assert_allclose(
            _np(tref.flash_attention_ref(q, k, v, causal=causal)),
            _np(jref.flash_attention_ref(jq, jk, jv, causal=causal)), **tol)
    (q, jq), (k, jk), (v, jv) = (_pair(rng.standard_normal(s), dtype)
                                 for s in ((2, 8, 32), (2, 64, 2, 32),
                                           (2, 64, 2, 32)))
    np.testing.assert_allclose(_np(tref.decode_attention_ref(q, k, v)),
                               _np(jref.decode_attention_ref(jq, jk, jv)),
                               **tol)
    targs, jargs = _rwkv_inputs(1, 2, 64, 16, "float32")
    (to, ts), (jo, js) = tref.rwkv_scan_ref(*targs), jref.rwkv_scan_ref(
        *jargs)
    tol = TOL["float32"]
    np.testing.assert_allclose(_np(to), _np(jo), **tol)
    np.testing.assert_allclose(_np(ts), _np(js), rtol=tol["rtol"] * 5,
                               atol=tol["atol"] * 5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["flash causal T=S", "flash causal S>T",
                                  "flash full S<T", "decode GQA", "rwkv"])
def test_plain_versions_match_torch_oracles(case, dtype):
    """The port's own oracles as a second witness for the plain versions
    (which the CUDA kernels are held to on the card), at the kernels'
    two input types, with the reference's kernel-vs-oracle tolerances:
    in bfloat16 the attention oracles round p to bfloat16 where the plain
    versions stay in float32.  The RWKV oracle as written forms k * v in
    the inputs' type, which neither the Pallas kernel nor the plain
    version does, so in bfloat16 it runs on the inputs widened to
    float32 (exactly) and its output is rounded once."""
    rng = np.random.default_rng(5)
    tol = TOL[dtype]
    if case.startswith("flash"):
        T, S = {"flash causal T=S": (128, 128), "flash causal S>T":
                (128, 256), "flash full S<T": (256, 128)}[case]
        causal = "causal" in case
        q, k, v = (_pair(rng.standard_normal(s), dtype)[0]
                   for s in ((1, 2, T, 64), (1, 2, S, 64), (1, 2, S, 64)))
        got = flash_attention_torch(q, k, v, causal=causal)
        want = tref.flash_attention_ref(q, k, v, causal=causal)
        np.testing.assert_allclose(_np(got), _np(want), **tol)
    elif case == "decode GQA":
        q, k, v = (_pair(rng.standard_normal(s), dtype)[0]
                   for s in ((2, 8, 64), (2, 512, 2, 64), (2, 512, 2, 64)))
        np.testing.assert_allclose(_np(decode_attention_torch(q, k, v)),
                                   _np(tref.decode_attention_ref(q, k, v)),
                                   **tol)
    else:
        targs, _ = _rwkv_inputs(1, 2, 64, 32, dtype, seed=5)
        po, ps = rwkv_scan_torch(*targs)
        oo, os_ = tref.rwkv_scan_ref(*(t.float() for t in targs))
        oo = oo.to(po.dtype)
        np.testing.assert_allclose(_np(po), _np(oo), **tol)
        np.testing.assert_allclose(_np(ps), _np(os_), rtol=tol["rtol"] * 5,
                                   atol=tol["atol"] * 5)


# --------------------------------------------------------- preconditions
def test_flash_attention_needs_multiples_of_128():
    x = torch.zeros((1, 1, 128, 32))
    y = torch.zeros((1, 1, 192, 32))
    with pytest.raises(ValueError, match="multiples of 128"):
        ops.flash_attention(y, x, x)
    with pytest.raises(ValueError, match="multiples of 128"):
        ops.flash_attention(x, y, y, causal=False)


def test_decode_attention_needs_whole_blocks():
    q = torch.zeros((1, 4, 32))
    kv = torch.zeros((1, 768, 2, 32))                 # 768 % 512 != 0
    with pytest.raises(ValueError, match="S % min"):
        ops.decode_attention(q, kv, kv)
    assert ops.decode_attention(q, kv[:, :512], kv[:, :512]).shape == (
        1, 4, 32)
    with pytest.raises(ValueError, match="multiple of KV"):
        ops.decode_attention(torch.zeros((1, 3, 32)), kv[:, :512],
                             kv[:, :512])


def test_rwkv_scan_needs_whole_chunks():
    targs, _ = _rwkv_inputs(1, 1, 300, 8, "float32")
    with pytest.raises(ValueError, match="T % min"):
        ops.rwkv_scan(*targs)                          # 300 % 256 != 0
    out, _ = ops.rwkv_scan(*targs, chunk_t=100)
    assert out.shape == (1, 1, 300, 8)


def test_reference_preconditions_are_the_same():
    """The JAX functions refuse the same shapes (with asserts)."""
    x = jnp.zeros((1, 1, 128, 32))
    with pytest.raises(AssertionError):
        jflash(jnp.zeros((1, 1, 192, 32)), x, x, interpret=True)
    with pytest.raises(AssertionError):
        jdecode(jnp.zeros((1, 4, 32)), jnp.zeros((1, 768, 2, 32)),
                jnp.zeros((1, 768, 2, 32)), interpret=True)
    z = jnp.zeros((1, 1, 300, 8))
    with pytest.raises(AssertionError):
        jrwkv(z, z, z, z, jnp.zeros((1, 8)), jnp.zeros((1, 1, 8, 8)),
              interpret=True)
