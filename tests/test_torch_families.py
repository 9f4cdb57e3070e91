"""The model families ported last — multi-head latent attention, the MoE
ffn, the Mamba and RWKV-6 mixers with the RWKV channel mix, and the
multi-token-prediction head — against the JAX package, module by module,
on the CPU in float32, with the reference's weights.

Tolerances, stated per test: 1e-5 absolute on a layer's outputs of O(1)
and on its caches (measured: at most a few 1e-6; XLA and PyTorch sum in
other orders, and the Mamba scans take other trees), 1e-4 on logits as
in ``tests/test_torch_llm.py``, 1e-6 on router weights and auxiliary
losses.  Every routing and drop decision is exact: ``capacity``,
``route``'s ``idx``, ``_dispatch_tables``' slots and the dropped pairs.
Where a comparison rests on a router's choice between two packages, the
test asserts its top-k margin (``ROUTER_MARGIN``) instead of relying on
the seed.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.models import attention as jattn
from repro.models import init_cache as jinit_cache
from repro.models import init_model as jinit
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.models import rwkv as jrwkv
from repro.models import transformer as jtransformer
from repro.models.config import LayerSpec as JSpec
from repro.models.config import ModelConfig as JModelConfig
from repro.models.config import MoEConfig as JMoEConfig
from repro.models.config import dense_stages as jdense_stages
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import attention as tattn
from repro_torch.models import init_cache, params_from_numpy
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.models import rwkv as trwkv
from repro_torch.models import transformer as ttransformer
from repro_torch.models.config import LayerSpec as TSpec
from repro_torch.models.config import ModelConfig as TModelConfig
from repro_torch.models.config import MoEConfig as TMoEConfig
from repro_torch.models.config import dense_stages as tdense_stages

LAYER_ATOL = 1e-5
LOGIT_ATOL = 1e-4
ROUTER_ATOL = 1e-6
ROUTER_MARGIN = 1e-5


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.array(x)


def close(got, want, atol):
    np.testing.assert_allclose(_n(got), np.array(want), rtol=0, atol=atol)


def tree_t(tree):
    """A reference parameter or cache tree as torch tensors."""
    if isinstance(tree, dict):
        return {k: tree_t(v) for k, v in tree.items()}
    return _t(tree)


def tree_close(got, want, atol):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            tree_close(got[k], want[k], atol)
        return
    assert got.dtype == getattr(torch, np.array(want).dtype.name)
    close(got, want, atol)


def _x(shape, seed, scale=0.25):
    return (scale * np.random.default_rng(seed).standard_normal(shape)
            ).astype(np.float32)


# ------------------------------------------------------------------ MLA
@functools.cache
def _mla_weights():
    jcfg = jget("deepseek-v3-671b", preset="smoke")
    p = jax.tree.map(np.array, jattn.init_mla(jax.random.PRNGKey(5), jcfg))
    for k in ("q_norm", "kv_norm"):
        p[k]["scale"] = np.full_like(p[k]["scale"], 0.1)
    return jcfg, get_config("deepseek-v3-671b", preset="smoke"), p


@pytest.mark.parametrize("window", [None, 5])
def test_apply_mla_train_prefill_decode_equal_reference(window):
    """A 9-token prefill into a 16-slot latent cache (with window 5 the
    ring is 5 slots and wraps during the prefill and the 6 decode steps),
    then the weight-absorbed decode; train mode too.  Outputs and the
    latent caches within ``LAYER_ATOL``."""
    jcfg, tcfg, p = _mla_weights()
    jp, tp = jax.tree.map(jnp.asarray, p), tree_t(p)
    jspec, tspec = JSpec("attn", "dense", window), TSpec("attn", "dense",
                                                         window)
    T, steps, B = 9, 6, 2
    x = _x((B, T + steps, jcfg.d_model), 6)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    for mode in ("train", "prefill"):
        jc = jattn.init_mla_cache(jcfg, jspec, B, 16, jnp.float32)
        tc = tattn.init_mla_cache(tcfg, tspec, B, 16, torch.float32, "cpu")
        jy, jc = jattn.apply_mla(jp, jcfg, jspec, jnp.asarray(x[:, :T]),
                                 jnp.asarray(pos), mode=mode, cache=jc)
        ty, tc = tattn.apply_mla(tp, tcfg, tspec, _t(x[:, :T]), _t(pos),
                                 mode=mode, cache=tc)
        close(ty, jy, LAYER_ATOL)
    assert tc["ckv"].shape == (B, window or 16, tcfg.mla.kv_lora_rank)
    tree_close(tc, jc, LAYER_ATOL)
    for s in range(steps):
        p1 = np.full((B, 1), T + s, np.int32)
        jy, jc = jattn.apply_mla(jp, jcfg, jspec,
                                 jnp.asarray(x[:, T + s:T + s + 1]),
                                 jnp.asarray(p1), mode="decode", cache=jc,
                                 decode_pos=jnp.asarray(T + s, jnp.int32))
        ty, tc = tattn.apply_mla(tp, tcfg, tspec, _t(x[:, T + s:T + s + 1]),
                                 _t(p1), mode="decode", cache=tc,
                                 decode_pos=T + s)
        close(ty, jy, LAYER_ATOL)
        tree_close(tc, jc, LAYER_ATOL)


def test_mla_absorbed_decode_equals_the_expanded_prefill():
    """The weight-absorbed decode is exact algebra: its output equals the
    expanded attention of a prefill over the same tokens, at its last
    position (float32)."""
    _, tcfg, p = _mla_weights()
    tp, spec = tree_t(p), TSpec("attn", "dense")
    x = _t(_x((1, 7, tcfg.d_model), 7))
    pos = torch.arange(7)[None]
    cache = tattn.init_mla_cache(tcfg, spec, 1, 8, torch.float32, "cpu")
    _, cache = tattn.apply_mla(tp, tcfg, spec, x[:, :6], pos[:, :6],
                               mode="prefill", cache=cache)
    dec, _ = tattn.apply_mla(tp, tcfg, spec, x[:, 6:], pos[:, 6:],
                             mode="decode", cache=cache, decode_pos=6)
    full, _ = tattn.apply_mla(tp, tcfg, spec, x, pos, mode="train")
    close(dec[:, 0], _n(full[:, -1]), LAYER_ATOL)


# ------------------------------------------------------------------ MoE
def _moe_cfgs(**kw):
    args = dict(name="moe", d_model=32, d_ff=64, vocab_size=64,
                n_heads=2, n_kv_heads=2, head_dim=16)
    jm, tm = JMoEConfig(**kw), TMoEConfig(**kw)
    return (JModelConfig(stages=jdense_stages(1, ffn="moe"), moe=jm, **args),
            TModelConfig(stages=tdense_stages(1, ffn="moe"), moe=tm, **args))


@pytest.mark.parametrize("E,k,cf", [(4, 2, 1.25), (8, 2, 1.0), (16, 2, 1.25),
                                    (256, 8, 1.25), (2, 1, 0.25),
                                    (256, 8, 32.0), (8, 2, 4.0)])
def test_capacity_equals_reference_on_a_grid(E, k, cf):
    jm = JMoEConfig(n_experts=E, top_k=k, d_ff=8, capacity_factor=cf)
    tm = TMoEConfig(n_experts=E, top_k=k, d_ff=8, capacity_factor=cf)
    for n in list(range(1, 70)) + [128, 255, 256, 1000, 4096, 32768]:
        assert tmoe.capacity(n, tm) == jmoe.capacity(n, jm), n
    # the lift chip_smoke uses: capacity_factor E / k gives C >= T
    lifted = dataclasses.replace(tm, capacity_factor=E / k)
    assert all(tmoe.capacity(n, lifted) >= n for n in range(1, 300))


def _exact_router_inputs(T, d, E, seed, tie=(1, 2)):
    """Small integers times powers of two: every logit is exact in
    float32 in any summation order, and experts ``tie`` have equal
    columns, so their scores tie exactly on every token."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-2, 3, (T, d)).astype(np.float32)
    w = (rng.integers(-2, 3, (d, E)) / 8.0).astype(np.float32)
    if tie:
        w[:, tie[1]] = w[:, tie[0]]
    return x, w


@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
@pytest.mark.parametrize("tie", [None, (1, 2), (0, 3)])
def test_route_equals_reference_on_ties(router, tie):
    """``route``'s ``idx`` exact (on exact ties the lower expert first, as
    ``jax.lax.top_k``), its weights and auxiliary losses within
    ``ROUTER_ATOL``."""
    E, k = 4, 2
    x, w = _exact_router_inputs(24, 16, E, 3, tie)
    jm = JMoEConfig(n_experts=E, top_k=k, d_ff=8, router=router)
    tm = TMoEConfig(n_experts=E, top_k=k, d_ff=8, router=router)
    jw, jidx, jaux = jmoe.route(jnp.asarray(x), jnp.asarray(w), jm)
    tw, tidx, taux = tmoe.route(_t(x), _t(w), tm)
    np.testing.assert_array_equal(_n(tidx), np.array(jidx))
    close(tw, jw, ROUTER_ATOL)
    for key in jaux:
        close(taux[key], jaux[key], ROUTER_ATOL)
    if tie:
        lo, hi = tie
        assert bool((_t(x) @ _t(w))[:, lo].eq((_t(x) @ _t(w))[:, hi]).all())
        # wherever both tied experts reach the top k ... and where only
        # one does, it is the lower one
        both = (tidx == lo).any(-1) | (tidx == hi).any(-1)
        assert bool(both.any())
        only_hi = (tidx == hi).any(-1) & ~(tidx == lo).any(-1)
        assert not bool(only_hi.any())


@pytest.mark.parametrize("C", [4, 8, 12, 48])
def test_dispatch_tables_equal_reference_with_overflow(C):
    """The same (weights, idx) through both packages' ``_dispatch_tables``:
    slot -> token and slot -> weight exact, including capacities that
    force overflow (C=4, 8: most of an expert's pairs dropped) and one
    that drops nothing (C=48); the dropped pairs counted alike."""
    rng = np.random.default_rng(C)
    T, E, k = 24, 4, 2
    idx = np.stack([rng.choice(E, k, replace=False) for _ in range(T)]
                   ).astype(np.int32)
    idx[:12] = [0, 1]                      # crowd experts 0 and 1
    w = rng.uniform(0.1, 1.0, (T, k)).astype(np.float32)
    js, jw = jmoe._dispatch_tables(jnp.asarray(w), jnp.asarray(idx), T, E,
                                   k, C)
    ts, tw, slots = tmoe._dispatch_tables(_t(w), _t(idx, torch.long), T, E,
                                          k, C)
    np.testing.assert_array_equal(_n(ts), np.array(js))
    np.testing.assert_array_equal(_n(tw), np.array(jw))
    kept = int((tw > 0).sum())
    assert kept == int((np.array(jw) > 0).sum())
    assert (T * k - kept > 0) == (C < 20)
    # each kept pair's slot holds its token and weight; the rest dropped
    dropped = _n(slots) == E * C
    assert int(dropped.sum()) == T * k - kept
    t_of = np.repeat(np.arange(T), k).reshape(T, k)
    np.testing.assert_array_equal(np.array(js)[_n(slots)[~dropped]],
                                  t_of[~dropped])
    np.testing.assert_array_equal(np.array(jw)[_n(slots)[~dropped]],
                                  w[~dropped])


def test_moe_capacity_drops_overflow_tokens_as_the_reference():
    """``tests/test_model_invariants.py``'s overflow setup (2 experts,
    top-1, capacity_factor 0.25 over 64 tokens: C = 8): the same tokens
    dropped (zero output) in both packages, outputs within
    ``LAYER_ATOL``."""
    jcfg, tcfg = _moe_cfgs(n_experts=2, top_k=1, d_ff=32,
                           capacity_factor=0.25)
    jcfg = jcfg.replace(d_model=16)
    tcfg = tcfg.replace(d_model=16)
    p = jax.tree.map(np.array, jmoe.init_moe(jax.random.PRNGKey(0), jcfg))
    x = np.array(jax.random.normal(jax.random.PRNGKey(1), (1, 64, 16)))
    jout, _ = jmoe.apply_moe(jax.tree.map(jnp.asarray, p), jcfg,
                             jnp.asarray(x))
    tout, _ = tmoe.apply_moe(tree_t(p), tcfg, _t(x))
    jdrop = np.linalg.norm(np.array(jout)[0], axis=-1) == 0.0
    tdrop = _n(tout[0].norm(dim=-1)) == 0.0
    np.testing.assert_array_equal(tdrop, jdrop)
    assert 0 < int(tdrop.sum()) < 64
    close(tout, jout, LAYER_ATOL)


def _margins(p, m, x_rows):
    """The least top-k margin of the router scores over the token pools
    that ``x_rows`` route as."""
    out = []
    for xf in x_rows:
        top = torch.sort(tmoe.router_scores(xf.float() @ p["router"]["w"],
                                            m), -1, descending=True).values
        out.append(float((top[:, m.top_k - 1] - top[:, m.top_k]).min()))
    return min(out)


@pytest.mark.parametrize("dispatch", ["global", "batched"])
@pytest.mark.parametrize("router", ["softmax", "sigmoid"])
def test_apply_moe_equals_reference(dispatch, router):
    """Both scopes and both routers, with a shared expert, at a capacity
    that drops pairs (1.0 over 2 x 16 tokens, 4 experts, top-2): outputs
    within ``LAYER_ATOL``, the auxiliary losses (the mean over rows for
    the batched scope) within ``ROUTER_ATOL``, the dropped tokens' set
    exact."""
    jcfg, tcfg = _moe_cfgs(n_experts=4, top_k=2, d_ff=48,
                           n_shared_experts=1, shared_d_ff=24,
                           router=router, dispatch=dispatch,
                           capacity_factor=1.0)
    p = jax.tree.map(np.array, jmoe.init_moe(jax.random.PRNGKey(2), jcfg))
    tp = tree_t(p)
    x = _x((2, 16, 32), 8, 1.0)
    rows = [_t(x[b]) for b in range(2)] if dispatch == "batched" else \
        [_t(x.reshape(32, 32))]
    assert _margins(tp, tcfg.moe, rows) > ROUTER_MARGIN
    jout, jaux = jmoe.apply_moe(jax.tree.map(jnp.asarray, p), jcfg,
                                jnp.asarray(x))
    tout, taux = tmoe.apply_moe(tp, tcfg, _t(x))
    close(tout, jout, LAYER_ATOL)
    for key in jaux:
        close(taux[key], jaux[key], ROUTER_ATOL)
    # the routed part alone: which (token, choice) pairs found a slot
    C = tmoe.capacity(16 if dispatch == "batched" else 32, tcfg.moe)
    for xr in rows:
        w, idx, _ = tmoe.route(xr, tp["router"]["w"], tcfg.moe)
        jw, jidx, _ = jmoe.route(jnp.asarray(_n(xr)),
                                 jnp.asarray(p["router"]["w"]), jcfg.moe)
        np.testing.assert_array_equal(_n(idx), np.array(jidx))
        ts, tw, _ = tmoe._dispatch_tables(w, idx, xr.shape[0], 4, 2, C)
        js, jw_ = jmoe._dispatch_tables(jw, jidx, xr.shape[0], 4, 2, C)
        np.testing.assert_array_equal(_n(ts), np.array(js))
        np.testing.assert_array_equal(_n(tw) > 0, np.array(jw_) > 0)


def test_moe_combine_adds_in_a_fixed_order():
    """The combine is the same sum however often it runs, and it equals
    each token's expert outputs added in ascending expert order
    (capacity_factor E / k: no pair dropped)."""
    _, tcfg = _moe_cfgs(n_experts=8, top_k=4, d_ff=16, capacity_factor=2.0)
    g = torch.Generator().manual_seed(0)
    p = tmoe.init_moe(g, tcfg)
    x = torch.randn((1, 12, 32), generator=g)
    a, _ = tmoe.apply_moe(p, tcfg, x)
    b, _ = tmoe.apply_moe(p, tcfg, x)
    assert torch.equal(a, b)
    w, idx, _ = tmoe.route(x[0], p["router"]["w"], tcfg.moe)
    want = torch.zeros((12, 32))
    for t in range(12):
        for j in torch.argsort(idx[t]).tolist():
            e = int(idx[t, j])
            xe = x[0, t:t + 1]
            h = torch.nn.functional.silu(xe @ p["experts"]["w_gate"][e]) * \
                (xe @ p["experts"]["w_up"][e])
            want[t] = want[t] + ((h @ p["experts"]["w_down"][e])[0]
                                 * w[t, j])
    close(a[0], _n(want), 1e-6)


# ---------------------------------------------------------------- Mamba
@functools.cache
def _mamba_weights():
    jcfg = jget("jamba-v0.1-52b", preset="smoke")
    p = jax.tree.map(np.array, jmamba.init_mamba(jax.random.PRNGKey(4),
                                                 jcfg))
    p["conv_b"] = _x(p["conv_b"].shape, 9, 0.1)
    return jcfg, get_config("jamba-v0.1-52b", preset="smoke"), p


@pytest.mark.parametrize("T", [1, 7, 256, 512])
def test_apply_mamba_train_and_prefill_equal_reference(T):
    """T=512 takes two chunks of 256, T=7 and T=1 one chunk: outputs and
    the prefill cache (the conv tail left-padded where T < d_conv - 1,
    the last state) within ``LAYER_ATOL``."""
    jcfg, tcfg, p = _mamba_weights()
    x = _x((2, T, jcfg.d_model), T)
    for mode in ("train", "prefill"):
        jy, jc = jax.jit(functools.partial(jmamba.apply_mamba, cfg=jcfg,
                                           mode=mode))(
            jax.tree.map(jnp.asarray, p), x=jnp.asarray(x))
        ty, tc = tmamba.apply_mamba(tree_t(p), tcfg, _t(x), mode=mode)
        close(ty, jy, LAYER_ATOL)
        if mode == "prefill":
            assert tc["conv"].shape == (2, 3, 512)
            tree_close(tc, jc, LAYER_ATOL)
        else:
            assert tc is None and jc is None


def test_apply_mamba_decode_steps_equal_reference():
    """An 8-token prefill, then 8 decode steps: each output and the
    carried conv window and state within ``LAYER_ATOL``."""
    jcfg, tcfg, p = _mamba_weights()
    jp, tp = jax.tree.map(jnp.asarray, p), tree_t(p)
    x = _x((2, 16, jcfg.d_model), 11)
    _, jc = jmamba.apply_mamba(jp, jcfg, jnp.asarray(x[:, :8]),
                               mode="prefill")
    _, tc = tmamba.apply_mamba(tp, tcfg, _t(x[:, :8]), mode="prefill")
    for s in range(8, 16):
        jy, jc = jmamba.apply_mamba(jp, jcfg, jnp.asarray(x[:, s:s + 1]),
                                    mode="decode", cache=jc)
        ty, tc = tmamba.apply_mamba(tp, tcfg, _t(x[:, s:s + 1]),
                                    mode="decode", cache=tc)
        close(ty, jy, LAYER_ATOL)
        tree_close(tc, jc, LAYER_ATOL)


def test_mamba_chunk_precondition():
    _, tcfg, p = _mamba_weights()
    with pytest.raises(ValueError, match="chunk"):
        tmamba.apply_mamba(tree_t(p), tcfg, torch.zeros((1, 300, 256)))


# ----------------------------------------------------------------- RWKV
@functools.cache
def _rwkv_weights():
    jcfg = jget("rwkv6-3b", preset="smoke")
    p = jax.tree.map(np.array, jrwkv.init_rwkv(jax.random.PRNGKey(6), jcfg))
    rng = np.random.default_rng(12)
    for k in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g"):
        p[k] = rng.uniform(0, 1, p[k].shape).astype(np.float32)
    cm = jax.tree.map(np.array, jrwkv.init_rwkv_cmix(jax.random.PRNGKey(7),
                                                     jcfg))
    return jcfg, get_config("rwkv6-3b", preset="smoke"), p, cm


def _rwkv_state(jcfg, seed):
    H, hs = jcfg.d_model // jcfg.rwkv.head_size, jcfg.rwkv.head_size
    return {"tm_shift": _x((2, jcfg.d_model), seed),
            "wkv": _x((2, H, hs, hs), seed + 1, 0.5)}


@pytest.mark.parametrize("T", [1, 16, 128])
@pytest.mark.parametrize("seeded", [False, True])
def test_apply_rwkv_train_and_prefill_equal_reference(T, seeded):
    """T=128 runs two chunks of 64.  Seeded: the prefill starts its state
    from the cache's ``wkv`` and ignores its ``tm_shift`` (the reference's
    behaviour); train mode takes no cache.  Outputs and the prefill cache
    within ``LAYER_ATOL``."""
    jcfg, tcfg, p, _ = _rwkv_weights()
    x = _x((2, T, jcfg.d_model), T + 40)
    cache = _rwkv_state(jcfg, 3) if seeded else None
    for mode in ("train", "prefill"):
        c = cache if mode == "prefill" else None
        jy, jc = jrwkv.apply_rwkv(
            jax.tree.map(jnp.asarray, p), jcfg, jnp.asarray(x), mode=mode,
            cache=None if c is None else jax.tree.map(jnp.asarray, c))
        ty, tc = trwkv.apply_rwkv(tree_t(p), tcfg, _t(x), mode=mode,
                                  cache=None if c is None else tree_t(c))
        close(ty, jy, LAYER_ATOL)
        if mode == "prefill":
            tree_close(tc, jc, LAYER_ATOL)
    if seeded:     # the shift ignores tm_shift: a zero one changes nothing
        zero = dict(cache, tm_shift=np.zeros_like(cache["tm_shift"]))
        ty0, _ = trwkv.apply_rwkv(tree_t(p), tcfg, _t(x), mode="prefill",
                                  cache=tree_t(zero))
        assert torch.equal(ty0, ty)


def test_apply_rwkv_decode_steps_equal_reference():
    jcfg, tcfg, p, _ = _rwkv_weights()
    jp, tp = jax.tree.map(jnp.asarray, p), tree_t(p)
    x = _x((2, 24, jcfg.d_model), 13)
    _, jc = jrwkv.apply_rwkv(jp, jcfg, jnp.asarray(x[:, :16]),
                             mode="prefill")
    _, tc = trwkv.apply_rwkv(tp, tcfg, _t(x[:, :16]), mode="prefill")
    for s in range(16, 24):
        jy, jc = jrwkv.apply_rwkv(jp, jcfg, jnp.asarray(x[:, s:s + 1]),
                                  mode="decode", cache=jc)
        ty, tc = trwkv.apply_rwkv(tp, tcfg, _t(x[:, s:s + 1]),
                                  mode="decode", cache=tc)
        close(ty, jy, LAYER_ATOL)
        tree_close(tc, jc, LAYER_ATOL)


def test_rwkv_chunk_precondition():
    _, tcfg, p, _ = _rwkv_weights()
    with pytest.raises(ValueError, match="chunk"):
        trwkv.apply_rwkv(tree_t(p), tcfg, torch.zeros((1, 100, 256)))


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_rwkv_cmix_equals_reference(mode):
    """The channel mix: in decode its shift comes from the cache, in the
    other modes from the sequence alone (a cache passed there is
    ignored, as in the reference)."""
    jcfg, tcfg, _, cm = _rwkv_weights()
    T = 1 if mode == "decode" else 9
    x = _x((2, T, jcfg.d_model), 21)
    cache = {"cm_shift": _x((2, jcfg.d_model), 22)}
    jy, jc = jrwkv.apply_rwkv_cmix(jax.tree.map(jnp.asarray, cm), jcfg,
                                   jnp.asarray(x), mode=mode,
                                   cache=jax.tree.map(jnp.asarray, cache))
    ty, tc = trwkv.apply_rwkv_cmix(tree_t(cm), tcfg, _t(x), mode=mode,
                                   cache=tree_t(cache))
    close(ty, jy, LAYER_ATOL)
    if mode == "train":
        assert tc is None and jc is None
    else:
        tree_close(tc, jc, 0.0)


# ------------------------------------------------------ caches and heads
@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_cache_shapes_and_dtypes_equal_reference(arch, dtype):
    """Every layer's cache leaves: the reference's shapes (without the
    stacked repeats axis) and dtypes (states float32 in a bf16 cache)."""
    jcfg, tcfg = jget(arch, preset="smoke"), get_config(arch, preset="smoke")
    jc = jinit_cache(jcfg, 3, 16, dtype)
    tc = init_cache(tcfg, 3, 16, dtype, device="cpu")
    for stage, js, ts in zip(tcfg.stages, jc, tc):
        n = len(stage.pattern)
        assert len(ts["caches"]) == stage.n_layers
        for i, lc in enumerate(ts["caches"]):
            want = js["caches"][i % n]
            for kind in ("mixer", "ffn"):
                assert set(lc[kind]) == set(want[kind])
                for key, t in lc[kind].items():
                    w = want[kind][key]
                    assert t.shape == w.shape[1:], (kind, key)
                    assert t.dtype == getattr(torch, w.dtype.name)
                    assert not bool(t.any())


def test_mtp_logits_equal_reference():
    """DeepSeek's multi-token-prediction head on the same hidden states:
    logits within ``LOGIT_ATOL``."""
    jcfg = jget("deepseek-v3-671b", preset="smoke")
    tcfg = get_config("deepseek-v3-671b", preset="smoke")
    tree = jax.tree.map(np.array, jinit(jcfg, jax.random.PRNGKey(0)))
    tp = params_from_numpy(tcfg, tree, device="cpu")
    h = _x((2, 10, jcfg.d_model), 30, 1.0)
    toks = np.random.default_rng(31).integers(0, 512, (2, 10)).astype(
        np.int32)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))
    want = jtransformer._mtp_logits(jax.tree.map(jnp.asarray, tree), jcfg,
                                    jnp.asarray(h),
                                    {"tokens": jnp.asarray(toks)},
                                    jnp.asarray(pos))
    got = ttransformer._mtp_logits(tp, tcfg, _t(h),
                                   {"tokens": _t(toks, torch.long)},
                                   _t(pos, torch.long))
    close(got[..., :512], np.array(want)[..., :512], LOGIT_ATOL)


def test_params_from_numpy_keeps_float32_leaves_and_expert_stacks():
    """A bf16 deepseek (smoke widths): the router weights stay float32,
    the experts unstack from (repeats, E, d, f) to (E, d, f) in bf16;
    a bf16 jamba keeps ``A_log`` and ``Dskip`` float32 and ``dt_b``
    bf16; a bf16 rwkv6 keeps ``w0`` and ``u`` float32."""
    def both(arch):
        jcfg = jget(arch, preset="smoke").replace(dtype="bfloat16",
                                                  param_dtype="bfloat16")
        tcfg = get_config(arch, preset="smoke").replace(
            dtype="bfloat16", param_dtype="bfloat16")
        tree = jax.tree.map(np.array, jinit(jcfg, jax.random.PRNGKey(0)))
        return tree, params_from_numpy(tcfg, tree, device="cpu")

    tree, p = both("deepseek-v3-671b")
    moe_layer = p["stages"][1]["layers"][0]["ffn"]
    assert moe_layer["router"]["w"].dtype == torch.float32
    wg = moe_layer["experts"]["w_gate"]
    assert wg.dtype == torch.bfloat16 and wg.shape == (4, 256, 256)
    np.testing.assert_array_equal(
        wg.float().numpy(), tree["stages"][1]["layers"][0]["ffn"][
            "experts"]["w_gate"][0].astype(np.float32))
    assert p["mtp"]["layer"]["mixer"]["wq_a"].dtype == torch.bfloat16
    _, p = both("jamba-v0.1-52b")
    mix = p["stages"][0]["layers"][0]["mixer"]
    assert (mix["A_log"].dtype, mix["Dskip"].dtype, mix["dt_b"].dtype) == (
        torch.float32, torch.float32, torch.bfloat16)
    _, p = both("rwkv6-3b")
    mix = p["stages"][0]["layers"][1]["mixer"]
    assert (mix["w0"].dtype, mix["u"].dtype, mix["wr6"].dtype) == (
        torch.float32, torch.float32, torch.bfloat16)
