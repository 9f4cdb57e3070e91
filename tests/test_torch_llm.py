"""The port's LLM substrate (``repro_torch.models``, ``.configs``,
``.runtime`` and ``serving.ServingEngine``) against the JAX package, on
the CPU, with the reference's weights carried across by
``models.params_from_numpy`` (float32, the ``smoke`` presets: d_model
256, 2 layers).

Tolerance: ``ATOL`` = 1e-4 absolute on float32 outputs of O(1) (logits
up to about 4 at these presets).  Measured on this CPU: the largest
difference of any test's logits is about 4e-6 (XLA and PyTorch sum the
products and reductions in other orders); the layers, rope and
attention outputs agree to about 1e-6.  Discrete outputs (greedy
tokens, drops, per-replica counts, event kinds) are exact.  No assertion
rests on wall time: the ``ServingEngine`` cases space requests 1 s apart
on the virtual clock, far beyond a request's wall time, so the placement
does not depend on it.
"""
import dataclasses
import functools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.launch import serve as jserve
from repro.models import attention as jattn
from repro.models import init_model as jinit
from repro.models import layers as jlayers
from repro.models import model_apply as japply
from repro.models import rope as jrope
from repro.models.config import LayerSpec as JSpec
from repro.obs import TraceRecorder as JRecorder
from repro.runtime.steps import make_decode_step as jdecode_step
from repro.runtime.steps import make_prefill_step as jprefill_step
from repro.serving import Request as JRequest
from repro.serving import ServingEngine as JServing
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.launch import serve as tserve
from repro_torch.models import (init_cache, init_model, model_apply,
                                params_from_numpy)
from repro_torch.models import attention as tattn
from repro_torch.models import layers as tlayers
from repro_torch.models import rope as trope
from repro_torch.models.config import LayerSpec as TSpec
from repro_torch.obs import TraceRecorder as TRecorder
from repro_torch.runtime import make_decode_step, make_prefill_step
from repro_torch.serving import Request as TRequest
from repro_torch.serving import ServingEngine as TServing
from repro_torch.serving import engine as tengine

ATOL = 1e-4
PORTED = list(ARCH_IDS)
#: the architectures of the families ported last (RWKV-6, Mamba with MoE,
#: multi-head latent attention with MoE and the MTP head, MoE alone)
FAMILIES = ["rwkv6-3b", "jamba-v0.1-52b", "deepseek-v3-671b", "grok-1-314b"]
#: a router's k-th against (k+1)-th score below which a ULP could flip
#: its choice between the two packages (scores of O(1) in float32)
ROUTER_MARGIN = 1e-5


def _t(a, dtype=None):
    t = torch.from_numpy(np.array(a))
    return t if dtype is None else t.to(dtype)


def _n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.array(x)


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(_n(got), np.array(want), rtol=0, atol=atol)


@functools.cache
def ref_weights(arch, seed=0):
    """(reference config, port config, the reference's seed weights as
    numpy, the same weights as the port's parameters).  Read only."""
    jcfg, tcfg = jget(arch, preset="smoke"), get_config(arch, preset="smoke")
    tree = jax.tree.map(np.array, jinit(jcfg, jax.random.PRNGKey(seed)))
    return jcfg, tcfg, tree, params_from_numpy(tcfg, tree, device="cpu")


# ------------------------------------------------------------- configs
@pytest.mark.parametrize("arch", PORTED)
@pytest.mark.parametrize("preset", ["smoke", "full"])
def test_configs_equal_reference(arch, preset):
    want = dataclasses.asdict(jget(arch, preset=preset))
    assert dataclasses.asdict(get_config(arch, preset=preset)) == want
    assert dataclasses.asdict(get_config(arch, preset=preset,
                                         variant="swa")) == \
        dataclasses.asdict(jget(arch, preset=preset, variant="swa"))


def test_unported_architectures_raise():
    """No architecture is left unported: every arch of ``ARCH_IDS`` builds
    in both presets (its config, and at the smoke preset its parameters
    and caches), and an unknown one raises ``ValueError``."""
    for arch in ARCH_IDS:
        for preset in ("smoke", "full"):
            assert get_config(arch, preset=preset).name.startswith(
                arch.split("-")[0])
        cfg = get_config(arch, preset="smoke")
        p = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
        assert len(p["stages"]) == len(cfg.stages)
        if not cfg.encoder_only:
            assert len(init_cache(cfg, 1, 8, device="cpu")) == len(cfg.stages)
    with pytest.raises(ValueError, match="unknown arch"):
        get_config("gpt-2")


def test_qwen3_full_width_and_vocab_padding():
    cfg = get_config("qwen3-4b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
            cfg.head_dim, cfg.d_ff, cfg.vocab_size, cfg.dtype) == (
        36, 2560, 32, 8, 128, 9728, 151936, "bfloat16")
    assert tlayers.pad_vocab(151936) == 152064 == jlayers.pad_vocab(151936)
    assert tlayers.pad_vocab(122753) == jlayers.pad_vocab(122753) == 122880


# -------------------------------------------------------------- layers
def test_rms_norm_mlp_embed_unembed_equal_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    w = (0.1 * rng.standard_normal(64)).astype(np.float32)
    close(tlayers.rms_norm(_t(x), _t(w), 1e-5),
          jlayers.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5), 1e-6)
    mlp = {k: (rng.standard_normal(s) / 8).astype(np.float32) for k, s in
           (("wi_gate", (64, 96)), ("wi_up", (64, 96)), ("wo", (96, 64)))}
    close(tlayers.apply_mlp({k: _t(v) for k, v in mlp.items()}, _t(x)),
          jlayers.apply_mlp({k: jnp.asarray(v) for k, v in mlp.items()},
                            jnp.asarray(x)), 1e-5)
    table = rng.standard_normal((tlayers.pad_vocab(300), 64)).astype(
        np.float32)
    ids = rng.integers(0, 300, (2, 7))
    np.testing.assert_array_equal(
        _n(tlayers.apply_embedding({"table": _t(table)}, _t(ids))),
        np.array(jlayers.apply_embedding({"table": jnp.asarray(table)},
                                         jnp.asarray(ids))))
    g = torch.Generator().manual_seed(0)
    emb = tlayers.init_embedding(g, 300, 64, torch.float32)["table"]
    un = tlayers.init_unembed(g, 64, 300, torch.float32)["w"]
    assert emb.shape == (512, 64) and un.shape == (64, 512)
    # truncated at two standard deviations of 1/sqrt(64)
    assert float(emb.abs().max()) <= 2 * 64 ** -0.5 + 1e-7
    tn = tlayers.truncated_normal(torch.Generator().manual_seed(1),
                                  (20000,), torch.float32, 1.0)
    assert float(tn.abs().max()) <= 2.0 and 0.8 < float(tn.std()) < 0.9


@pytest.mark.parametrize("variant", ["none", "full", "glm"])
def test_rope_equals_reference(variant):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(9), np.arange(100, 109)]).astype(np.int32)
    for theta in (1e4, 1e6):
        close(trope.apply_rope(_t(x), _t(pos), theta, variant),
              jrope.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta,
                               variant), 1e-5)
    with pytest.raises(ValueError):
        trope.apply_rope(_t(x), _t(pos), 1e4, "2d")


# ----------------------------------------------------------- attention
def _gqa_case(window, qk_norm=True):
    """A 4-head / 2-KV-head smoke config (windowed: a ring shorter than
    the sequence) with the reference's weights."""
    jcfg = jget("qwen3-4b", preset="smoke").replace(qk_norm=qk_norm)
    tcfg = get_config("qwen3-4b", preset="smoke").replace(qk_norm=qk_norm)
    p = jax.tree.map(np.array, jattn.init_gqa(jax.random.PRNGKey(3), jcfg))
    if qk_norm:
        for k in ("q_norm", "k_norm"):
            p[k]["scale"] = np.full_like(p[k]["scale"], 0.1)
    tp = {k: ({kk: _t(vv) for kk, vv in v.items()} if isinstance(v, dict)
              else _t(v)) for k, v in p.items()}
    return jcfg, tcfg, jax.tree.map(jnp.asarray, p), tp, window


@pytest.mark.parametrize("window", [None, 5])
def test_apply_gqa_train_prefill_decode_equal_reference(window):
    jcfg, tcfg, jp, tp, window = _gqa_case(window)
    jspec, tspec = JSpec("attn", "dense", window), TSpec("attn", "dense",
                                                         window)
    rng = np.random.default_rng(2)
    T, steps, cache_len = 9, 6, 16
    x = (rng.standard_normal((2, T + steps, jcfg.d_model)) / 4).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (2, T))
    for mode in ("train", "prefill"):
        jc = jattn.init_gqa_cache(jcfg, jspec, 2, cache_len, jnp.float32)
        tc = tattn.init_gqa_cache(tcfg, tspec, 2, cache_len, torch.float32,
                                  "cpu")
        jy, jc = jattn.apply_gqa(jp, jcfg, jspec, jnp.asarray(x[:, :T]),
                                 jnp.asarray(pos), mode=mode, cache=jc)
        ty, tc = tattn.apply_gqa(tp, tcfg, tspec, _t(x[:, :T]), _t(pos),
                                 mode=mode, cache=tc)
        close(ty, jy, 1e-5)
    assert tc["k"].shape[1] == (window or cache_len)   # the ring length
    close(tc["k"], jc["k"], 1e-5)
    close(tc["v"], jc["v"], 1e-5)
    for s in range(steps):                  # the windowed ring wraps
        p1 = np.full((2, 1), T + s, np.int32)
        jy, jc = jattn.apply_gqa(jp, jcfg, jspec,
                                 jnp.asarray(x[:, T + s:T + s + 1]),
                                 jnp.asarray(p1), mode="decode", cache=jc,
                                 decode_pos=jnp.asarray(T + s, jnp.int32))
        ty, tc = tattn.apply_gqa(tp, tcfg, tspec, _t(x[:, T + s:T + s + 1]),
                                 _t(p1), mode="decode", cache=tc,
                                 decode_pos=T + s)
        close(ty, jy, 1e-5)
        close(tc["k"], jc["k"], 1e-5)


@pytest.mark.parametrize("next_pos", [1, 5, 8, 13, 40])
def test_ring_positions_equal_reference(next_pos):
    kp, valid = tattn._ring_positions(8, next_pos)
    jkp, jvalid = jattn._ring_positions(8, jnp.asarray(next_pos, jnp.int32))
    np.testing.assert_array_equal(_n(kp), np.array(jkp))
    np.testing.assert_array_equal(_n(valid), np.array(jvalid))


@pytest.mark.parametrize("causal,window", [(True, None), (True, 700),
                                           (False, None)])
def test_chunked_sdpa_equals_reference_and_the_plain_path(causal, window):
    """T=1024 queries at positions 1024.. over S=2048 keys, 4 query heads
    on 2 KV heads: ``sdpa_masked`` takes the online-softmax path."""
    rng = np.random.default_rng(4)
    q = rng.standard_normal((1, 1024, 4, 16)).astype(np.float32)
    k = rng.standard_normal((1, 2048, 2, 16)).astype(np.float32)
    v = rng.standard_normal((1, 2048, 2, 16)).astype(np.float32)
    qp = (np.arange(1024) + 1024)[None].astype(np.int32)
    kp = np.arange(2048)[None].astype(np.int32)
    args = (causal, window, None, 0.25)
    got = tattn.sdpa_masked(_t(q), _t(k), _t(v), _t(qp), _t(kp), *args)
    want = jattn.sdpa_masked(*map(jnp.asarray, (q, k, v, qp, kp)), *args)
    close(got, want, 1e-5)
    mask = tattn.make_mask(_t(qp), _t(kp), causal, window)
    close(got, tattn.sdpa(_t(q), _t(k), _t(v), mask, 0.25), 1e-5)


def test_sdpa_mha_and_masked_rows_equal_reference():
    rng = np.random.default_rng(5)
    q, k, v = (rng.standard_normal((2, 6, 3, 8)).astype(np.float32)
               for _ in range(3))
    qp = np.tile(np.arange(6), (2, 1)).astype(np.int32)
    valid = np.ones((2, 6), bool)
    valid[1, :4] = False                      # rows 0-3 see no key
    got = tattn.sdpa_masked(*map(_t, (q, k, v, qp, qp)), True, None,
                            _t(valid), 0.3)
    want = jattn.sdpa_masked(*map(jnp.asarray, (q, k, v, qp, qp)), True,
                             None, jnp.asarray(valid), 0.3)
    close(got, want, 1e-6)


# --------------------------------------------------------------- model
def _inputs(cfg, B=2, S=12, seed=0):
    rng = np.random.default_rng(seed)
    if cfg.modality == "audio":
        f = rng.standard_normal((B, S, cfg.frontend_dim)).astype(np.float32)
        return {"features": jnp.asarray(f)}, {"features": _t(f)}
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    jb, tb = {"tokens": jnp.asarray(toks)}, {"tokens": _t(toks, torch.long)}
    if cfg.modality == "vlm":
        img = rng.standard_normal((B, 4, cfg.frontend_dim)).astype(
            np.float32)
        jb["image_embeds"], tb["image_embeds"] = jnp.asarray(img), _t(img)
    return jb, tb


@pytest.fixture
def router_margins(monkeypatch):
    """Every call of the port's ``moe.route`` records its least margin
    between the k-th and (k+1)-th router score over its tokens."""
    from repro_torch.models import moe as tmoe
    seen, sound = [], tmoe.route

    def route(x_flat, router_w, m):
        top = torch.sort(tmoe.router_scores(x_flat.float() @ router_w, m),
                         -1, descending=True).values
        seen.append(float((top[:, m.top_k - 1] - top[:, m.top_k]).min()))
        return sound(x_flat, router_w, m)

    monkeypatch.setattr(tmoe, "route", route)
    return seen


@pytest.mark.parametrize("arch", PORTED)
def test_model_apply_train_equals_reference(arch, router_margins):
    """Logits, the auxiliary losses (zero without an MoE layer) and the
    MTP head's logits against the reference; where the model routes, each
    router's least top-k margin exceeds ``ROUTER_MARGIN``, so both
    packages route every token alike."""
    jcfg, tcfg, tree, p = ref_weights(arch)
    jb, tb = _inputs(jcfg)
    jl, _, jaux = japply(jax.tree.map(jnp.asarray, tree), jcfg, jb)
    tl, cache, aux = model_apply(p, tcfg, tb)
    assert cache is None and set(aux) == set(jaux)
    if tcfg.moe is None:
        assert aux == {"aux_loss": 0.0, "load_balance": 0.0,
                       "router_z": 0.0}
    assert all(m > ROUTER_MARGIN for m in router_margins), router_margins
    for k in ("aux_loss", "load_balance", "router_z"):
        close(aux[k], np.array(jaux[k]), 1e-5)
    V = jcfg.vocab_size
    close(tl[..., :V], np.array(jl)[..., :V])
    if tcfg.mtp:
        close(aux["mtp_logits"][..., :V], np.array(jaux["mtp_logits"])[
            ..., :V])
    # the pad slots are masked out of the softmax with finfo.min
    assert tl.shape[-1] == tlayers.pad_vocab(V)
    assert bool((tl[..., V:] == torch.finfo(torch.float32).min).all())


@pytest.mark.parametrize("arch", ["qwen3-4b", "minicpm-2b", "chatglm3-6b",
                                  *FAMILIES])
@pytest.mark.parametrize("decode_window", [None, 8])
def test_prefill_and_decode_steps_equal_reference(arch, decode_window,
                                                  router_margins):
    """The prefill step over a 12-token prompt into a 16-slot cache, then
    6 decode steps (with ``decode_window`` 8 an attention ring wraps; the
    Mamba and RWKV states ignore it), feeding the reference's greedy
    tokens to both; every cache leaf against the reference's at the end.
    Where the model routes, every router margin exceeds
    ``ROUTER_MARGIN``."""
    jcfg, tcfg, tree, p = ref_weights(arch)
    jcfg = jcfg.replace(decode_window=decode_window)
    tcfg = tcfg.replace(decode_window=decode_window)
    jp = jax.tree.map(jnp.asarray, tree)
    jb, tb = _inputs(jcfg)
    jl, jc = jax.jit(jprefill_step(jcfg, cache_len=16))(jp, jb)
    jdecode = jax.jit(jdecode_step(jcfg))
    tl, tc = make_prefill_step(tcfg, cache_len=16)(p, tb)
    close(tl, jl)
    pos = 12
    for _ in range(6):
        nxt = np.array(jnp.argmax(jl, -1))[:, None].astype(np.int32)
        np.testing.assert_array_equal(_n(torch.argmax(tl, -1)), nxt[:, 0])
        jl, jc = jdecode(jp, {"tokens": jnp.asarray(nxt),
                                         "cache": jc,
                                         "decode_pos": jnp.asarray(pos)})
        tl, tc = make_decode_step(tcfg)(p, {"tokens": _t(nxt, torch.long),
                                            "cache": tc, "decode_pos": pos})
        close(tl, jl)
        pos += 1
    assert all(m > ROUTER_MARGIN for m in router_margins), router_margins
    for stage, js, ts in zip(tcfg.stages, jc, tc):  # caches, layer by layer
        n = len(stage.pattern)
        for i, lc in enumerate(ts["caches"]):
            want = dict(_leaves(js["caches"][i % n]))
            got = dict(_leaves(lc))
            assert set(got) == set(want) and got
            for key, t in got.items():
                assert t.dtype == getattr(torch, want[key].dtype.name)
                close(t, np.array(want[key])[i // n], 1e-5)


def test_decode_logits_equal_a_fresh_prefill():
    """At each decode step the logits equal a prefill of the prompt plus
    the tokens so far, at its last position (the ring cache and the rope
    position), as chip_smoke checks at full width on the card."""
    _, cfg, _, p = ref_weights("qwen3-4b")
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        0, cfg.vocab_size, (1, 10)))
    logits, cache = make_prefill_step(cfg, cache_len=32)(p, {"tokens": toks})
    decode = make_decode_step(cfg)
    for step in range(5):
        nxt = torch.argmax(logits, -1)[:, None]
        toks = torch.cat([toks, nxt], 1)
        logits, cache = decode(p, {"tokens": nxt, "cache": cache,
                                   "decode_pos": toks.shape[1] - 1})
        fresh, _ = make_prefill_step(cfg)(p, {"tokens": toks})
        close(logits, _n(fresh), 1e-5)


def test_init_model_matches_the_reference_tree():
    for arch in ("qwen3-4b", "minicpm-2b", "hubert-xlarge", *FAMILIES):
        jcfg, tcfg, tree, ref = ref_weights(arch)
        mine = init_model(tcfg, torch.Generator().manual_seed(0),
                          device="cpu")
        flat = lambda d: {k: (v.shape, v.dtype) for k, v in  # noqa: E731
                          _leaves(d)}
        assert flat(mine) == flat(ref)
        assert sum(len(s["layers"]) for s in mine["stages"]) == \
            tcfg.n_layers
    c = init_cache(ref_weights("hubert-xlarge")[1], 3, 16, device="cpu")
    assert c[0]["caches"][0]["mixer"]["k"].shape == (3, 16, 4, 64)


def _leaves(d, prefix=""):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(d, list):
        for i, v in enumerate(d):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, d


def test_params_from_numpy_carries_bfloat16():
    jcfg = jget("qwen3-4b", preset="smoke").replace(dtype="bfloat16",
                                                    param_dtype="bfloat16")
    tcfg = get_config("qwen3-4b", preset="smoke").replace(
        dtype="bfloat16", param_dtype="bfloat16")
    tree = jax.tree.map(np.array, jinit(jcfg, jax.random.PRNGKey(0)))
    p = params_from_numpy(tcfg, tree, device="cpu")
    w = p["stages"][0]["layers"][1]["mixer"]["wq"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(),
        tree["stages"][0]["layers"][0]["mixer"]["wq"][1].astype(np.float32))


# ------------------------------------------------------------- serving
def _serve_both(sched, drop_when_busy=False, n=6, new=8):
    jcfg, tcfg, tree, p = ref_weights("qwen3-4b")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, jcfg.vocab_size - 1, 16).astype(np.int32)
               for _ in range(n)]
    jrec, trec = JRecorder(), TRecorder()
    kw = dict(n_replicas=3, scheduler=sched, cache_len=64,
              drop_when_busy=drop_when_busy)
    jo = JServing(jcfg, params=jax.tree.map(jnp.asarray, tree),
                  recorder=jrec, **kw).serve(
        [JRequest(i, q, new, float(i)) for i, q in enumerate(prompts)])
    to = TServing(tcfg, params=p, recorder=trec, device="cpu", **kw).serve(
        [TRequest(i, q, new, float(i)) for i, q in enumerate(prompts)])
    return jo, to, jrec, trec


@pytest.mark.parametrize("sched", ["rr", "fcfs"])
def test_serving_engine_tokens_counts_and_events_equal_reference(sched):
    jo, to, jrec, trec = _serve_both(sched)
    assert [r.rid for r in to["responses"]] == [r.rid
                                                for r in jo["responses"]]
    for a, b in zip(jo["responses"], to["responses"]):
        np.testing.assert_array_equal(b.tokens, a.tokens)
        assert b.tokens.dtype == np.int32 and len(b.tokens) == 8
    assert to["dropped"] == jo["dropped"] == []
    assert to["per_replica"] == jo["per_replica"]
    assert [e["kind"] for e in trec.events] == [e["kind"]
                                                for e in jrec.events]
    assert set(to) == set(jo)


def test_serving_engine_empty_trace_and_bad_pool():
    _, cfg, _, p = ref_weights("qwen3-4b")
    eng = TServing(cfg, params=p, n_replicas=2, device="cpu")
    out = eng.serve([])
    assert out["responses"] == [] and out["per_replica"] == {0: 0, 1: 0}
    with pytest.raises(ValueError, match="n_replicas"):
        TServing(cfg, params=p, n_replicas=0, device="cpu")


def test_serve_tokens_cli_prints_the_reference_first_response(monkeypatch,
                                                               capsys):
    """``launch.serve --payload tokens --device cpu`` with the reference's
    weights (the port's ``init_model`` draws its own, so the engine's
    default draw is replaced by the reference's seed-0 weights)."""
    _serve_tokens_cli(monkeypatch, capsys, [])


@pytest.mark.parametrize("arch", FAMILIES)
def test_serve_tokens_cli_new_families_print_the_reference_first_response(
        monkeypatch, capsys, arch):
    """The same for the smoke presets of the families ported last."""
    _serve_tokens_cli(monkeypatch, capsys, ["--arch", arch])


def _serve_tokens_cli(monkeypatch, capsys, extra):
    def ref_init(cfg, generator, device=None):
        arch = next(a for a in ARCH_IDS
                    if get_config(a, preset="smoke").name == cfg.name)
        tree = jax.tree.map(np.array, jinit(jget(arch, preset="smoke"),
                                            jax.random.PRNGKey(0)))
        return params_from_numpy(cfg, tree, device=device)

    argv = ["--payload", "tokens", "--requests", "3", "--n-replicas", "2",
            *extra]
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve.main()
    want = capsys.readouterr().out
    monkeypatch.setattr(tengine, "init_model", ref_init)
    tserve.main(argv + ["--device", "cpu"])
    got = capsys.readouterr().out
    line = [ln for ln in want.splitlines() if ln.startswith("first")]
    assert line and line[0] in got.splitlines()
    assert got.splitlines()[0] == want.splitlines()[0]
