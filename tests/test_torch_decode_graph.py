"""The decode step replayed from CUDA graphs (``runtime.steps.GraphedDecode``).

On the CPU the step runs eagerly over its fixed buffers (a 0-d device
tensor for ``decode_pos``, the cache written in place, the step cut at
each MoE layer's router), and is held bit for bit to
``make_decode_step``: logits at every step and every cache leaf, across
ring wraps, for the GQA and MLA mixers with dense and MoE ffns and the
Mamba and RWKV-6 families.  The router stays eager: one ``moe.route``
call an MoE layer a step, in layer order, each returning new tensors, so
a replaced ``route`` steers the step as it steers the eager one.

Tests marked ``card`` need a CUDA device and skip without one: a
``ServingEngine`` on the card captures its graphs once and serves the
eager step's tokens bit for bit, and under a profiler every
``repro.llm.decode`` range holds one ``repro.llm.decode_graph`` range."""
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.models import init_model, moe
from repro_torch.models.transformer import flat_layers
from repro_torch.runtime import (GraphedDecode, make_decode_step,
                                 make_prefill_step)
from repro_torch.serving import Request, ServingEngine

#: GQA + MoE, MLA + MoE with a sigmoid router and a shared expert, a
#: dense GQA family, Mamba + attention with MoE, RWKV-6
ARCHS = ["grok-1-314b", "deepseek-v3-671b", "qwen3-4b", "jamba-v0.1-52b",
         "rwkv6-3b"]
PROMPT, CACHE_LEN, WINDOW, STEPS = 5, 16, 8, 20


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphs are captured on the "
                    "card")
    return torch.device("cuda:0")


def _model(arch, device="cpu", **changes):
    cfg = get_config(arch, preset="smoke").replace(decode_window=WINDOW,
                                                   **changes)
    g = torch.Generator(device=device).manual_seed(0)
    return cfg, init_model(cfg, g, device=device)


def _decode(step, cfg, params, steps=STEPS):
    """The logits of ``steps`` greedy decode steps after a prefill of a
    fixed prompt, and the last cache."""
    toks = torch.arange(1, PROMPT + 1)[None] * 7 % 97
    logits, cache = make_prefill_step(cfg, cache_len=CACHE_LEN)(
        params, {"tokens": toks})
    out = []
    for s in range(steps):
        nxt = torch.argmax(logits, -1)[:, None]
        logits, cache = step(params, {"tokens": nxt, "cache": cache,
                                      "decode_pos": PROMPT + s})
        out.append(logits.clone())
    return out, cache


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        return [tree]
    items = tree.values() if isinstance(tree, dict) else tree
    return [x for v in items for x in _leaves(v)]


@pytest.mark.parametrize("arch", ARCHS)
def test_graph_ready_step_equals_the_eager_step(arch):
    """20 steps through a ring of 8 slots (it wraps twice): every step's
    logits and the last cache's every leaf bit-equal; the step returns
    its own buffers each time."""
    cfg, params = _model(arch)
    want, want_cache = _decode(make_decode_step(cfg), cfg, params)
    step = GraphedDecode(cfg)
    got, got_cache = _decode(step, cfg, params)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert all(torch.equal(a, b) for a, b in
               zip(_leaves(want_cache), _leaves(got_cache)))
    assert got_cache is step.cache and step.pos.ndim == 0
    assert not step.graphs                            # no capture on a CPU


@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v3-671b",
                                  "jamba-v0.1-52b"])
def test_graph_ready_step_routes_once_a_moe_layer_in_order(arch,
                                                           monkeypatch):
    """Each step calls ``moe.route`` once an MoE layer, in layer order,
    and each call returns tensors no earlier call returned."""
    cfg, params = _model(arch)
    router_ws = [lp["ffn"]["router"]["w"]
                 for lp, spec in zip(flat_layers(params["stages"], "layers"),
                                     cfg.layer_specs()) if spec.ffn == "moe"]
    sound, calls = moe.route, []

    def route(x_flat, router_w, m):
        out = sound(x_flat, router_w, m)
        calls.append((router_w, out))
        return out

    monkeypatch.setattr(moe, "route", route)
    _decode(GraphedDecode(cfg), cfg, params, steps=3)
    n_prefill = len(router_ws)          # the prefill routes once a layer
    steps = calls[n_prefill:]
    assert [w for w, _ in steps] == router_ws * 3
    tensors = [t for _, (w, idx, _) in calls for t in (w, idx)]
    assert len({id(t) for t in tensors}) == len(tensors)


@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v3-671b"])
def test_a_replaced_route_steers_both_steps_alike(arch, monkeypatch):
    """``route`` replaced as chip_smoke's ``forced_routing`` does (the
    experts chosen from outside, weights from the router's own scores
    there): the graph-ready step's logits move exactly as the eager
    step's, away from the sound ones."""
    cfg, params = _model(arch)
    sound_logits, _ = _decode(make_decode_step(cfg), cfg, params, steps=6)
    real = moe.route

    def forced(x_flat, router_w, m):
        _, idx, aux = real(x_flat, router_w, m)
        idx = (idx + 1) % m.n_experts
        w = moe.router_scores(x_flat.float() @ router_w, m).gather(-1, idx)
        return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9), idx, aux

    monkeypatch.setattr(moe, "route", forced)
    want, _ = _decode(make_decode_step(cfg), cfg, params, steps=6)
    got, _ = _decode(GraphedDecode(cfg), cfg, params, steps=6)
    assert all(torch.equal(a, b) for a, b in zip(want, got))
    assert not all(torch.equal(a, b) for a, b in zip(want, sound_logits))


def test_a_cache_of_another_shape_is_refused():
    cfg, params = _model("qwen3-4b")
    step = GraphedDecode(cfg)
    _decode(step, cfg, params, steps=1)
    toks = torch.zeros((1, PROMPT), dtype=torch.long)
    _, other = make_prefill_step(cfg, cache_len=CACHE_LEN // 4)(
        params, {"tokens": toks})
    with pytest.raises(ValueError, match="cache leaf"):
        step(params, {"tokens": toks[:, :1], "cache": other,
                      "decode_pos": PROMPT})
    with pytest.raises(ValueError, match="another parameter tree"):
        step(dict(params), {"tokens": toks[:, :1], "cache": step.cache,
                            "decode_pos": PROMPT})


def test_the_engine_decodes_eagerly_on_the_cpu():
    cfg, params = _model("grok-1-314b")
    eng = ServingEngine(cfg, params, n_replicas=1, device="cpu")
    assert not isinstance(eng.decode, GraphedDecode)


# ------------------------------------------------------------------ card
def _requests(cfg, n_out=40):
    rng = np.random.default_rng(1)
    return [Request(i, rng.integers(0, cfg.vocab_size - 1, P)
                    .astype(np.int32), n_out, float(i))
            for i, P in enumerate((7, 19, 33))]


@pytest.mark.card
@pytest.mark.parametrize("arch,bf16,batched", [
    ("grok-1-314b", False, False), ("grok-1-314b", True, False),
    ("grok-1-314b", True, True), ("deepseek-v3-671b", False, False),
    ("qwen3-4b", False, False), ("jamba-v0.1-52b", False, False),
    ("rwkv6-3b", False, False)])
def test_the_engine_replays_the_eager_steps_tokens_on_the_card(
        card, arch, bf16, batched):
    """Three requests of 7, 19 and 33 prompt tokens, 40 new tokens each
    (the 16-slot cache and the 8-slot window wrap), served by an engine
    whose step replays graphs, against a plain greedy loop over ``make_decode_step`` reading each
    token before the next step, on the same weights (float32 or bf16;
    grok-1's published "batched" dispatch too): the tokens bit-equal,
    the graphs captured once for the three requests."""
    changes = {}
    if bf16:
        changes.update(dtype="bfloat16", param_dtype="bfloat16")
    if batched:
        smoke = get_config(arch, preset="smoke")
        changes["moe"] = dataclasses.replace(smoke.moe, dispatch="batched")
    cfg, params = _model(arch, card, **changes)
    eng = ServingEngine(cfg, params, n_replicas=2, cache_len=CACHE_LEN,
                        device=card)
    assert isinstance(eng.decode, GraphedDecode)
    reqs = _requests(cfg)
    got = [r.tokens.tolist() for r in eng.serve(reqs)["responses"]]
    assert len(eng.decode.graphs) == len(eng.decode.runs)   # one capture
    prefill = make_prefill_step(cfg, cache_len=CACHE_LEN)
    decode = make_decode_step(cfg)
    with torch.no_grad():
        for req, tokens in zip(reqs, got):
            toks = torch.as_tensor(req.tokens, dtype=torch.long,
                                   device=card)[None]
            logits, cache = prefill(params, {"tokens": toks})
            want = []
            for pos in range(toks.shape[1], toks.shape[1] + 40):
                nxt = torch.argmax(logits, -1)[:, None]
                want.append(int(nxt))
                logits, cache = decode(params, {
                    "tokens": nxt, "cache": cache, "decode_pos": pos})
            assert tokens == want


@pytest.mark.card
def test_every_decode_range_holds_a_graph_range_on_the_card(card):
    """After the engine's warm-up (which captures), a profiled serve opens
    one ``repro.llm.decode_graph`` range inside each
    ``repro.llm.decode`` range, and the graphs' kernels run inside them
    (``cudaGraphLaunch`` calls inside the decode ranges)."""
    cfg, params = _model("grok-1-314b", card)
    eng = ServingEngine(cfg, params, n_replicas=1, cache_len=CACHE_LEN,
                        device=card)
    reqs = _requests(cfg, n_out=8)
    eng.warmup(PROMPT)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.serve(reqs)
    evs = list(prof.profiler.kineto_results.events())
    spans = {name: [(e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in evs if e.name().startswith(name)]
             for name in ("repro.llm.decode", "repro.llm.decode_graph",
                          "cudaGraphLaunch")}
    spans["repro.llm.decode"] = [
        (e.start_ns(), e.start_ns() + e.duration_ns()) for e in evs
        if e.name() == "repro.llm.decode"]
    decode, graph = spans["repro.llm.decode"], spans["repro.llm.decode_graph"]
    assert len(decode) == len(graph) == 3 * 8
    assert all(any(a <= c and d <= b for a, b in decode) for c, d in graph)
    n_graphs = len(eng.decode.graphs) + len(eng.decode.experts)
    assert len([c for c, _ in spans["cudaGraphLaunch"]
                if any(a <= c <= b for a, b in graph)]) == \
        len(graph) * n_graphs
    assert len(eng.decode.graphs) == len(eng.decode.runs)
