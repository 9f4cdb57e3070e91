"""DeepSeek-V3's published mechanisms on the port against the benchmark's
plain reference (``bench/reference/mla_moe.py``, the file that decides
the ``dsv3-decode`` cell's ``correct``), on the CPU, at the ``small``
preset (16 experts in 4 groups, top 4 inside the best 2, YaRN as
published, 1 dense and 2 MoE layers), on seeded random weights, in
float32.  Every comparison is of logits or weights, not of sampled
tokens, but where a step's own tokens are compared bit for bit.

Tolerances, each from what float32 leaves between two orders of the same
sums: ``ATOL`` = 1e-4 on logits of O(1) (up to about 4 here) between the
program (prefill through ``sdpa``, decode weight-absorbed through the
latent ring) and the reference (the expanded form, other product
orders; the largest difference measured here is 3.7e-6);
``SHARE_ATOL`` = 1e-5 on an MoE layer's output (about 1 here) summed
over four shares against the uncut layer (each share adds its experts'
part in its own order); the YaRN frequencies within 1e-6 relative of the
float64 closed form (float32 powers)."""
import dataclasses
import math

import numpy as np
import pytest
import torch

from bench.reference import mla_moe as ref
from repro_torch.configs import get_config
from repro_torch.models import init_model, model_apply
from repro_torch.models import attention, layers, moe, rope
from repro_torch.models.transformer import flat_layers
from repro_torch.runtime import GraphedDecode, make_decode_step, \
    make_prefill_step

ATOL = 1e-4
SHARE_ATOL = 1e-5
ARCH = "deepseek-v3-671b"


def small(first=0, held=0):
    """The small preset, holding experts ``first .. first + held - 1``
    (all 16 where ``held`` is 0)."""
    cfg = get_config(ARCH, preset="small")
    return cfg.replace(moe=dataclasses.replace(
        cfg.moe, expert_first=first, n_held=held))


def ref_config(cfg):
    """The reference's reading of ``cfg``: the published keys."""
    m, a, y = cfg.moe, cfg.mla, cfg.rope_scaling
    return {
        "hidden_size": cfg.d_model, "intermediate_size": cfg.d_ff,
        "moe_intermediate_size": m.d_ff,
        "n_shared_experts": m.n_shared_experts,
        "num_attention_heads": cfg.n_heads, "q_lora_rank": a.q_lora_rank,
        "kv_lora_rank": a.kv_lora_rank, "qk_nope_head_dim": a.qk_nope_dim,
        "qk_rope_head_dim": a.qk_rope_dim, "v_head_dim": a.v_head_dim,
        "published_n_routed_experts": m.n_experts,
        "n_routed_experts": moe.held_count(m),
        "expert_parallel": {"first_expert": m.expert_first},
        "num_experts_per_tok": m.top_k, "n_group": m.n_group,
        "topk_group": m.topk_group,
        "routed_scaling_factor": m.routed_scaling_factor,
        "capacity_factor": m.capacity_factor, "rms_norm_eps": cfg.norm_eps,
        "rope_theta": cfg.rope_theta,
        "rope_scaling": dataclasses.asdict(y), "vocab_size": cfg.vocab_size,
        "num_hidden_layers": cfg.n_layers,
        "first_k_dense_replace": cfg.stages[0].repeats}


def params_of(cfg, seed=0, bias_std=0.05):
    """Seeded weights, norm gains moved off zero and a correction bias
    drawn, so that every term of the published equations is exercised."""
    g = torch.Generator().manual_seed(seed)
    p = init_model(cfg, g, device="cpu")
    for path, t in _leaves(p):
        if path.endswith("scale"):
            t.copy_(0.1 * torch.randn(t.shape, generator=g))
        elif path.endswith("router/bias"):
            t.copy_(bias_std * torch.randn(t.shape, generator=g))
    return p


def _leaves(d, prefix=""):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _leaves(v, f"{prefix}/{k}")
    elif isinstance(d, list):
        for i, v in enumerate(d):
            yield from _leaves(v, f"{prefix}/{i}")
    else:
        yield prefix, d


class _Routes:
    """Records the experts each ``moe.route`` call chose."""

    def __init__(self, monkeypatch):
        self.calls, real = [], moe.route

        def route(*a, **kw):
            out = real(*a, **kw)
            self.calls.append(out[1])
            return out
        monkeypatch.setattr(moe, "route", route)

    def per_layer(self, n_moe, L):
        return [torch.cat(self.calls[i::n_moe])[:L] for i in range(n_moe)]


# ------------------------------------------------------------- the model
@pytest.mark.parametrize("first,held", [(0, 0), (4, 4)])
def test_prefill_then_decode_agree_with_the_references_forward(
        monkeypatch, first, held):
    """A prompt of 20 through the prefill (capacity drops at 1.25), then
    12 tokens decoded one at a time through the latent ring, against the
    reference's full forward over the prompt and those tokens, following
    the program's expert choices and dropping as it drops; the router
    chose the reference's own experts at every position."""
    cfg = small(first, held)
    p = params_of(cfg, seed=3)
    rng = np.random.default_rng(5)
    prompt = torch.from_numpy(rng.integers(0, cfg.vocab_size, 20))
    routes = _Routes(monkeypatch)
    prefill = make_prefill_step(cfg, cache_len=40)
    decode = make_decode_step(cfg)
    got, toks = [], prompt
    with torch.no_grad():
        lg, cache = prefill(p, {"tokens": toks[None]})
        got.append(lg[0])
        for t in range(12):
            nxt = lg.argmax(-1)
            toks = torch.cat([toks, nxt])
            lg, cache = decode(p, {"tokens": nxt[None], "cache": cache,
                                   "decode_pos": 20 + t})
            got.append(lg[0])
    seq = (toks, 20, list(range(19, 32)))
    used = routes.per_layer(2, 32)
    reference = ref.Reference(p, ref_config(cfg))
    want, rgap, _ = reference.forward([seq], [used])
    torch.testing.assert_close(torch.stack(got), want[0], atol=ATOL, rtol=0)
    assert rgap == [0.0] and reference.miss_share() == 0.0
    _, _, own = ref.Reference(p, ref_config(cfg)).forward([seq])
    assert all(torch.equal(a, b) for a, b in zip(own[0], used))


# ------------------------------------------------------------ the router
def _router_case(logits, bias=None):
    """``moe.route`` on tokens whose router logits are ``logits`` (T, E)
    exactly: x is the identity, the router's weight the logits."""
    m = small().moe
    T, E = logits.shape
    x = torch.eye(T, E)
    w = torch.zeros(E, E)
    w[:T] = logits
    b = torch.zeros(E) if bias is None else bias
    got_w, got_idx, _ = moe.route(x, w, m, bias=b)
    return m, got_w, got_idx, b


def _ref_route(logits, b):
    c = ref_config(small())
    scores = torch.sigmoid(logits)
    idx, _ = ref.group_choice(scores + b, c)
    w = scores.gather(1, idx)
    return idx, w / w.sum(-1, keepdim=True) * c["routed_scaling_factor"]


def test_published_router_agrees_with_the_reference():
    g = torch.Generator().manual_seed(7)
    logits = torch.randn((16, 16), generator=g)
    bias = 0.3 * torch.randn(16, generator=g)
    m, w, idx, b = _router_case(logits, bias)
    want_idx, want_w = _ref_route(logits, b)
    assert torch.equal(idx, want_idx)
    torch.testing.assert_close(w, want_w, rtol=1e-6, atol=0)
    assert torch.allclose(w.sum(-1), torch.full((16,), 2.5))
    # every token's experts lie in topk_group = 2 of the 4 groups
    assert all(len(set((r // 4).tolist())) <= 2 for r in idx)


def test_router_ties_go_to_the_lower_index_in_groups_and_experts():
    """All scores equal: groups 0 and 1 are kept and experts 0..3 of
    group 0 chosen, as the reference's stable sorts choose."""
    logits = torch.zeros((3, 16))
    logits[1, [4, 5]] = 1.0          # group 1's two best beat group 0's
    logits[2, [8, 12]] = 1.0         # groups 2 and 3 tie above 0 and 1
    _, w, idx, b = _router_case(logits)
    want_idx, want_w = _ref_route(logits, b)
    assert torch.equal(idx, want_idx)
    assert idx[0].tolist() == [0, 1, 2, 3]
    assert idx[1].tolist() == [4, 5, 0, 1]
    assert idx[2].tolist() == [8, 12, 9, 10]
    torch.testing.assert_close(w, want_w, rtol=1e-6, atol=0)


def test_the_bias_changes_the_chosen_group_but_not_the_weights():
    """Group 0 leads on the scores; a bias on group 3 moves the choice
    there, and the weights stay the scores (without the bias) at the
    chosen experts, normalized and scaled."""
    logits = torch.zeros((1, 16))
    logits[0, :4] = 2.0
    bias = torch.zeros(16)
    _, _, plain, _ = _router_case(logits)
    assert set(plain[0].tolist()) <= set(range(8))
    bias[12:] = 1.0
    _, w, idx, b = _router_case(logits, bias)
    want_idx, want_w = _ref_route(logits, b)
    assert torch.equal(idx, want_idx)
    assert set(range(12, 16)) <= set(idx[0].tolist())
    s = torch.sigmoid(logits[0, idx[0]])
    torch.testing.assert_close(w[0], s / s.sum() * 2.5, rtol=1e-6, atol=0)


def test_the_softmax_and_smoke_routers_keep_the_plain_top_k():
    """Without groups or a bias, ``route`` is the reference package's:
    the top k of the scores, normalized, unscaled."""
    g = torch.Generator().manual_seed(2)
    x, w = torch.randn((6, 8), generator=g), torch.randn((8, 4), generator=g)
    for arch in ("grok-1-314b", ARCH):
        m = get_config(arch, preset="smoke").moe
        assert not moe.published(m)
        wt, idx, _ = moe.route(x, w, m)
        s = moe.router_scores(x @ w, m)
        v, i = torch.sort(s, dim=-1, descending=True, stable=True)
        assert torch.equal(idx, i[:, :m.top_k])
        torch.testing.assert_close(
            wt, v[:, :m.top_k] / v[:, :m.top_k].sum(-1, keepdim=True))


# ----------------------------------------------------------------- YaRN
def test_yarn_frequencies_and_scale_equal_the_closed_form():
    cfg = get_config(ARCH)
    y = cfg.rope_scaling
    dim, theta = cfg.mla.qk_rope_dim, cfg.rope_theta

    def corr(rot):
        return dim * math.log(4096 / (rot * 2 * math.pi)) / (
            2 * math.log(theta))
    low, high = math.floor(corr(32)), math.ceil(corr(1))
    assert (low, high) == (10, 23)
    assert rope.yarn_correction_range(y, dim, theta) == (low, high)
    want = []
    for i in range(dim // 2):
        f = theta ** (-2 * i / dim)
        ramp = min(max((i - low) / (high - low), 0.0), 1.0)
        want.append(f / 40 * ramp + f * (1 - ramp))
    got = rope._rope_freqs(dim, theta, torch.device("cpu"), y)
    np.testing.assert_allclose(got.double().numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(
        ref.yarn_inv_freq(ref_config(small()) | {"rope_theta": theta},
                          dim).double().numpy(), want, rtol=1e-6)
    assert rope.yarn_attention_factor(y) == 1.0
    scale = 192 ** -0.5 * (0.1 * math.log(40) + 1) ** 2
    assert attention.mla_softmax_scale(cfg) == pytest.approx(scale,
                                                             rel=1e-15)
    assert attention.mla_softmax_scale(
        get_config(ARCH, preset="smoke")) == 48 ** -0.5
    # unscaled cos and sin: a rotation keeps each pair's norm
    x = torch.randn((1, 5, 2, dim))
    r = rope.apply_rope(x, torch.arange(5)[None] * 1000, theta, "full", y)
    torch.testing.assert_close(r.norm(dim=-1), x.norm(dim=-1))


# ------------------------------------------------------- the expert share
def test_four_shares_add_up_to_the_uncut_layer():
    """16 experts over 4 shares of 4: each share's MoE layer (its experts'
    part plus the shared expert) over a 24-token prefill with capacity
    drops; the four routed parts, with the shared expert counted once,
    add up to the uncut reference's layer, and the program's uncut layer
    gives the same."""
    cfg = small()
    p = params_of(cfg, seed=11)
    f = flat_layers(p["stages"], "layers")[1]["ffn"]
    x = torch.randn((1, 24, cfg.d_model),
                    generator=torch.Generator().manual_seed(4))
    with torch.no_grad():
        shared = layers.apply_mlp(f["shared"], x)
        total = shared.clone()
        for s in range(4):
            part = small(4 * s, 4)
            fs = dict(f, experts={k: v[4 * s:4 * s + 4]
                                  for k, v in f["experts"].items()})
            out, _ = moe.apply_moe(fs, part, x)
            total += out - shared
        uncut, _ = moe.apply_moe(f, cfg, x)
        want, _, _ = ref.Reference(p, ref_config(cfg)).moe_ffn(f, x[0], 24)
    torch.testing.assert_close(total[0], want, atol=SHARE_ATOL, rtol=0)
    torch.testing.assert_close(uncut[0], want, atol=SHARE_ATOL, rtol=0)
    assert moe.capacity(24, cfg.moe) < 24      # the prefill drops pairs


def test_a_pair_held_elsewhere_takes_the_overflow_slot():
    """``_dispatch_tables`` of a share: held experts' pairs take their
    place's slots in token order, up to C; a pair of an expert held
    elsewhere gets the overflow slot ``E*C``, as a dropped pair does, and
    is written into no kept slot."""
    idx = torch.tensor([[5, 1], [5, 6], [2, 5], [4, 9]])
    w = torch.full((4, 2), 0.5)
    slot_tok, slot_w, pair = moe._dispatch_tables(w, idx, 4, 2, 2, 2,
                                                  first=4)
    E, C = 2, 2
    assert pair.tolist() == [[C, E * C], [C + 1, E * C],
                             [E * C, E * C], [0, E * C]]
    assert slot_tok.tolist() == [3, 0, 0, 1]
    assert slot_w.tolist() == [0.5, 0.0, 0.5, 0.5]


# ------------------------------------------------------ the graphed step
@pytest.mark.parametrize("first,held", [(0, 0), (8, 4)])
def test_graphed_decodes_eager_path_equals_the_plain_step(first, held):
    """``GraphedDecode`` on the CPU (its buffers, its eager runs cut at
    each router) gives the plain decode step's logits bit for bit, and
    so its tokens, with the share and without it."""
    cfg = small(first, held)
    p = params_of(cfg, seed=9)
    prompt = torch.arange(10)[None] * 7 % cfg.vocab_size
    prefill = make_prefill_step(cfg, cache_len=24)
    outs = []
    for step in (make_decode_step(cfg), GraphedDecode(cfg)):
        with torch.no_grad():
            lg, cache = prefill(p, {"tokens": prompt})
            seen = []
            for t in range(8):
                nxt = lg.argmax(-1)[:, None]
                lg, cache = step(p, {"tokens": nxt, "cache": cache,
                                     "decode_pos": 10 + t})
                seen.append(lg.clone())
        outs.append(torch.stack(seen))
    assert torch.equal(outs[0], outs[1])


def test_a_model_apply_with_the_share_routes_over_every_expert(monkeypatch):
    """The router of a share keeps all 16 outputs and its top 4; the
    expert stacks hold only the share."""
    cfg = small(12, 4)
    p = params_of(cfg)
    f = flat_layers(p["stages"], "layers")[1]["ffn"]
    assert f["router"]["w"].shape == (cfg.d_model, 16)
    assert f["router"]["bias"].shape == (16,)
    assert f["experts"]["w_gate"].shape == (4, cfg.d_model, cfg.moe.d_ff)
    routes = _Routes(monkeypatch)
    with torch.no_grad():
        model_apply(p, cfg, {"tokens": torch.arange(12)[None]})
    assert [r.shape for r in routes.calls] == [(12, 4)] * 2
    assert max(int(r.max()) for r in routes.calls) >= 4
