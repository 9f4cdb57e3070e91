"""Mixture-of-Experts with capacity-based sort dispatch (the port of the
reference package's ``models/moe.py``).

Static-shape capacity dispatch, as in the reference: tokens are sorted by
expert id (stably, so the order inside an expert decides which tokens
overflow), the first ``capacity`` tokens per expert are gathered into a
dense (E, C, d) block, every expert runs as one batched product over its
C slots, and the results are added back with their router weights.

Two dispatch scopes (MoEConfig.dispatch):
  "global"  — one token pool over the whole batch;
  "batched" — routing and capacity per batch row; the auxiliary losses
              are the mean over rows.

Softmax top-k routing (Grok/Jamba/Mixtral-style) and DeepSeek-V3 sigmoid
routing with normalized top-k weights, plus shared experts.  The port
adds DeepSeek-V3's published router where the configuration asks for it
(``n_group`` above 1 or a correction bias; the reference package has
neither): the choice score is the sigmoid plus the bias, the
``topk_group`` groups with the best two choice scores are kept, the top
k are chosen inside them, and their weights are the sigmoid scores
(without the bias) normalized and scaled by ``routed_scaling_factor``.

An MoE layer may hold a share of its experts (``MoEConfig.n_held``,
``expert_first``: expert parallelism, one card's share).  Its router
still scores every expert and chooses the top k of all of them; its
expert stacks hold only the share, the dispatch gives a slot only to a
pair whose expert is held (any other pair goes to the overflow slot, as
a dropped pair does), and the combine adds what the held experts give,
then the shared experts.  What the other cards would add is not computed.

Three parts decide which tokens are dropped and are exact against the
reference: ``capacity``, ``route``'s ``idx`` (``jax.lax.top_k`` puts the
lower index first on ties: here a stable descending sort) and
``_dispatch_tables`` (a stable argsort; the overflow slot ``E*C`` is
written many times and cut off, as in the reference).  Every operation
of the dispatch has a ``meta`` kernel: no boolean indexing, and the
expert counts by ``scatter_add_``, not ``bincount``.  The combine adds
each token's expert outputs in ascending expert order, in the activation
dtype, one addition after another: a fixed order on every device, where
the reference's scatter-add leaves it to XLA and ``index_add_`` on CUDA
adds in an order that may change between runs, so two bf16 decodes on
the card are bit-equal.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..obs.trace import span
from ..sharding.context import constrain
from . import layers
from .config import ModelConfig, MoEConfig


def init_moe(generator, cfg: ModelConfig):
    m: MoEConfig = cfg.moe
    dt = layers.torch_dtype(cfg.param_dtype)
    E, d, f = m.n_experts, cfg.d_model, m.d_ff
    held = held_count(m)
    p = {
        "router": {"w": layers.dense_init(generator, d, E, torch.float32)},
        "experts": {
            "w_gate": _stack_init(generator, held, d, f, dt),
            "w_up": _stack_init(generator, held, d, f, dt),
            "w_down": _stack_init(generator, held, f, d, dt),
        },
    }
    if m.correction_bias:           # the published init: zero, then learned
        p["router"]["bias"] = torch.zeros((E,), dtype=torch.float32,
                                          device=generator.device)
    if m.n_shared_experts:
        sf = (m.shared_d_ff or m.d_ff) * m.n_shared_experts
        p["shared"] = layers.init_mlp(generator, d, sf, dt)
    return p


def _stack_init(generator, E, d_in, d_out, dt):
    """(E, d_in, d_out) expert weights, drawn one expert at a time, so
    the float32 draw of a whole stack is never live."""
    out = torch.empty((E, d_in, d_out), dtype=dt, device=generator.device)
    if out.is_meta:                 # a shape-only build draws nothing
        return out
    for e in range(E):
        out[e] = layers.dense_init(generator, d_in, d_out, dt)
    return out


def held_count(m: MoEConfig) -> int:
    """How many experts the layer holds (all of them unless a share)."""
    return m.n_held or m.n_experts


def capacity(n_tokens: int, m: MoEConfig) -> int:
    c = int(math.ceil(n_tokens * m.top_k / m.n_experts * m.capacity_factor))
    return max(4, min(n_tokens, -(-c // 4) * 4))  # mult-of-4, >=4, <=T


def top_k(scores, k):
    """``jax.lax.top_k`` over the last axis: the k largest, the lower
    index first among equal scores."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def router_scores(logits, m: MoEConfig):
    """The scores the top k is chosen from: sigmoid (DeepSeek-V3) or
    softmax over the experts."""
    if m.router == "sigmoid":
        return torch.sigmoid(logits)
    return torch.softmax(logits, dim=-1)


def published(m: MoEConfig, bias=None) -> bool:
    """Whether the layer routes as DeepSeek-V3 publishes (groups or a
    correction bias), else as the reference package does."""
    return m.n_group > 1 or m.correction_bias or bias is not None


def choice_scores(scores, m: MoEConfig, bias=None):
    """The published router's choice scores (T, E): ``scores`` plus the
    correction bias, and -inf outside the ``topk_group`` best of the
    ``n_group`` groups, a group scored by the sum of its two best choice
    scores (ties to the lower group).  Its top k are the experts."""
    choice = scores if bias is None else scores + bias
    T, E = choice.shape
    grouped = choice.reshape(T, m.n_group, E // m.n_group)
    _, best = top_k(top_k(grouped, 2)[0].sum(-1), m.topk_group)
    keep = torch.zeros((T, m.n_group), dtype=torch.bool,
                       device=choice.device).scatter_(1, best, True)
    return torch.where(keep[:, :, None], grouped,
                       float("-inf")).reshape(T, E)


def chosen_weights(scores, idx, m: MoEConfig):
    """The published router's weights: the scores at the chosen experts,
    normalized to sum 1, times ``routed_scaling_factor``."""
    w = scores.gather(-1, idx)
    w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    if m.routed_scaling_factor != 1.0:
        w = w * m.routed_scaling_factor
    return w


def route(x_flat, router_w, m: MoEConfig, bias=None):
    """x_flat: (T, d) -> (weights (T,k), idx (T,k), aux dict); ``bias``
    the correction bias (E,) where the layer has one."""
    with span("moe.route"):
        return _route(x_flat, router_w, m, bias)


def _route(x_flat, router_w, m, bias):
    logits = x_flat.float() @ router_w                    # (T, E)
    scores = router_scores(logits, m)
    if published(m, bias):
        _, idx = top_k(choice_scores(scores, m, bias), m.top_k)
        w = chosen_weights(scores, idx, m)
    else:
        w, idx = top_k(scores, m.top_k)
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-9)
    probs = scores
    if m.router == "sigmoid":
        probs = scores / torch.clamp(scores.sum(-1, keepdim=True), min=1e-9)
    # load-balance aux (Switch-style): E * sum_i f_i * P_i
    T = x_flat.shape[0]
    f = expert_counts(idx, m.n_experts).float()
    f = f / (T * m.top_k)
    P = probs.mean(dim=0)
    lb = m.n_experts * torch.sum(f * P)
    zl = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))
    aux = {"load_balance": lb, "router_z": zl,
           "aux_loss": m.aux_loss_weight * lb + m.router_z_weight * zl}
    return w, idx, aux


def expert_counts(idx, E: int):
    """How many entries of ``idx`` name each of the ``E`` experts, as
    ``torch.bincount(idx.reshape(-1), minlength=E)`` counts them (int64),
    by an integer ``scatter_add_``, which also runs on ``meta`` tensors
    (``bincount`` has no meta kernel)."""
    flat = idx.reshape(-1).long()
    return torch.zeros(E, dtype=torch.int64, device=idx.device).scatter_add_(
        0, flat, torch.ones_like(flat))


def _dispatch_tables(w, idx, T: int, E: int, k: int, C: int, first=None):
    """Sort-based dispatch tables: slot -> (token id, combine weight), and
    the slot of each (token, choice) pair of ``idx`` (T, k), ``E*C`` where
    the pair overflows its expert's C slots (a dropped pair).  Empty slots
    hold token 0 and weight 0; an overflowing pair is written nowhere
    that is kept.  With ``first``, the layer holds the ``E`` experts
    ``first .. first + E - 1`` of a larger set: ``idx`` holds global ids,
    a held expert's slots are those of its place in the share, and a pair
    whose expert is not held gets slot ``E*C`` too."""
    e_flat = idx.reshape(-1)                              # (T*k,)
    groups = E
    if first is not None:           # the pairs held elsewhere sort last
        e_flat = e_flat - first
        e_flat = torch.where((e_flat >= 0) & (e_flat < E), e_flat,
                             torch.full_like(e_flat, E))
        groups = E + 1
    order = torch.argsort(e_flat, stable=True)            # group by expert
    e_sorted = e_flat[order]
    counts = expert_counts(e_flat, groups)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k, device=idx.device) - starts[e_sorted]
    valid = pos < C
    dest = torch.where(valid, e_sorted * C + pos,
                       torch.full_like(pos, E * C))       # overflow slot
    if first is not None:           # and so does a pair held elsewhere
        dest = dest.clamp(max=E * C)
    tok_of = torch.div(order, k, rounding_mode="floor")
    # every overflowing pair lands in the extra slot E*C, cut off after
    slot_tok = torch.zeros(E * C + 1, dtype=torch.int64, device=w.device)
    slot_w = torch.zeros(E * C + 1, dtype=torch.float32, device=w.device)
    slot_tok = slot_tok.scatter_(0, dest, tok_of)[:E * C]
    slot_w = slot_w.scatter_(0, dest, w.reshape(-1)[order].float())[:E * C]
    pair_slot = torch.empty_like(dest)
    pair_slot[order] = dest
    return slot_tok, slot_w, pair_slot.reshape(T, k)


def _expert_ffn(we, x_disp):
    """x_disp: (E, C, d) -> (E, C, d), one batched product per matrix."""
    gate = F.silu(torch.bmm(x_disp, we["w_gate"]))
    up = torch.bmm(x_disp, we["w_up"])
    return torch.bmm(gate * up, we["w_down"])


def _moe_routed(p, m: MoEConfig, x_flat, w, idx, C):
    """Dispatch+compute+combine over one token pool (T, d) whose router
    chose ``idx`` (T, k) with weights ``w``."""
    T, d = x_flat.shape
    E, k = held_count(m), m.top_k
    share = {"first": m.expert_first} if m.n_held else {}
    slot_tok, slot_w, pair_slot = _dispatch_tables(w, idx, T, E, k, C,
                                                   **share)
    # a gather whose backward adds in a fixed order (layers.apply_embedding)
    x_disp = F.embedding(slot_tok, x_flat).reshape(E, C, d) * (
        slot_w.reshape(E, C, 1) > 0).to(x_flat.dtype)
    y = _expert_ffn(p["experts"], x_disp)
    y_flat = y.reshape(E * C, d) * slot_w[:, None].to(y.dtype)
    # each token's choices taken in ascending expert order; a dropped
    # pair's slot E*C (and a pair held elsewhere) reads a zero row
    by_expert = torch.argsort(idx, dim=-1)                # experts distinct
    pair_slot = torch.gather(pair_slot, 1, by_expert)
    y_pad = torch.cat([y_flat, y_flat.new_zeros((1, d))])
    out = torch.zeros((T, d), dtype=y.dtype, device=x_flat.device)
    for j in range(k):
        out = out + y_pad[pair_slot[:, j]]
    return out


def _pools(x, m: MoEConfig):
    """The token pools of ``x`` (B, S, d) and their capacity: one pool of
    every token ("global") or one a batch row ("batched")."""
    B, S, d = x.shape
    if m.dispatch == "batched":
        return [x[b] for b in range(B)], capacity(S, m)
    return [x.reshape(B * S, d)], capacity(B * S, m)


def apply_moe(p, cfg: ModelConfig, x, experts=None):
    """x: (B, S, d) -> (B, S, d), aux.  Each token pool is routed
    (``route``), then ``experts(p, cfg, x, choices)`` runs the rest of
    the layer on the pools' chosen ``(w, idx)``: ``moe_experts`` unless
    given (the graphed decode step gives its replay of it,
    ``runtime.steps.GraphedDecode``)."""
    with span("moe"):
        return _apply_moe(p, cfg, x, experts)


def _apply_moe(p, cfg, x, experts):
    m = cfg.moe
    if m.dispatch == "batched":
        x = constrain(x, "batch", None, None)
    pools, _ = _pools(x, m)
    router = p["router"]
    bias = {"bias": router["bias"]} if "bias" in router else {}
    routed = [route(xf, router["w"], m, **bias) for xf in pools]
    out = (experts or moe_experts)(p, cfg, x, [r[:2] for r in routed])
    if len(routed) > 1:                 # "batched": the mean over rows
        aux = {key: torch.stack([r[2][key] for r in routed]).mean()
               for key in routed[0][2]}
    else:
        aux = routed[0][2]
    return out, aux


def moe_experts(p, cfg: ModelConfig, x, choices):
    """The MoE layer after its router: each pool's dispatch, experts and
    combine at its ``(w, idx)`` of ``choices``, then the shared experts;
    (B, S, d)."""
    m = cfg.moe
    B, S, d = x.shape
    pools, C = _pools(x, m)
    outs = [_moe_routed(p, m, xf, w, idx, C)
            for xf, (w, idx) in zip(pools, choices)]
    if m.dispatch == "batched":
        out = constrain(torch.stack(outs), "batch", None, None)
    else:
        out = outs[0].reshape(B, S, d)
    if "shared" in p:
        out = out + layers.apply_mlp(p["shared"], x)
    return out
