"""Closed-form operations and bytes of DeepSeek-V3's layers, as the cell
serves them (one card's share of the routed experts), that the
``mla_moe_mfu`` and ``ep_moe_roofline`` readers hold the program to.
``cfg`` is a configuration file's contents (published key names).  Each
count is what the inputs need, as ``cost.py``'s are: attention in MLA's
expanded form, and only the routed pairs of the experts held here."""
from __future__ import annotations

from .cost import PEAKS, least_time


def mla_params(cfg: dict) -> int:
    """Parameters of one MLA block's projections."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    qk = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
    r, vd = cfg["kv_lora_rank"], cfg["v_head_dim"]
    return (d * cfg["q_lora_rank"] + cfg["q_lora_rank"] * H * qk
            + d * (r + cfg["qk_rope_head_dim"])
            + r * H * cfg["qk_nope_head_dim"] + r * H * vd + H * vd * d)


def expert_params(cfg: dict) -> int:
    """Parameters of one routed expert (and of the shared one)."""
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def token_flops(cfg: dict, n_ctx: int, logits: bool) -> float:
    """FLOPs one token needs at context length ``n_ctx`` (itself
    included), without its routed experts: 2 x the parameters it uses in
    every layer (MLA; the dense FFN of the leading layers; the router and
    the shared expert of the others), the expanded attention's scores and
    values over its context, ``2 H (qk + v) n_ctx`` a layer, and the
    unembedding where its logits are needed."""
    d, H = cfg["hidden_size"], cfg["num_attention_heads"]
    n_dense = cfg["first_k_dense_replace"]
    n_moe = cfg["num_hidden_layers"] - n_dense
    attn = 2 * mla_params(cfg) + 2 * H * (
        cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"]
        + cfg["v_head_dim"]) * n_ctx
    dense = 2 * 3 * d * cfg["intermediate_size"]
    moe = 2 * (d * cfg["published_n_routed_experts"]
               + cfg["n_shared_experts"] * expert_params(cfg))
    f = cfg["num_hidden_layers"] * attn + n_dense * dense + n_moe * moe
    if logits:
        f += 2 * d * cfg["vocab_size"]
    return float(f)


def request_flops(cfg: dict, prompt: int, served: int,
                  held_pairs: int) -> float:
    """A served request of ``served`` tokens: a prefill of ``prompt``
    tokens whose last position's logits give the first token, then
    ``served - 1`` single-token steps, each needing its logits; plus the
    ``held_pairs`` (token, expert) pairs that experts held here computed,
    over every MoE layer."""
    f = sum(token_flops(cfg, t + 1, t == prompt - 1) for t in range(prompt))
    f += sum(token_flops(cfg, prompt + i + 1, True)
             for i in range(served - 1))
    return f + 2.0 * expert_params(cfg) * held_pairs


def moe_least_time(cfg: dict, n_tokens: int, held_pairs: int,
                   experts_touched: int) -> float:
    """Least time of one MoE layer over ``n_tokens`` tokens of which
    ``held_pairs`` (token, expert) pairs go to ``experts_touched``
    distinct experts held here: the router over all experts, the held
    pairs and the shared expert at the bf16 peak, against the bytes of
    the touched experts, the shared expert, the float32 router and its
    bias, read once, and the layer's input and output rows."""
    d, E = cfg["hidden_size"], cfg["published_n_routed_experts"]
    shared = cfg["n_shared_experts"]
    flops = 2.0 * (d * E * n_tokens + expert_params(cfg)
                   * (held_pairs + shared * n_tokens))
    nbytes = (2.0 * expert_params(cfg) * (experts_touched + shared)
              + 4.0 * (d * E + E) + 2.0 * 2 * n_tokens * d)
    return least_time(flops, nbytes, PEAKS["bf16_flops_per_s"])
