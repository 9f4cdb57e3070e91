"""The DeepSeek-V3 token cell: the program's ``ServingEngine`` (prefill,
then greedy decode through the latent ring cache, replayed from CUDA
graphs on a card) over multi-head latent attention and an MoE layer that
holds one card's share of the routed experts, serving one request a
call, closed-loop, as ``llm.py``'s cells do.

The window sends the mix's requests one after another until
``--seconds`` have passed and the request in flight has returned;
``output_tokens_per_s`` is every generated token of the window's
requests over the window.  Every run keeps the expert indices that
``models.moe.route`` returns, request by request (a reference to each
index tensor; nothing is copied or synchronized): the choices the
reference follows, and, in a traced run, the pairs the held experts
computed, which the per-layer readers count.

``correct`` runs the plain reference (``reference.mla_moe``) over a
sample of the window's requests (``llm.sample``), each prompt with its
served tokens, following the timed serve's expert choices, and compares
the widest gap by which a served token's reference logit lies below the
reference's best (``logit_gap``); for the group-limited router, the
widest gap by which a chosen group's score lies below the reference's
``topk_group``-th best group or a chosen expert's choice score below the
reference's k-th best inside the chosen groups (``routing_gap``); and
the share of (position, layer) choices that are not the reference's own
(``routing_miss_share``).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import harness
from .. import traffic as traffic_mod
from ..reference import mla_moe as ref_mla
from ..reference.llm import gaps
from ..trace import DeviceTrace
from .llm import _free, _ieee, routing, sample, sequences
from .llm import make_params as draw_params


def model_config(config: dict):
    """The port's configuration of the model, cut to the file's depth and
    expert share, after checking it against every width and routing
    setting the file states."""
    from repro_torch.configs import get_config
    from repro_torch.models import LayerSpec, Stage
    cfg = get_config(config["port_config"],
                     preset=config.get("port_preset", "full"))
    dense = config["first_k_dense_replace"]
    ep = config["expert_parallel"]
    cfg = cfg.replace(
        stages=(Stage((LayerSpec("attn", "dense"),), dense),
                Stage((LayerSpec("attn", "moe"),),
                      config["num_hidden_layers"] - dense)),
        moe=dataclasses.replace(cfg.moe, n_held=config["n_routed_experts"],
                                expert_first=ep["first_expert"]),
        mtp=config["num_nextn_predict_layers"] > 0,
        norm_eps=config["rms_norm_eps"])
    m, mla, y = cfg.moe, cfg.mla, cfg.rope_scaling
    got = {"hidden_size": cfg.d_model, "intermediate_size": cfg.d_ff,
           "moe_intermediate_size": m.d_ff,
           "n_shared_experts": m.n_shared_experts,
           "num_attention_heads": cfg.n_heads,
           "num_key_value_heads": cfg.n_kv_heads,
           "q_lora_rank": mla.q_lora_rank, "kv_lora_rank": mla.kv_lora_rank,
           "qk_nope_head_dim": mla.qk_nope_dim,
           "qk_rope_head_dim": mla.qk_rope_dim,
           "v_head_dim": mla.v_head_dim,
           "published_n_routed_experts": m.n_experts,
           "num_experts_per_tok": m.top_k, "n_group": m.n_group,
           "topk_group": m.topk_group,
           "routed_scaling_factor": m.routed_scaling_factor,
           "scoring_func": m.router, "vocab_size": cfg.vocab_size,
           "rope_theta": cfg.rope_theta,
           "capacity_factor": m.capacity_factor, "dispatch": m.dispatch,
           "torch_dtype": cfg.dtype,
           "tie_word_embeddings": cfg.tie_embeddings}
    bad = {k: (v, config[k]) for k, v in got.items() if v != config[k]}
    rs = config["rope_scaling"]
    if y is None or (y.factor, y.original_max_position_embeddings,
                     y.beta_fast, y.beta_slow, y.mscale,
                     y.mscale_all_dim) != (
            rs["factor"], rs["original_max_position_embeddings"],
            rs["beta_fast"], rs["beta_slow"], rs["mscale"],
            rs["mscale_all_dim"]):
        bad["rope_scaling"] = (y, rs)
    if not m.correction_bias or config["topk_method"] != "noaux_tc":
        bad["topk_method"] = (m.correction_bias, config["topk_method"])
    if bad or cfg.qk_norm:
        raise SystemExit(f"the port's {config['port_config']} differs from "
                         f"the benchmark's configuration: {bad}")
    return cfg


def make_params(cfg, config: dict, seed: int, device):
    """``llm.make_params``'s draws for every tensor but the correction
    bias, which a second generator draws from the seed, N(0,1) times
    ``correction_bias_std``, one layer at a time."""
    from repro_torch.models.transformer import flat_layers
    m = cfg.moe
    params = draw_params(
        cfg.replace(moe=dataclasses.replace(m, correction_bias=False)),
        config, seed, device)
    g = torch.Generator(device=device).manual_seed(seed + 2 ** 40)
    std = config["weights"]["correction_bias_std"]
    for lp in flat_layers(params["stages"], "layers"):
        if "router" in lp["ffn"]:
            lp["ffn"]["router"]["bias"] = torch.randn(
                m.n_experts, generator=g, device=device).mul_(std)
    return params


def held_counts(idx, config: dict):
    """Pairs of ``idx`` (T, k) each held expert got, before capacity."""
    first, held = ref_mla.experts_held(config)
    local = idx.reshape(-1).long() - first
    local = local[(local >= 0) & (local < held)]
    return torch.bincount(local, minlength=held).tolist()


def kept(counts, T: int, config: dict) -> int:
    """Of the held experts' pairs, those their capacity slots keep."""
    C = ref_mla.capacity(T, config["num_experts_per_tok"],
                         config["published_n_routed_experts"],
                         config["capacity_factor"])
    return sum(min(c, C) for c in counts)


def run(ctx):
    from repro_torch.models import moe
    from repro_torch.serving import Request, ServingEngine
    config, mix, device = ctx.config, ctx.mix, ctx.device
    cfg = model_config(config)
    feed = traffic_mod.Requests(mix, ctx.seed, cfg.vocab_size)
    params = make_params(cfg, config, ctx.seed, device)
    engine = ServingEngine(cfg, params, n_replicas=4, scheduler="fcfs",
                           cache_len=feed.longest_total, device=device)
    # every prompt length of the mix, a prefill and a decode step each
    for P in sorted({p for p, _ in feed.sizes}):
        engine._generate(Request(-1, np.zeros(P, np.int32), 1))
    engine.warmup(feed.sizes[0][0])
    real_route, routes = moe.route, []

    def route(*a, **kw):
        out = real_route(*a, **kw)
        routes.append(out[1])
        return out

    moe.route = route
    dtrace = DeviceTrace() if ctx.trace else None
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_open = ctx.open_window()
    if dtrace:
        dtrace.start()
    done, rid = [], 0
    while True:
        toks, n_out = feed.next()
        routes.clear()
        t0 = time.perf_counter()
        rep = engine.serve([Request(rid, toks, n_out)])
        t1 = time.perf_counter()
        got = rep["responses"][0].tokens if rep["responses"] else None
        done.append((toks, n_out, got, t0, t1, routes[:]))
        rid += 1
        if dtrace and dtrace.t1 is None and \
                t1 - t_open >= min(mix["trace_seconds"], ctx.seconds):
            dtrace.stop()
        if t1 - t_open >= ctx.seconds:
            break
    window = t1 - t_open
    ctx.close_window()
    moe.route = real_route
    ctx.read_memory()
    failed = sum(g is None or len(g) != n for _, n, g, *_ in done)
    out = {"attempted": len(done), "failed": failed,
           "e2e": {"output_tokens_per_s": harness.rate(
                       sum(len(g) for _, _, g, *_ in done
                           if g is not None), window)},
           "counts": {"requests": len(done),
                      "tokens": sum(n for _, n, *_ in done)}}
    del engine
    if dtrace:
        out["trace"] = dtrace.read()
        traced = [d for d in done if d[3] >= dtrace.t0 and d[4] <= dtrace.t1]
        # each MoE call of the traced requests: (tokens, pairs each held
        # expert got); each request: (prompt, served, pairs kept)
        out["moe_calls"] = [(idx.shape[0], held_counts(idx, config))
                            for d in traced for idx in d[5]]
        out["requests"] = [
            (len(t), n, sum(kept(held_counts(idx, config), idx.shape[0],
                                 config) for idx in calls))
            for t, n, g, a, b, calls in traced]
    out["compared"] = compare(ctx, params, done)
    return out


def compare(ctx, params, done):
    """The numbers compared, each with its limit, as ``llm.compare``
    reads them, with this model's reference and router gaps."""
    config = ctx.config
    limits = config["limits"].get(ctx.cell["name"], {})
    pick = sample(ctx, done)
    seqs = sequences(done, pick)
    used = routing(done, pick, config["num_hidden_layers"]
                   - config["first_k_dense_replace"])
    for d in done:
        d[-1].clear()
    _free(ctx.device)
    with torch.no_grad(), _ieee():
        ref = ref_mla.Reference(params, config)
        logits, rgap, _ = ref.forward(seqs, used)
        got = {"logit_gap": max((float(gaps(lg, done[i][2]).max())
                                 for i, lg in zip(pick, logits)),
                                default=0.0),
               "routing_gap": max(rgap, default=0.0),
               "routing_miss_share": ref.miss_share()}
        if ctx.control:
            ctl = ref_mla.Reference(params, config, fp8=True)
            c_logits, _, c_routing = ctl.forward(seqs)
            judge = ref_mla.Reference(params, config)
            j_logits, c_gap, _ = judge.forward(seqs, c_routing)
            got["control.logit_gap"] = max(
                float(gaps(j, c.argmax(-1)).max())
                for j, c in zip(j_logits, c_logits))
            got["control.routing_gap"] = max(c_gap)
            got["control.routing_miss_share"] = judge.miss_share()
    return {k: (v, limits.get(k)) for k, v in got.items()}
