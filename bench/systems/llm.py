"""The token cells: the program's ``ServingEngine`` (prefill, then greedy
decode through the ring cache, over ``models/transformer.py`` and its MoE
layer) serving one request a call, closed-loop.

The window sends the mix's requests one after another until
``--seconds`` have passed and the request in flight has returned.
``output_tokens_per_s`` is every generated token of the window's
requests over the window; ``request_latency_p95_ms`` the 95th percentile
of each ``serve`` call's wall.

``correct`` runs the plain reference (``reference.llm``) over a sample of
the window's requests, drawn from the seed with the longest among them:
each prompt with its served tokens, once, following the program's own
expert choices (a near tie in the router goes either way under bf16
rounding, and one expert more or less changes a token's state by tens
of percent).  The choices are those the timed serve made: every run
keeps, for the length of the window, the expert indices that
``models.moe.route`` returns, request by request (a reference to each
index tensor; nothing is copied or synchronized).  It compares the
widest gap by which a served token's reference logit lies below the
reference's best; for the choices it followed, the widest gap by which
a chosen expert's router logit lies below the reference's k-th best;
and the share of (position, layer) choices that are not the reference's
own top k.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import harness
from .. import traffic as traffic_mod
from ..reference import llm as ref_llm
from ..trace import DeviceTrace, Spans


def model_config(config: dict):
    """The port's configuration of the model, cut to the file's depth,
    after checking it against every width the file states."""
    from repro_torch.configs import get_config
    from repro_torch.models import LayerSpec, Stage
    cfg = get_config(config["port_config"],
                     preset=config.get("port_preset", "full"))
    cfg = cfg.replace(stages=(Stage((LayerSpec("attn", "moe"),),
                                    config["num_hidden_layers"]),))
    got = {"hidden_size": cfg.d_model, "intermediate_size": cfg.moe.d_ff,
           "num_attention_heads": cfg.n_heads,
           "num_key_value_heads": cfg.n_kv_heads, "head_dim": cfg.head_dim,
           "num_experts": cfg.moe.n_experts,
           "num_experts_per_tok": cfg.moe.top_k,
           "vocab_size": cfg.vocab_size, "rope_theta": cfg.rope_theta,
           "rms_norm_eps": cfg.norm_eps,
           "capacity_factor": cfg.moe.capacity_factor,
           "dispatch": cfg.moe.dispatch, "torch_dtype": cfg.dtype}
    bad = {k: (v, config[k]) for k, v in got.items() if v != config[k]}
    if bad or cfg.qk_norm or cfg.tie_embeddings:
        raise SystemExit(f"the port's {config['port_config']} differs from "
                         f"the benchmark's configuration: {bad}")
    return cfg


def make_params(cfg, config: dict, seed: int, device):
    """Weights in the program's layout, drawn on ``device`` from
    ``seed``: one ``torch.randn`` call a tensor, in the dtype the
    program serves it in (checked against ``models.param_shapes``)."""
    from repro_torch.models import param_shapes
    g = torch.Generator(device=device).manual_seed(seed)
    norm_std = config["weights"]["norm_std"]

    def draw(path, meta):
        t = torch.randn(meta.shape, generator=g, device=device,
                        dtype=meta.dtype)
        if path[-1] == "scale":
            return t.mul_(norm_std)
        fan_in = meta.shape[-1] if path[-1] == "table" else meta.shape[-2]
        return t.mul_(fan_in ** -0.5)

    def walk(path, node):
        if isinstance(node, dict):
            return {k: walk(path + (k,), v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(path + (i,), v) for i, v in enumerate(node)]
        return draw(path, node)

    return walk((), param_shapes(cfg))


def run(ctx):
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
    from repro_torch.models import moe
    real_route, routes = moe.route, []

    def route(*a, **kw):
        out = real_route(*a, **kw)
        routes.append(out[1])
        return out

    moe.route = route
    spans = dtrace = None
    if ctx.trace:
        spans = Spans(device)
        spans.wrap(moe, "apply_moe", "bench.moe", sync=False)
        spans.wrap(moe, "route", "bench.route", sync=False,
                   info=lambda a, kw, out: out[1].detach().clone())
        dtrace = DeviceTrace()
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
    if spans:
        spans.unwrap()
    moe.route = real_route
    ctx.read_memory()
    failed = sum(g is None or len(g) != n for _, n, g, *_ in done)
    out = {"attempted": len(done), "failed": failed,
           "e2e": {"output_tokens_per_s": harness.rate(
                       sum(len(g) for _, _, g, *_ in done
                           if g is not None), window),
                   "request_latency_p95_ms": harness.p95_ms(
                       [b - a for *_, a, b, _ in done])},
           "counts": {"requests": len(done),
                      "tokens": sum(n for _, n, *_ in done)}}
    del engine
    out["compared"] = compare(ctx, params, done)
    if dtrace:
        out["trace"] = dtrace.read()
        out["spans"] = spans.between("bench.moe", dtrace.t0, dtrace.t1) \
            + spans.between("bench.route", dtrace.t0, dtrace.t1)
        out["requests"] = [(len(t), n) for t, n, g, a, b, _ in done
                           if a >= dtrace.t0 and b <= dtrace.t1]
    return out


def sample(ctx, done):
    """Completed requests to check, drawn from the seed: the longest,
    then others in a seeded order until ``sample_tokens`` served tokens
    are covered."""
    ok = [i for i, (_, n, g, *_) in enumerate(done)
          if g is not None and len(g) == n]
    if not ok:
        return []
    longest = max(ok, key=lambda i: len(done[i][0]) + done[i][1])
    rng = np.random.default_rng([ctx.seed, 4])
    pick, n_tok = [longest], done[longest][1]
    for i in rng.permutation(ok):
        if n_tok >= ctx.mix["sample_tokens"]:
            break
        if i != longest:
            pick.append(int(i))
            n_tok += done[i][1]
    return pick


def sequences(done, pick):
    """Each sampled request as the reference reads it: the prompt and
    every served token but the last; scored at the prompt's last position
    and each decoded one."""
    seqs = []
    for i in pick:
        toks, n, got, *_ = done[i]
        P = len(toks)
        full = np.concatenate([toks, got[:-1]]).astype(np.int64)
        seqs.append((torch.from_numpy(full), P, list(range(P - 1, P + n - 1))))
    return seqs


def routing(done, pick, n_layers: int):
    """The expert choices the timed serve made for each sampled request,
    a (positions, k) tensor a layer: the route calls of its prefill and
    decode steps, ``n_layers`` a step, joined a layer at a time and cut
    to the positions the reference scores (the program may run a step
    more, whose token is not served)."""
    out = []
    for i in pick:
        toks, n, _, _, _, calls = done[i]
        L = len(toks) + n - 1
        per = [torch.cat(calls[li::n_layers])[:L] for li in range(n_layers)]
        if any(len(p) != L for p in per):
            raise RuntimeError(f"request {i}: the route calls cover "
                               f"{len(per[0])} of its {L} positions")
        out.append(per)
    return out


def compare(ctx, params, done):
    """The numbers compared, each with its limit.  The reference follows
    the choices the timed serve made and holds every served token to its
    logits (``logit_gap``); the choices themselves are held to the
    reference's router (``routing_gap``, and ``routing_miss_share``: the
    share of choices that are not its own top k)."""
    limits = ctx.config["limits"].get(ctx.cell["name"], {})
    pick = sample(ctx, done)
    seqs = sequences(done, pick)
    used = routing(done, pick, ctx.config["num_hidden_layers"])
    for d in done:
        d[-1].clear()
    _free(ctx.device)
    with torch.no_grad(), _ieee():
        ref = ref_llm.Reference(params, ctx.config)
        logits, rgap, _ = ref.forward(seqs, used)
        got = {"logit_gap": max((float(ref_llm.gaps(lg, done[i][2]).max())
                                 for i, lg in zip(pick, logits)),
                                default=0.0),
               "routing_gap": max(rgap, default=0.0),
               "routing_miss_share": ref.miss_share()}
        if ctx.control:
            ctl = ref_llm.Reference(params, ctx.config, fp8=True)
            c_logits, _, c_routing = ctl.forward(seqs)
            judge = ref_llm.Reference(params, ctx.config)
            j_logits, c_gap, _ = judge.forward(seqs, c_routing)
            got["control.logit_gap"] = max(
                float(ref_llm.gaps(j, c.argmax(-1)).max())
                for j, c in zip(j_logits, c_logits))
            got["control.routing_gap"] = max(c_gap)
            got["control.routing_miss_share"] = judge.miss_share()
    return {k: (v, limits.get(k)) for k, v in got.items()}


def _free(device):
    if device.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class _ieee:
    """Float32 products in IEEE float32 (no TF32) while the reference
    runs."""

    def __enter__(self):
        self.old = (torch.backends.cuda.matmul.allow_tf32,
                    torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self.old
