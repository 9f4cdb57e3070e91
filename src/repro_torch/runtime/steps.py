"""Train / prefill / decode step builders (the port of the reference
package's ``runtime/steps.py``).  The reference jits each step; here
each is a plain function that runs eagerly on the device of its inputs.

``GraphedDecode`` is the decode step replayed from CUDA graphs, which
``serving.ServingEngine`` runs on a CUDA device.

A train state is the reference's tree, ``{"params": ..., "opt": {"m",
"v", "step"}}``, of tensors.  The train step passes its gradients
through ``sharding.rules.constrain_like_params``, as the reference's
does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict

import torch

from ..device import cudnn_deterministic, ieee_float32
from ..kernels import ops
from ..models import init_cache, init_model, model_apply, moe
from ..models.config import ModelConfig
from ..models.layers import cross_entropy
from ..models.transformer import (decode_run, decode_runs, flat_layers,
                                  write_back)
from ..obs.trace import span
from ..optim import AdamWConfig, adamw_init, adamw_update
from ..optim.adamw import tree_map
from ..sharding.rules import constrain_like_params


@dataclass
class TrainState:
    params: Any
    opt_state: Any


def train_state_init(cfg: ModelConfig, generator: torch.Generator,
                     opt_cfg: AdamWConfig, device=None):
    """Parameters drawn from ``generator`` (``models.init_model``) and
    zero AdamW moments, on ``device`` (None: ``cuda``, raising where no
    CUDA device exists)."""
    params = init_model(cfg, generator, device=device)
    return {"params": params, "opt": adamw_init(params, opt_cfg)}


def loss_fn(params, cfg: ModelConfig, batch: Dict, remat=False):
    """``(total loss, metrics)``: the masked token cross-entropy, plus the
    MoE auxiliary losses, plus ``cfg.mtp_loss_weight`` times the
    multi-token-prediction loss where the model has the head (labels
    rolled by -1, the mask's last two columns zeroed)."""
    logits, _, aux = model_apply(params, cfg, batch, mode="train",
                                 remat=remat)
    labels = batch["labels"]
    mask = batch.get("loss_mask")
    loss = cross_entropy(logits, labels, mask)
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float32,
                                     device=loss.device)
    metrics = {"ce_loss": loss, "aux_loss": as_t(aux["aux_loss"]),
               "load_balance": as_t(aux["load_balance"])}
    total = loss + aux["aux_loss"]
    if cfg.mtp and "mtp_logits" in aux:
        mtp_labels = torch.roll(labels, -1, dims=1)
        mtp_mask = (mask.clone() if mask is not None
                    else torch.ones(labels.shape, dtype=torch.float32,
                                    device=labels.device))
        mtp_mask[:, -2:] = 0.0
        mtp_loss = cross_entropy(aux["mtp_logits"], mtp_labels, mtp_mask)
        total = total + cfg.mtp_loss_weight * mtp_loss
        metrics["mtp_loss"] = mtp_loss
    metrics["total_loss"] = total
    return total, metrics


def grad_fn(params, cfg: ModelConfig, batch: Dict, remat=False):
    """``(grads, metrics)``: the gradient of ``loss_fn``'s total loss
    with respect to every parameter (the parameters' tree and dtypes; a
    parameter the loss does not reach gets zeros, as ``jax.grad``
    gives), and its metrics, detached.  Products run in IEEE float32
    (``device.ieee_float32``) and cuDNN deterministically
    (``device.cudnn_deterministic``) through forward, recompute and
    backward."""
    with ieee_float32(), cudnn_deterministic():
        work = tree_map(lambda t: t.detach().requires_grad_(), params)
        leaves = []
        tree_map(leaves.append, work)
        total, metrics = loss_fn(work, cfg, batch, remat=remat)
        got = torch.autograd.grad(total, leaves, allow_unused=True)
    by_leaf = {id(w): g for w, g in zip(leaves, got)}
    grads = tree_map(lambda w: torch.zeros_like(w) if by_leaf[id(w)] is None
                     else by_leaf[id(w)], work)
    return grads, {k: v.detach() for k, v in metrics.items()}


def make_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, schedule,
                    remat: bool = True, donate: bool = False):
    """``train_step(state, batch) -> (new state, metrics)``: ``grad_fn``,
    the learning rate ``schedule(step)`` at the optimizer's step count
    before the update, and ``adamw_update``.  The metrics are
    ``loss_fn``'s plus ``grad_norm`` (before clipping) and ``lr``.  With
    ``donate`` the new state is written into the given state's tensors,
    as the reference's launcher donates its state to the jitted step."""
    def train_step(state, batch):
        grads, metrics = grad_fn(state["params"], cfg, batch, remat=remat)
        grads = constrain_like_params(grads)
        lr = schedule(state["opt"]["step"])
        params, opt, gnorm = adamw_update(state["params"], grads,
                                          state["opt"], opt_cfg, lr,
                                          donate=donate)
        metrics = dict(metrics, grad_norm=gnorm, lr=lr)
        return {"params": params, "opt": opt}, metrics
    return train_step


def make_prefill_step(cfg: ModelConfig, cache_len: int | None = None):
    """``prefill(params, batch) -> (logits (B, V) at the last position,
    cache)``; the cache holds ``cache_len`` positions (default: the
    prompt's length) on the device of the batch's inputs."""
    def prefill(params, batch):
        x = batch["features"] if cfg.modality == "audio" else batch["tokens"]
        S = _seq_len(cfg, batch)
        cache = init_cache(cfg, x.shape[0], cache_len or S, device=x.device)
        logits, cache, _ = model_apply(params, cfg, batch, mode="prefill",
                                       cache=cache)
        return logits[:, -1], cache
    return prefill


def make_decode_step(cfg: ModelConfig):
    """``decode(params, {"tokens" (B, 1), "cache", "decode_pos"}) ->
    (logits (B, V), cache)``."""
    def decode(params, batch):
        logits, cache, _ = model_apply(
            params, cfg, {"tokens": batch["tokens"]}, mode="decode",
            cache=batch["cache"], decode_pos=batch["decode_pos"])
        return logits[:, -1], cache
    return decode


class GraphedDecode:
    """``decode(params, batch)``: the step of ``make_decode_step`` over
    fixed buffers, cut at each MoE layer's router
    (``models.transformer.decode_runs``).  On a CUDA device the first
    call runs the step eagerly, then captures each run and each MoE
    layer's work after its router as CUDA graphs in one memory pool;
    every later call replays them.  On the CPU every call runs eagerly
    over the same buffers.

    The router stays eager: at every call each MoE layer calls
    ``models.moe.apply_moe`` (looked up then, as ``model_apply`` does),
    which calls ``route`` and hands its fresh ``(w, idx)`` to
    ``MoEGraph``, which copies them into the graph's inputs and replays
    the dispatch, experts and combine inside that call.

    One set of graphs serves one batch size, cache shape and parameter
    tree, those of the first call; ``decode_pos`` is held in a 0-d device
    tensor (``fill_``, no host read) and the cache in buffers that the
    step writes.  It returns those buffers as its cache: a call with
    another cache (a new request's prefill) copies it in first.  So the
    returned logits and cache are rewritten by the next call."""

    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg
        self.runs = decode_runs(cfg)
        self.params = self.cache = None
        self.graphs = []                # an ops.CountedGraph a run
        self.experts = []               # (ffn params, MoEGraph) a router

    @torch.no_grad()
    def __call__(self, params, batch):
        if self.cache is None:
            self._fix(params, batch)
        elif params is not self.params:
            raise ValueError("this decode step holds another parameter "
                             "tree: make a step for each")
        if self.graphs:
            with span("llm.decode_graph"):
                return self._step(batch, self._replayed), self.cache
        logits = self._step(batch, self._eager)
        if self.tokens.device.type == "cuda":
            self._capture()
        return logits, self.cache

    def _fix(self, params, batch):
        tokens = batch["tokens"]
        self.params = params
        self.cache = tree_map(torch.empty_like, batch["cache"])
        self.tokens = torch.empty(tokens.shape, dtype=torch.int64,
                                  device=tokens.device)
        self.pos = torch.zeros((), dtype=torch.int64, device=tokens.device)
        ffn = [lp["ffn"] for lp in flat_layers(params["stages"], "layers")]
        self.experts = [(ffn[stop - 1], MoEGraph())
                        for _, stop in self.runs[:-1]]

    def _step(self, batch, run):
        if batch["cache"] is not self.cache:
            write_back(self.cache, batch["cache"])
        self.tokens.copy_(batch["tokens"])
        self.pos.fill_(batch["decode_pos"])
        with ieee_float32():
            return self._walk(run, self._routed)

    def _walk(self, run, ffn):
        """The step: ``run(i, h, f)`` for each run and, between two,
        ``ffn(params, x, experts)`` for the MoE layer that ends the first;
        returns the last run's logits."""
        h, f = self.tokens, None
        for i, (p, experts) in enumerate(self.experts):
            h, x = run(i, h, f)
            f = ffn(p, x, experts)
        return run(len(self.experts), h, f)

    def _eager(self, i, h, f):
        return decode_run(self.params, self.cfg, self.runs[i], h, f,
                          self.cache, self.pos)

    def _replayed(self, i, h, f):
        return self.graphs[i].replay()

    def _routed(self, p, x, experts):
        return moe.apply_moe(p, self.cfg, x, experts=experts)[0]

    def _capture(self):
        pool = torch.cuda.graph_pool_handle()
        dev = self.tokens.device

        def run(i, h, f):
            self.graphs.append(ops.CountedGraph(
                lambda: self._eager(i, h, f), dev, pool))
            return self.graphs[-1].out

        with ieee_float32():
            self._walk(run, lambda p, x, experts: experts.capture(
                p, self.cfg, x, pool))


class MoEGraph:
    """What follows an MoE layer's router in ``GraphedDecode``, as
    ``apply_moe``'s ``experts``: each call copies the router's ``(w,
    idx)`` into fixed inputs, then runs ``moe.moe_experts`` on them, or,
    once captured (an ``ops.CountedGraph``), replays it."""

    def __init__(self):
        self.choices = self.graph = None

    def __call__(self, p, cfg, x, choices):
        if self.choices is None:
            self.choices = [(w.clone(), idx.clone()) for w, idx in choices]
        else:
            for fixed, new in zip(self.choices, choices):
                for a, b in zip(fixed, new):
                    a.copy_(b)
        if self.graph is None:
            return moe.moe_experts(p, cfg, x, self.choices)
        return self.graph.replay()

    def capture(self, p, cfg, x, pool):
        self.graph = ops.CountedGraph(
            lambda: moe.moe_experts(p, cfg, x, self.choices), x.device,
            pool)
        return self.graph.out


def _seq_len(cfg: ModelConfig, batch):
    if cfg.modality == "audio":
        return batch["features"].shape[1]
    S = batch["tokens"].shape[1]
    if cfg.modality == "vlm" and "image_embeds" in batch:
        S += batch["image_embeds"].shape[1]
    return S
