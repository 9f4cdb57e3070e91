"""Hand-rolled AdamW (the port of the reference package's
``optim/adamw.py``), with the reference's arithmetic as written:
global-norm clipping, the moment math in float32 whatever the moment
dtype, the update in float32 cast back to the parameter's dtype, and the
decay added inside the update (``p - lr * (mhat / (sqrt(vhat) + eps) +
wd * p)``).  ``torch.optim.AdamW`` is not used: it decays the parameter
before the step and keeps bf16 moments for bf16 parameters.

A tree is nested dicts and lists of tensors; leaves are visited in the
order ``jax.tree.leaves`` takes them (dict keys sorted), so the global
norm sums the same per-leaf sums in the same order.  The moment dtype is
configurable (bfloat16 moments halve the optimizer state).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..models.layers import torch_dtype


@dataclass(frozen=True)
class AdamWConfig:
    peak_lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same places of each
    tree in ``rest``), keeping the structure of dicts and lists (a tuple
    is a leaf)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree):
    """The leaves in ``jax.tree.leaves`` order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def adamw_init(params, cfg: AdamWConfig):
    dt = torch_dtype(cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else None
    return {
        "m": tree_map(zeros, params),
        "v": tree_map(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def _global_norm(tree):
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tree_leaves(tree)))


def adamw_update(params, grads, state, cfg: AdamWConfig, lr,
                 donate: bool = False):
    """One AdamW step: ``(new params, new state, the gradients' global
    norm before clipping)``.  With ``donate`` the new values are written
    into the tensors of ``params`` and ``state`` (returned as the new
    trees), as the reference's launcher lets XLA reuse its donated
    buffers; the arithmetic is the same either way."""
    step = state["step"] + 1
    gnorm = _global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    dt = torch_dtype(cfg.moment_dtype)
    stepf = step.to(torch.float32)
    bc1 = 1 - cfg.b1 ** stepf
    bc2 = 1 - cfg.b2 ** stepf

    def upd(p, g, m, v):
        g = g.float() * scale
        m32 = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v32 = cfg.b2 * v.float() + (1 - cfg.b2) * torch.square(g)
        mhat = m32 / bc1
        vhat = v32 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) + \
            cfg.weight_decay * p.float()
        new_p = p.float() - lr * delta
        if donate:
            p.copy_(new_p)
            m.copy_(m32)
            v.copy_(v32)
            return p, m, v
        return new_p.to(p.dtype), m32.to(dt), v32.to(dt)

    out = tree_map(upd, params, grads, state["m"], state["v"])
    pick = lambda i: tree_map(lambda t: t[i], out)
    if donate:
        state["step"].copy_(step)
        step = state["step"]
    return pick(0), {"m": pick(1), "v": pick(2), "step": step}, gnorm
