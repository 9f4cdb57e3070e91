"""Dispatch-counted step cost: FLOPs and bytes of one model step (the
counterpart of the reference package's ``hlo.py``).

The reference parses the compiled HLO text of a jitted step, walking
``while`` bodies with their trip counts, because XLA's own cost analysis
counts a ``lax.scan`` layer stack once.  Eager PyTorch compiles no
program, so there is no HLO to parse: every operation of a step is
dispatched one by one, and counting the dispatched operations counts
every layer.

* FLOPs come from ``torch.utils.flop_counter.FlopCounterMode`` (matrix
  products, convolutions and attention, as the reference counts ``dot``
  and ``convolution``).
* Bytes are the sum, over dispatched operations that are not views, of
  the bytes of their input and output tensors: the eager port's own
  traffic, each operation reading its inputs and writing its outputs
  through memory.  They are not comparable with the reference's bytes,
  which XLA's fusion keeps on chip between the operations of a fusion.

Both run on ``meta`` tensors (shapes and dtypes, no data), so a step of
a full-size configuration is counted in host memory.  Counting every
layer of a long sequence still dispatches every operation in Python, so
``model_step_cost`` counts cut configurations and extrapolates: every
repetition of a stage dispatches the same operations on the same shapes,
so a step's cost is linear in each stage's ``repeats``, exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import FlopCounterMode


class _ByteCounter(TorchDispatchMode):
    """Adds the bytes of every dispatched non-view operation's input and
    output tensors."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if not func.is_view:
            for t in tree_leaves((args, kwargs, out)):
                if isinstance(t, torch.Tensor):
                    self.bytes += t.numel() * t.element_size()
        return out


def step_cost(fn: Callable, *args, **kwargs) -> Dict[str, int]:
    """``{"flops", "bytes"}`` of one call ``fn(*args, **kwargs)``: every
    operation it dispatches, forward and backward."""
    flops = FlopCounterMode(display=False)
    nbytes = _ByteCounter()
    with flops, nbytes:
        fn(*args, **kwargs)
    return {"flops": int(flops.get_total_flops()), "bytes": nbytes.bytes}


def with_repeats(cfg, repeats):
    """``cfg`` with stage ``i`` repeated ``repeats[i]`` times."""
    return cfg.replace(stages=tuple(
        dataclasses.replace(s, repeats=r)
        for s, r in zip(cfg.stages, repeats)))


def model_step_cost(cfg, count: Callable) -> Dict[str, int]:
    """A step's cost at ``cfg``'s depth from cut configurations:
    ``count(cut_cfg) -> {"flops", "bytes"}`` runs at every stage
    repeated once, and again with each stage in turn repeated twice; the
    difference is one repetition of that stage, added ``repeats - 1``
    times to the first count.  Exact, because every repetition of a
    stage dispatches the same operations on the same shapes."""
    ones = [1] * len(cfg.stages)
    base = count(with_repeats(cfg, ones))
    total = dict(base)
    for i, stage in enumerate(cfg.stages):
        if stage.repeats == 1:
            continue
        two = count(with_repeats(cfg, ones[:i] + [2] + ones[i + 1:]))
        for k in total:
            total[k] += (two[k] - base[k]) * (stage.repeats - 1)
    return total
