"""LR schedules (the port of the reference package's
``optim/schedules.py``): linear-warmup cosine, and MiniCPM's WSD
(Warmup-Stable-Decay, arXiv:2404.06395 §4): linear warmup to peak, a long
stable plateau, then an exponential decay tail.

A schedule maps a step (an int or an integer tensor) to a float32 0-d
tensor on the step's device (the CPU for an int), computed in float32
as the reference computes it.
"""
from __future__ import annotations

import math

import torch


def _f32(step):
    if isinstance(step, torch.Tensor):
        return step.to(torch.float32)
    return torch.tensor(step, dtype=torch.float32)


def make_schedule(kind: str, peak_lr: float, total_steps: int,
                  warmup_steps: int = 100, decay_frac: float = 0.1,
                  final_frac: float = 0.1):
    warmup_steps = max(1, min(warmup_steps, total_steps // 2))

    def cosine(step):
        step = _f32(step)
        warm = peak_lr * step / warmup_steps
        prog = torch.clamp((step - warmup_steps) /
                           max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = peak_lr * (final_frac + (1 - final_frac)
                         * 0.5 * (1 + torch.cos(math.pi * prog)))
        return torch.where(step < warmup_steps, warm, cos)

    def wsd(step):
        step = _f32(step)
        decay_steps = _f32(max(total_steps * decay_frac, 1.0))
        decay_start = total_steps - decay_steps
        warm = peak_lr * step / warmup_steps
        stable = torch.full_like(step, peak_lr)
        prog = torch.clamp((step - decay_start) / decay_steps, 0.0, 1.0)
        decay = peak_lr * torch.pow(final_frac, prog)
        return torch.where(step < warmup_steps, warm,
                           torch.where(step < decay_start, stable, decay))

    return {"cosine": cosine, "wsd": wsd}[kind]
