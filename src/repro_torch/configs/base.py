"""Config registry + the four assigned input shapes (the port of the
reference package's ``configs/base.py``).

Every architecture module exposes ``make_config(preset, variant)``:
  preset  "full"  — the exact published configuration
          "smoke" — reduced same-family variant (2 layers, d_model 256)
                    that runs a real step on the CPU
  variant None    — full attention
          "swa"   — sliding-window decode variant (window 4096)

Every architecture of the reference is listed in ``ARCH_IDS``, and the
port's model code runs each; ``get_config`` raises ``ValueError`` for a
name that is not among them.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Optional

from ..models.config import ModelConfig

SWA_WINDOW = 4096


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                 # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}

ARCH_IDS = [
    "hubert-xlarge", "chatglm3-6b", "jamba-v0.1-52b", "qwen3-4b",
    "deepseek-v3-671b", "rwkv6-3b", "mistral-nemo-12b", "grok-1-314b",
    "pixtral-12b", "minicpm-2b",
]


def get_config(arch: str, preset: str = "full",
               variant: Optional[str] = None) -> ModelConfig:
    if arch not in ARCH_IDS:
        raise ValueError(f"unknown arch {arch!r}; one of {ARCH_IDS}")
    mod = importlib.import_module(
        f"{__package__}.{arch.replace('-', '_').replace('.', '_')}")
    return mod.make_config(preset=preset, variant=variant)


def supported_shapes(cfg: ModelConfig, variant: Optional[str] = None):
    """Which of the four shapes this (arch, variant) runs — with skips as
    documented on each config module."""
    out = ["train_4k", "prefill_32k"]
    if cfg.encoder_only:
        return out                       # encoder-only: no decode step
    out.append("decode_32k")
    subquadratic = cfg.attn_free or _is_hybrid(cfg) or variant == "swa" \
        or cfg.decode_window is not None
    if subquadratic:
        out.append("long_500k")
    return out


def _is_hybrid(cfg: ModelConfig) -> bool:
    mixers = {l.mixer for s in cfg.stages for l in s.pattern}
    return "mamba" in mixers or "rwkv" in mixers

