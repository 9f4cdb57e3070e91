"""Step builders of the port's LLM substrate (serving half)."""
from .steps import make_decode_step, make_prefill_step

__all__ = ["make_decode_step", "make_prefill_step"]
