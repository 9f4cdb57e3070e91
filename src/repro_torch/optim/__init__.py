"""The optimizer of the port's LLM training (AdamW and its learning-rate
schedules), mirroring the reference package's ``optim``."""
from .adamw import AdamWConfig, adamw_init, adamw_update
from .schedules import make_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "make_schedule"]
