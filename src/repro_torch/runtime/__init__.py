"""Step builders, train state, batches and checkpoints of the port's LLM
substrate, mirroring the reference package's ``runtime``."""
from .specs import concrete_batch, input_specs, make_positions
from .steps import (GraphedDecode, TrainState, grad_fn, loss_fn,
                    make_decode_step, make_prefill_step, make_train_step,
                    train_state_init)

__all__ = [
    "GraphedDecode", "TrainState", "concrete_batch", "grad_fn",
    "input_specs", "loss_fn", "make_decode_step", "make_positions",
    "make_prefill_step", "make_train_step", "train_state_init",
]
