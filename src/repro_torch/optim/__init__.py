"""Optimizers + schedules as functions on tensors."""

from repro_torch.optim.optimizers import Optimizer, adamw, apply_updates, sgd
from repro_torch.optim.schedules import (constant, cosine, step_decay,
                                        warmup_cosine)

__all__ = ["sgd", "adamw", "Optimizer", "apply_updates", "step_decay",
           "cosine", "constant", "warmup_cosine"]
