"""Optimizers + schedules as functions on tensors."""

from repro_torch.optim.optimizers import Optimizer, adamw, apply_updates, sgd
from repro_torch.optim.schedules import cosine, warmup_cosine

__all__ = ["sgd", "adamw", "Optimizer", "apply_updates", "cosine",
           "warmup_cosine"]
