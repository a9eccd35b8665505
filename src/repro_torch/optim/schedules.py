"""Learning-rate schedules: step -> 0-d fp32 tensor, computed in fp32 as
the JAX package's (port of ``repro/optim/schedules.py``)."""

from __future__ import annotations

import math

import torch


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def constant(lr: float):
    return lambda step: _f32(lr)


def step_decay(lr: float, *, decay: float = 0.2, every: int = 10_000):
    """The paper's schedule: multiply by ``decay`` every ``every`` steps
    (they use x0.2 every 10 epochs)."""
    def f(step):
        k = torch.floor_divide(torch.as_tensor(step), every).float()
        return lr * _f32(decay) ** k
    return f


def cosine(lr: float, total_steps: int, final_frac: float = 0.1):
    def f(step):
        t = torch.clamp(_f32(step) / total_steps, 0.0, 1.0)
        return lr * (final_frac + (1 - final_frac)
                     * 0.5 * (1 + torch.cos(math.pi * t)))
    return f


def warmup_cosine(lr: float, total_steps: int, warmup: int = 100,
                  final_frac: float = 0.1):
    base = cosine(lr, total_steps, final_frac)

    def f(step):
        w = torch.clamp(_f32(step) / max(warmup, 1), 0.0, 1.0)
        return w * base(max(int(step) - warmup, 0))
    return f
