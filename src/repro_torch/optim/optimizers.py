"""SGD(+momentum) and AdamW as functions on tensors (port of
``repro/optim/optimizers.py``).

Not ``torch.optim``: this AdamW is the JAX package's -- b2 = 0.95, weight
decay 0.1 on every coordinate, and the update

    u = -lr * (m / c1 / (sqrt(v / c2) + eps) + wd * p),   c_i = 1 - b_i^t.

The port applies an optimizer to the flat fp32 parameter vector (all leaves
at once: every rule here is per coordinate).  ``update`` updates the
moment buffers **in place** (they are the only copy, and at 3.6e8
parameters a second one costs 1.4 GB each) and returns them in the state.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable            # params -> state
    update: Callable          # (grads, state, params, lr) -> (updates, state)


def sgd(momentum: float = 0.9, nesterov: bool = False,
        weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return ({"mu": torch.zeros_like(params, dtype=torch.float32)}
                if momentum else {})

    def update(grads, state, params, lr):
        g = grads.float()
        if weight_decay:
            g = g + weight_decay * params.float()
        if momentum:
            mu = state["mu"].mul_(momentum).add_(g)
            upd = momentum * mu + g if nesterov else mu
        else:
            upd = g
        return -lr * upd, state

    return Optimizer("sgd", init, update)


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return {"mu": torch.zeros_like(params, dtype=torch.float32),
                "nu": torch.zeros_like(params, dtype=torch.float32),
                "count": torch.zeros((), dtype=torch.int32,
                                     device=params.device)}

    def update(grads, state, params, lr):
        g = grads.float()
        count = state["count"] + 1
        mu = state["mu"].mul_(b1).add_((1 - b1) * g)
        nu = state["nu"].mul_(b2).add_((1 - b2) * torch.square(g))
        t = count.float()
        c1 = 1 - torch.pow(torch.tensor(b1, device=t.device), t)
        c2 = 1 - torch.pow(torch.tensor(b2, device=t.device), t)
        den = torch.sqrt(nu / c2).add_(eps)
        updates = (mu / c1).div_(den).add_(weight_decay * params.float())
        return updates.mul_(-lr), {"mu": mu, "nu": nu, "count": count}

    return Optimizer("adamw", init, update)


def apply_updates(params: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    """params += updates, in place on the flat fp32 vector (so every leaf
    view sees the new values); returns params."""
    with torch.no_grad():
        return params.add_(updates.to(params.dtype))
