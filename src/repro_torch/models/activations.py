"""The activations as the JAX package computes them.

XLA expands each of JAX's activations into its primitives and, at a
low-precision dtype, rounds to that dtype after every one; each function
here gives those bits.  The primitives, JAX's gradient rules and where
the port's values differ from JAX's (subnormals, which XLA's CPU flushes)
are listed in ``kernels/activations/ref.py``, which writes them as eager
torch ops, one kernel each.

A CPU tensor goes to that composition; a CUDA tensor to one hand-written
kernel (``csrc/activations.cu``) that runs the whole chain in registers
with the same roundings, forward and backward (``kernels/activations/
ops.py``).  :func:`gated` is the MLP's gate product ``up * f(gate)`` in
the same pass.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.activations import ops
from repro_torch.kernels.activations.ref import (GELU_C1, GELU_C2,  # noqa: F401
                                                 rounded)

__all__ = ["sigmoid", "silu", "gelu", "softplus", "log_sigmoid", "tanh",
           "gated", "ACTS"]


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: ``1 / (1 + exp(-x))``, rounded after each op."""
    return ops.act("sigmoid", x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: ``x * sigmoid(x)``."""
    return ops.act("silu", x)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (its default tanh form), constants in ``x``'s
    dtype."""
    return ops.act("gelu", x)


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``jnp.logaddexp(x, 0)``."""
    return ops.act("softplus", x)


def log_sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.log_sigmoid``: ``-softplus(-x)``."""
    return ops.act("log_sigmoid", x)


def tanh(x: torch.Tensor) -> torch.Tensor:
    """``jnp.tanh``: one primitive."""
    return ops.act("tanh", x)


def gated(name: str, up: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """``up * f(gate)`` for ``f`` named as in :data:`ACTS` (or any of the
    functions above), one rounding more for the product; up and gate of
    one shape and dtype."""
    return ops.gated(name, up, gate)


# the model configs' ``act`` names (the JAX package's ``layers.ACTS``)
ACTS = {"silu": silu, "gelu": gelu, "tanh": tanh}
