"""Plain PyTorch version of the activation kernel: JAX's activations as
eager ops, rounded after every primitive.

XLA expands each of JAX's activations into its primitives and, at a
low-precision dtype, rounds to that dtype after every one: the CPU
program of ``jax.nn.sigmoid`` on bf16 is ``negate -> bf16 -> exp -> bf16
-> add 1 -> bf16 -> divide -> bf16``.  ``F.silu`` and its kin compute in
fp32 and round once, so at bf16 they give another value for a few
percent of the inputs (silu: 1,866 of the 65,280 finite bf16 values).
Each function here is the same primitives in the same order, written as
eager torch ops: an eager op on a bf16 tensor computes in fp32 and rounds
its result to bf16, as XLA's expanded program does between ops, on the
CPU as on the card.  The constants are rounded to the tensor's dtype
first, as XLA holds them (gelu's 0.044715 and sqrt(2/pi) are 0.0446777344
and 0.796875 in bf16).  The same functions serve fp32, whose programs
expand the same way.

The primitives, read off ``jax.jit(f).lower(x).compile().as_text()``:

* ``sigmoid(x) = 1 / (1 + exp(-x))`` (``lax.logistic``'s lowering);
* ``silu(x) = x * sigmoid(x)``;
* ``gelu(x) = x * ((tanh(c2 * (x + c1 * ((x * x) * x))) + 1) * 0.5)``,
  the tanh form ``jax.nn.gelu`` takes by default;
* ``softplus(x) = logaddexp(x, 0)``: ``x`` where it is NaN, else
  ``max(x, 0) + log1p(exp(-|x|))``;
* ``log_sigmoid(x) = -softplus(-x)``;
* ``tanh``.

The gradients are JAX's rules, op for op as ``jax.vjp`` writes them
(``jax.make_jaxpr`` of the vjp), rounded after each op too:
``lax.logistic``'s ``g * (s * (1 - s))``; ``logaddexp``'s ``g * exp(x -
softplus(x))`` (infinities replaced by 0), so ``exp(-x)`` overflowing at
a large negative input gives 0, not NaN; ``tanh``'s ``d + d * t`` with
``d = g * (1 - t)`` (torch's own ``g * (1 - t * t)`` rounds otherwise at
bf16); gelu's the transpose of its primitives' rules, ``integer_pow``'s
``3 * (x * x)`` included (torch's autograd through ``(x * x) * x``
associates otherwise).  silu differentiates through its product.

XLA's CPU programs run with denormals flushed to zero; torch keeps them,
on the CPU and on the card.  Where a subnormal enters (an input below
2^-126, an intermediate or a result that falls there: sigmoid near -88,
silu of an input below ~2.4e-38) the port's value is the IEEE one and
JAX's the flushed one; everywhere else they are the same bits.

These functions run on any device: ``models.activations`` sends a CPU
tensor here, and ``chip_smoke.py`` holds the kernel against them on the
card.
"""

from __future__ import annotations

import math
import struct
from functools import lru_cache

import numpy as np
import torch

GELU_C1 = 0.044715
GELU_C2 = math.sqrt(2.0 / math.pi)


@lru_cache(maxsize=None)
def rounded(v: float, dtype: torch.dtype) -> float:
    """``v`` rounded to ``dtype`` (to nearest, ties to even), as a Python
    float: the constant as XLA holds it.  Plain arithmetic, no tensor:
    the dry run calls this under a fake-tensor mode."""
    if dtype == torch.bfloat16:
        bits = struct.unpack("<I", struct.pack("<f", np.float32(v)))[0]
        bits = (bits + 0x7FFF + ((bits >> 16) & 1)) >> 16 << 16
        return struct.unpack("<f", struct.pack("<I", bits))[0]
    if dtype == torch.float16:
        return float(np.float16(v))
    if dtype == torch.float32:
        return float(np.float32(v))
    return float(v)


def _logistic(x: torch.Tensor) -> torch.Tensor:
    return (torch.exp(-x) + 1).reciprocal()


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # logaddexp's select of x where x is NaN is left out: clamp_min
    # propagates a NaN, so the sum is NaN there too
    return torch.clamp_min(x, 0) + torch.log1p(torch.exp(-torch.abs(x)))


def _finite_or_zero(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == math.inf, torch.zeros_like(x), x)


class _Sigmoid(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s = _logistic(x)
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        s, = ctx.saved_tensors
        return g * (s * (1 - s))


class _Softplus(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        out = _softplus(x)
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(_finite_or_zero(x) - _finite_or_zero(out))


class _Tanh(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        t = torch.tanh(x)
        ctx.save_for_backward(t)
        return t

    @staticmethod
    def backward(ctx, g):
        t, = ctx.saved_tensors
        d = g * (1 - t)
        return d + d * t


class _Gelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        c1, c2 = rounded(GELU_C1, x.dtype), rounded(GELU_C2, x.dtype)
        t = torch.tanh((x + (x * x) * x * c1) * c2)
        ctx.save_for_backward(x, t)
        return x * ((t + 1) * 0.5)

    @staticmethod
    def backward(ctx, g):
        x, t = ctx.saved_tensors
        c1, c2 = rounded(GELU_C1, x.dtype), rounded(GELU_C2, x.dtype)
        half = (x * g) * 0.5                # the cotangent of tanh + 1
        d = half * (1 - t)
        r = (d + d * t) * c2                # of the inner sum
        return (g * ((t + 1) * 0.5) + r) + (r * c1) * ((x * x) * 3)


def sigmoid_plain(x: torch.Tensor) -> torch.Tensor:
    return _Sigmoid.apply(x)


def silu_plain(x: torch.Tensor) -> torch.Tensor:
    return x * _Sigmoid.apply(x)


def gelu_plain(x: torch.Tensor) -> torch.Tensor:
    return _Gelu.apply(x)


def softplus_plain(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x)


def log_sigmoid_plain(x: torch.Tensor) -> torch.Tensor:
    return -_Softplus.apply(-x)


def tanh_plain(x: torch.Tensor) -> torch.Tensor:
    return _Tanh.apply(x)


# name -> the composition (the kernel's function numbering follows this
# order: csrc/activations.cu's Fn)
PLAIN = {"sigmoid": sigmoid_plain, "silu": silu_plain, "gelu": gelu_plain,
         "softplus": softplus_plain, "log_sigmoid": log_sigmoid_plain,
         "tanh": tanh_plain}


def gated_plain(name: str, up: torch.Tensor,
                gate: torch.Tensor) -> torch.Tensor:
    """``up * f(gate)``: the MLP's gate product, rounded once more."""
    return up * PLAIN[name](gate)
