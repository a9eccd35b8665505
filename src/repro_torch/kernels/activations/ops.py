"""Public wrappers for the activation kernel: dispatch by device.

A CUDA tensor goes to the Hopper kernel, through an autograd Function
whose backward is the kernel too; a CPU tensor goes to the plain
composition (``ref.py``) and its autograd Functions.  There is no
fallback from one to the other.

Host time: decode is host-bound, so an eager call on real tensors
launches through the plain Python function (``kernel.act`` and its
kin), and a forward that records no gradient skips the autograd
Function.  Under a trace (a ``TorchDispatchMode`` such as the fake
tensor mode of ``launch.dryrun`` or ``analysis.capture``, or on fake
tensors) the call goes through the custom operator, which the trace
records; both launch the same kernel.
"""

from __future__ import annotations

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.autograd.function import once_differentiable

from repro_torch.kernels.activations import kernel as K
from repro_torch.kernels.activations.ref import PLAIN, gated_plain


def _traced(t: torch.Tensor) -> bool:
    return torch._C._len_torch_dispatch_stack() > 0 or isinstance(
        t, FakeTensor)


def _act(x, name):
    return (K.act_op if _traced(x) else K.act)(x, name)


def _gated(up, gate, name):
    return (K.act_gated_op if _traced(up) else K.act_gated)(up, gate, name)


class _Act(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, name):
        y = _act(x, name)
        need_x, need_y = K.SAVES[name]
        ctx.name = name
        ctx.save_for_backward(x if need_x else None, y if need_y else None)
        return y

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        fn = K.act_grad_op if _traced(g) else K.act_grad
        return fn(g, x, y, ctx.name), None


class _Gated(torch.autograd.Function):
    @staticmethod
    def forward(ctx, up, gate, name):
        ctx.name = name
        ctx.save_for_backward(up, gate)
        return _gated(up, gate, name)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        up, gate = ctx.saved_tensors
        fn = K.act_gated_grad_op if _traced(g) else K.act_gated_grad
        d_up, d_gate = fn(g, up, gate, ctx.name)
        return d_up, d_gate, None


def _records_grad(*ts: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def act(name: str, x: torch.Tensor) -> torch.Tensor:
    """``f(x)`` for ``f`` in ``ref.PLAIN``, rounded as JAX's program
    rounds; x's dtype."""
    if x.device.type == "cuda":
        return _Act.apply(x, name) if _records_grad(x) else _act(x, name)
    if x.device.type == "cpu":
        return PLAIN[name](x)
    raise ValueError(f"activations: no implementation for device "
                     f"{x.device}")


def gated(name: str, up: torch.Tensor, gate: torch.Tensor) -> torch.Tensor:
    """``up * f(gate)``, up and gate of one shape and dtype."""
    if up.shape != gate.shape or up.dtype != gate.dtype:
        raise ValueError(f"activations.gated: up {up.dtype} "
                         f"{tuple(up.shape)} and gate {gate.dtype} "
                         f"{tuple(gate.shape)} differ")
    if up.device.type == "cuda":
        if _records_grad(up, gate):
            return _Gated.apply(up, gate, name)
        return _gated(up, gate, name)
    if up.device.type == "cpu":
        return gated_plain(name, up, gate)
    raise ValueError(f"activations: no implementation for device "
                     f"{up.device}")
