"""Binding of the activation kernel (``csrc/activations.cu``).

The kernel replaces no Pallas kernel: it is the counterpart of the loop
XLA fuses each of JAX's activations into (the source's header note gives
its design and bound).  Four custom operators (CUDA only), each with a
fake implementation, so a trace on fake tensors (``launch.dryrun``)
reaches them:

  ``repro_torch::act``             y = f(x)
  ``repro_torch::act_gated``       y = up * f(gate)
  ``repro_torch::act_grad``        dx from g and what f's backward reads
  ``repro_torch::act_gated_grad``  (d_up, d_gate) from g, up and gate

``f`` is one of :data:`NAMES`; fp32 or bf16.  ``launches`` counts, per
operator, the calls that launched the kernel.

Inputs need not be contiguous: each is read as (rows, cols) with unit
stride along ``cols`` and a row stride of its own (:func:`rows_view`),
which covers the sLSTM's ``g[:, k]`` and the RG-LRU's ``.chunk`` views
without a copy; an input that is no such view (a transposed or expanded
tensor) is copied to a contiguous one first, one extra pass over it.
Outputs are contiguous.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels._build import check, load_library
from repro_torch.kernels.activations.ref import (GELU_C1, GELU_C2, PLAIN,
                                                 rounded)

NAMES = tuple(PLAIN)                 # index = csrc/activations.cu's Fn
_FN = {n: i for i, n in enumerate(NAMES)}
_FORWARD, _GATED, _BACKWARD, _GATED_BACKWARD = range(4)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# what each backward reads besides g: the input x, the output y
SAVES = {"sigmoid": (False, True), "silu": (True, False),
         "gelu": (True, False), "softplus": (True, True),
         "log_sigmoid": (True, True), "tanh": (False, True)}
launches = {"act": 0, "act_gated": 0, "act_grad": 0, "act_gated_grad": 0}
_launch = None


def _library():
    global _launch
    if _launch is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _launch = load_library("activations", {"act_launch": (
            [i32, i32, i32, vp, vp, vp, vp, vp, i64, i64, i64, i64, i64,
             ctypes.c_float, ctypes.c_float, i32, vp],
            ctypes.c_int)}).act_launch
    return _launch


def rows_view(t: torch.Tensor) -> tuple[int, int, int] | None:
    """``(rows, cols, row_stride)`` under which ``t`` is a stack of rows,
    each ``cols`` elements at unit stride, ``row_stride`` elements apart;
    ``cols`` the longest contiguous tail.  None if ``t`` is no such
    view."""
    dims = [(n, s) for n, s in zip(t.shape, t.stride()) if n != 1]
    cols, k = 1, len(dims)
    while k and dims[k - 1][1] == cols:
        cols *= dims[k - 1][0]
        k -= 1
    if k == 0:
        return 1, cols, cols
    rows, stride = dims[k - 1]
    for n, s in reversed(dims[:k - 1]):
        if s != stride * rows:
            return None
        rows *= n
    return rows, cols, stride


def _layout(ins, n: int):
    """(rows, cols, row strides, inputs) for the launch: the first strided
    input's rows (one row if all are contiguous); an input that is no view
    of those rows, copied (the copies are returned, to live past the
    launch)."""
    strided = [t for t in ins if t is not None and not t.is_contiguous()]
    if not strided:
        return 1, n, [0 if t is None else n for t in ins], ins
    shape = next((v for v in map(rows_view, strided) if v is not None),
                 (1, n))
    rows, cols = shape[0], shape[1]
    strides, kept = [], []
    for t in ins:
        v = None if t is None else (rows, cols, cols) if t.is_contiguous() \
            else rows_view(t)
        if t is not None and (v is None or v[:2] != (rows, cols)):
            t, v = t.contiguous(), (rows, cols, cols)
        strides.append(0 if t is None else v[2])
        kept.append(t)
    return rows, cols, strides, kept


def _run(op: str, name: str, form: int, ins, outs) -> None:
    """Launch ``form`` of ``name`` on inputs ``ins`` (3, None where
    unread) of one shape, writing the contiguous ``outs`` (2, the second
    None but for the gated backward)."""
    ref = outs[0]
    n = ref.numel()
    if n == 0:
        return
    rows, cols, strides, ins = _layout(ins, n)
    a, b, c = (None if t is None else t.data_ptr() for t in ins)
    o0, o1 = (None if o is None else o.data_ptr() for o in outs)
    dt = ref.dtype
    per = 16 // ref.element_size()
    vec = 1
    if cols % per or strides[0] % per or strides[1] % per or \
            strides[2] % per:
        vec = 0
    for p in (a, b, c, o0, o1):
        if p is not None and p % 16:
            vec = 0
    c1, c2 = (rounded(GELU_C1, dt), rounded(GELU_C2, dt)) \
        if name == "gelu" else (0.0, 0.0)
    dev = ref.device.index
    args = (_FN[name], form, _DTYPES[dt], a, b, c, o0, o1, rows, cols,
            *strides, c1, c2, vec, torch._C._cuda_getCurrentRawStream(dev))
    if dev == torch._C._cuda_getDevice():
        status = _library()(*args)
    else:
        with torch.cuda.device(dev):
            status = _library()(*args)
    if status:
        check(status, f"activations[{op}, {name}]")
    launches[op] += 1


def _check(name: str, t0: torch.Tensor, *ts: torch.Tensor) -> None:
    """Raise on what the kernel does not take."""
    if name not in _FN:
        raise ValueError(f"activations: no function {name!r}; have {NAMES}")
    if not t0.is_cuda or t0.dtype not in _DTYPES:
        raise ValueError(f"activations[{name}]: a CUDA tensor of float32 or "
                         f"bfloat16, got {t0.dtype} on {t0.device}")
    for t in ts:
        if t.device != t0.device or t.dtype != t0.dtype or \
                t.shape != t0.shape:
            got = [(str(u.device), u.dtype, tuple(u.shape))
                   for u in (t0, *ts)]
            raise ValueError(f"activations[{name}]: tensors must share "
                             f"device, dtype and shape, got {got}")


# The launches.  ``ops.py`` calls these directly on real tensors (an eager
# call through the operator costs tens of host microseconds, and decode is
# host-bound) and through the operators below under a trace (a dispatch
# mode or fake tensors), where the operator is what the trace records.

def act(x: torch.Tensor, name: str) -> torch.Tensor:
    """y = f(x)."""
    _check(name, x)
    out = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    _run("act", name, _FORWARD, (x, None, None), (out, None))
    return out


def act_gated(up: torch.Tensor, gate: torch.Tensor,
              name: str) -> torch.Tensor:
    """y = up * f(gate)."""
    _check(name, up, gate)
    out = torch.empty(up.shape, dtype=up.dtype, device=up.device)
    _run("act_gated", name, _GATED, (up, gate, None), (out, None))
    return out


def act_grad(g: torch.Tensor, x: Optional[torch.Tensor],
             y: Optional[torch.Tensor], name: str) -> torch.Tensor:
    """The cotangent of f's input; ``x`` / ``y`` (input / output of the
    forward) as :data:`SAVES` names them, None where unread."""
    need_x, need_y = SAVES[name]
    if (x is None) == need_x or (y is None) == need_y:
        raise ValueError(f"activations[{name}]: the backward reads "
                         f"{'x ' if need_x else ''}{'y' if need_y else ''}")
    _check(name, g, *[t for t in (x, y) if t is not None])
    out = torch.empty(g.shape, dtype=g.dtype, device=g.device)
    _run("act_grad", name, _BACKWARD, (g, x, y), (out, None))
    return out


def act_gated_grad(g: torch.Tensor, up: torch.Tensor, gate: torch.Tensor,
                   name: str) -> tuple[torch.Tensor, torch.Tensor]:
    """(d_up, d_gate) of y = up * f(gate)."""
    _check(name, g, up, gate)
    d_up = torch.empty(g.shape, dtype=g.dtype, device=g.device)
    d_gate = torch.empty(g.shape, dtype=g.dtype, device=g.device)
    _run("act_gated_grad", name, _GATED_BACKWARD, (g, up, gate),
         (d_up, d_gate))
    return d_up, d_gate


act_op = torch.library.custom_op(
    "repro_torch::act", act, mutates_args=(), device_types="cuda")
act_gated_op = torch.library.custom_op(
    "repro_torch::act_gated", act_gated, mutates_args=(),
    device_types="cuda")
act_grad_op = torch.library.custom_op(
    "repro_torch::act_grad", act_grad, mutates_args=(), device_types="cuda")
act_gated_grad_op = torch.library.custom_op(
    "repro_torch::act_gated_grad", act_gated_grad, mutates_args=(),
    device_types="cuda")


@act_op.register_fake
def _act_fake(x, name):
    return x.new_empty(x.shape)


@act_gated_op.register_fake
def _act_gated_fake(up, gate, name):
    return up.new_empty(up.shape)


@act_grad_op.register_fake
def _act_grad_fake(g, x, y, name):
    return g.new_empty(g.shape)


@act_gated_grad_op.register_fake
def _act_gated_grad_fake(g, up, gate, name):
    return g.new_empty(g.shape), g.new_empty(g.shape)
