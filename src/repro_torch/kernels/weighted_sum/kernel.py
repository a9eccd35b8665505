"""Binding of the Hopper weighted-combine kernel (``csrc/weighted_sum.cu``).

The kernel replaces ``repro/kernels/weighted_sum/kernel.py::
weighted_sum_pallas``; the source's header note gives its design and bound.
``launches`` counts the calls of :func:`weighted_sum_cuda` that launched
the kernel.  The launch is the custom operator
``repro_torch::weighted_sum`` (CUDA only) with a fake implementation and a
FLOP formula (2 W N), so a trace on fake tensors (``launch.dryrun``)
reaches it.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._build import check, load_library

launches = 0
_lib = None


def _library():
    global _lib
    if _lib is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _lib = load_library("weighted_sum", {"weighted_sum_launch": (
            [vp, i32, i64, i64, i32, vp, vp, i32, vp], ctypes.c_int)})
    return _lib


def weighted_sum_cuda(X: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """d = sum_w c_w X[w, :] on the card; (N,) in X.dtype.

    X: CUDA (W, N) fp32 or bf16 with unit column stride (rows may be
    strided); c: CUDA fp32 (W,), contiguous.  Launches on the current
    stream and does not synchronise.
    """
    if X.device.type != "cuda" or c.device != X.device:
        raise ValueError(f"weighted_sum_cuda: X and c must be on one CUDA "
                         f"device, got {X.device} and {c.device}")
    if X.dim() != 2 or X.shape[0] < 1 or X.shape[1] < 1:
        raise ValueError(f"weighted_sum_cuda: X must be (W, N) with W, N >= 1,"
                         f" got {tuple(X.shape)}")
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"weighted_sum_cuda: X must be float32 or bfloat16, "
                         f"got {X.dtype}")
    if X.stride(1) != 1 or (X.shape[0] > 1 and X.stride(0) < X.shape[1]):
        raise ValueError("weighted_sum_cuda: X needs unit column stride and "
                         f"non-overlapping rows, got strides {X.stride()}")
    if c.shape != (X.shape[0],) or c.dtype != torch.float32 \
            or not c.is_contiguous():
        raise ValueError(f"weighted_sum_cuda: c must be contiguous float32 "
                         f"({X.shape[0]},), got {c.dtype} {tuple(c.shape)}")
    return weighted_sum_op(X, c)


@torch.library.custom_op("repro_torch::weighted_sum", mutates_args=(),
                         device_types="cuda")
def weighted_sum_op(X: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The launch (the checks are :func:`weighted_sum_cuda`'s)."""
    global launches
    w, n = X.shape
    out = torch.empty(n, dtype=X.dtype, device=X.device)
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    with torch.cuda.device(X.device):
        status = _library().weighted_sum_launch(
            X.data_ptr(), 0 if X.dtype == torch.float32 else 1, X.stride(0),
            n, w, c.data_ptr(), out.data_ptr(), 16 * sms,
            torch.cuda.current_stream(X.device).cuda_stream)
    check(status, "weighted_sum")
    launches += 1
    return out


@weighted_sum_op.register_fake
def _weighted_sum_fake(X, c):
    return X.new_empty((X.shape[1],))


@register_flop_formula(torch.ops.repro_torch.weighted_sum)
def _weighted_sum_flops(X_shape, c_shape, *, out_shape=None, **kw) -> int:
    return 2 * X_shape[0] * X_shape[1]
