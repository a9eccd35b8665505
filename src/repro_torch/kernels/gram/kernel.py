"""Binding of the Hopper tree-Gram kernel (``csrc/tree_gram.cu``).

The kernel replaces ``repro/kernels/gram/kernel.py::tree_gram_pallas``; the
source's header note gives its design and bound.  ``launches`` counts the
calls of :func:`tree_gram_cuda` that launched the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import check, load_library
from repro_torch.kernels.gram.ref import chunk_schedule

launches = 0
MAX_SPLITS = 1024       # split-K partials; fixed, so results do not depend
                        # on the card's SM count
_lib = None


def _library():
    global _lib
    if _lib is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _lib = load_library("tree_gram", {"tree_gram_launch": (
            [vp, i32, i32, i64, i64, i32, i32, i32, i64, i32, ctypes.c_float,
             vp, vp, vp], ctypes.c_int)})
    return _lib


def tree_gram_cuda(X: torch.Tensor, *, sketch_stride: int = 1,
                   block_n: int = 1024, round_bf16: bool = False
                   ) -> torch.Tensor:
    """K = scale * X_S X_S^T on the card; (W, W) fp32.

    X: CUDA (W, N) fp32 or bf16 with unit column stride (rows may be
    strided).  ``round_bf16`` (fp32 X only) rounds every element to bf16
    before the product, which is ``gram_dtype="bfloat16"``.  Launches on
    the current stream and does not synchronise.
    """
    global launches
    if X.device.type != "cuda":
        raise ValueError(f"tree_gram_cuda: X must be on a CUDA device, got "
                         f"{X.device}")
    if X.dim() != 2 or X.shape[0] < 1 or X.shape[1] < 1:
        raise ValueError(f"tree_gram_cuda: X must be (W, N) with W, N >= 1, "
                         f"got {tuple(X.shape)}")
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"tree_gram_cuda: X must be float32 or bfloat16, got "
                         f"{X.dtype}")
    if X.stride(1) != 1 or (X.shape[0] > 1 and X.stride(0) < X.shape[1]):
        raise ValueError("tree_gram_cuda: X needs unit column stride and "
                         f"non-overlapping rows, got strides {X.stride()}")
    if round_bf16 and X.dtype != torch.float32:
        raise ValueError("tree_gram_cuda: round_bf16 applies to fp32 X only")
    if block_n < 1:
        raise ValueError(f"tree_gram_cuda: block_n must be >= 1, got {block_n}")
    w, n = X.shape
    stride = max(1, sketch_stride)
    kept, _, scale = chunk_schedule(n, block_n, stride)
    splits = min(kept, MAX_SPLITS)
    partial = torch.empty((splits, w, w), dtype=torch.float32,
                          device=X.device)
    K = torch.empty((w, w), dtype=torch.float32, device=X.device)
    with torch.cuda.device(X.device):
        status = _library().tree_gram_launch(
            X.data_ptr(), 0 if X.dtype == torch.float32 else 1,
            int(round_bf16), X.stride(0), n, w, kept, block_n,
            stride * block_n, splits, scale, partial.data_ptr(),
            K.data_ptr(), torch.cuda.current_stream(X.device).cuda_stream)
    check(status, "tree_gram")
    launches += 1
    return K
