"""Bindings of the Hopper Gram kernels, two entries of ``csrc/gram.cu``.

* ``tree_gram_launch`` (:func:`tree_gram_cuda`) replaces
  ``repro/kernels/gram/kernel.py::tree_gram_pallas``: the one-pass Gram of
  the worker-major (W, N) buffer; ``launches`` counts its calls that
  launched the kernel.
* ``gram_launch`` (:func:`gram_cuda`) replaces ``gram_pallas``: K = G^T G
  for one strided (n, p) matrix, the looped tree Gram's per-leaf kernel;
  ``gram_launches`` counts its calls that launched the kernel.

Both run one device body; the source's header note gives its design and
bound.  Each launch is a custom operator (``repro_torch::tree_gram``,
``repro_torch::gram``; CUDA only) with a fake implementation (the
output's shape and dtype) and a FLOP formula (2 per worker pair and
coordinate), so a trace on fake tensors (``launch.dryrun``) reaches it.
"""

from __future__ import annotations

import ctypes

import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._build import check, load_library
from repro_torch.kernels.gram.ref import chunk_schedule

launches = 0
gram_launches = 0
MAX_SPLITS = 1024       # split-K partials; fixed, so results do not depend
                        # on the card's SM count
MAX_ROWS = 4096         # rows of K: the off-diagonal items of 16-row tiles
                        # fill gridDim.y <= 65535 up to 256 tiles
GRAM_BLOCK_N = 1024     # coordinates of one chunk of gram_cuda's split-K
GRAM_SCRATCH = 2 ** 26  # fp32 entries of gram_cuda's partials at most
_lib = None


def _library():
    global _lib
    if _lib is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _lib = load_library("gram", {
            "tree_gram_launch": ([vp, i32, i32, i64, i64, i32, i32, i32, i64,
                                  i32, ctypes.c_float, vp, vp, vp],
                                 ctypes.c_int),
            "gram_launch": ([vp, i32, i32, i64, i64, i64, i32, i32, i32, i32,
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
    if X.device.type != "cuda":
        raise ValueError(f"tree_gram_cuda: X must be on a CUDA device, got "
                         f"{X.device}")
    if X.dim() != 2 or not 1 <= X.shape[0] <= MAX_ROWS or X.shape[1] < 1:
        raise ValueError(f"tree_gram_cuda: X must be (W, N) with "
                         f"1 <= W <= {MAX_ROWS} and N >= 1, got "
                         f"{tuple(X.shape)}")
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
    return tree_gram_op(X, max(1, sketch_stride), block_n, bool(round_bf16))


@torch.library.custom_op("repro_torch::tree_gram", mutates_args=(),
                         device_types="cuda")
def tree_gram_op(X: torch.Tensor, stride: int, block_n: int,
                 round_bf16: bool) -> torch.Tensor:
    """The launch (the checks are :func:`tree_gram_cuda`'s)."""
    global launches
    w, n = X.shape
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


@tree_gram_op.register_fake
def _tree_gram_fake(X, stride, block_n, round_bf16):
    return X.new_empty((X.shape[0], X.shape[0]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.tree_gram)
def _tree_gram_flops(X_shape, stride, block_n, round_bf16, *,
                     out_shape=None, **kw) -> int:
    w, n = X_shape
    kept = chunk_schedule(n, block_n, stride)[0]
    return 2 * w * w * min(n, kept * block_n)


def gram_cuda(G: torch.Tensor, *, round_bf16: bool = False) -> torch.Tensor:
    """K = G^T G on the card; (p, p) fp32.

    G: CUDA (n, p) fp32 or bf16 with any non-negative strides, read in
    place (a transposed, strided view of the (W, N) buffer needs no copy).
    ``round_bf16`` (fp32 G only) rounds every element to bf16 before the
    product, which is ``gram_dtype="bfloat16"``.  Launches on the current
    stream and does not synchronise.
    """
    if G.device.type != "cuda":
        raise ValueError(f"gram_cuda: G must be on a CUDA device, got "
                         f"{G.device}")
    if G.dim() != 2 or G.shape[0] < 1 or not 1 <= G.shape[1] <= MAX_ROWS:
        raise ValueError(f"gram_cuda: G must be (n, p) with n >= 1 and "
                         f"1 <= p <= {MAX_ROWS}, got {tuple(G.shape)}")
    if G.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"gram_cuda: G must be float32 or bfloat16, got "
                         f"{G.dtype}")
    if min(G.stride()) < 0:
        raise ValueError(f"gram_cuda: negative strides {G.stride()}")
    if round_bf16 and G.dtype != torch.float32:
        raise ValueError("gram_cuda: round_bf16 applies to fp32 G only")
    return gram_op(G, bool(round_bf16))


@torch.library.custom_op("repro_torch::gram", mutates_args=(),
                         device_types="cuda")
def gram_op(G: torch.Tensor, round_bf16: bool) -> torch.Tensor:
    """The launch (the checks are :func:`gram_cuda`'s)."""
    global gram_launches
    n, p = G.shape
    chunks = -(-n // GRAM_BLOCK_N)
    # Depends on (n, p) only, so K does not depend on the card.
    splits = max(1, min(chunks, MAX_SPLITS, GRAM_SCRATCH // (p * p)))
    partial = torch.empty((splits, p, p), dtype=torch.float32,
                          device=G.device)
    K = torch.empty((p, p), dtype=torch.float32, device=G.device)
    with torch.cuda.device(G.device):
        status = _library().gram_launch(
            G.data_ptr(), 0 if G.dtype == torch.float32 else 1,
            int(round_bf16), G.stride(0), G.stride(1), n, p, chunks,
            GRAM_BLOCK_N, splits, partial.data_ptr(), K.data_ptr(),
            torch.cuda.current_stream(G.device).cuda_stream)
    check(status, "gram")
    gram_launches += 1
    return K


@gram_op.register_fake
def _gram_fake(G, round_bf16):
    return G.new_empty((G.shape[1], G.shape[1]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.gram)
def _gram_flops(G_shape, round_bf16, *, out_shape=None, **kw) -> int:
    n, p = G_shape
    return 2 * n * p * p
