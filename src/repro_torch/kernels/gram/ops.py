"""Public wrappers for the Gram kernels: dispatch by the tensor's device.

A CUDA tensor goes to the Hopper kernel, which launches or raises; a CPU
tensor goes to the plain PyTorch version.  There is no fallback from one to
the other.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.gram.kernel import gram_cuda, tree_gram_cuda
from repro_torch.kernels.gram.ref import gram_plain, tree_gram_plain

GRAM_DTYPES = ("float32", "bfloat16")


def _check_gram_dtype(gram_dtype: str) -> None:
    if gram_dtype not in GRAM_DTYPES:
        raise ValueError(f"unknown gram_dtype {gram_dtype!r}; have "
                         f"{GRAM_DTYPES}")


def gram(G: torch.Tensor, *, gram_dtype: str = "float32") -> torch.Tensor:
    """K = G^T G, (p, p) fp32, for one (n, p) matrix of any strides (the
    per-leaf op of the looped tree Gram).  ``gram_dtype="bfloat16"``
    rounds an fp32 G to bf16 before the products (accumulation stays
    fp32)."""
    _check_gram_dtype(gram_dtype)
    to_bf16 = gram_dtype == "bfloat16" and G.dtype != torch.bfloat16
    if G.device.type == "cuda":
        return gram_cuda(G, round_bf16=to_bf16)
    if G.device.type == "cpu":
        return gram_plain(G.to(torch.bfloat16) if to_bf16 else G)
    raise ValueError(f"gram: no implementation for device {G.device}")


def tree_gram_fused(X: torch.Tensor, *, sketch_stride: int = 1,
                    gram_dtype: str = "float32",
                    block_n: int = 1024) -> torch.Tensor:
    """One-pass (W, W) fp32 Gram of the worker-major (W, N) stack.

    Args:
      X: worker-major gradient stack, fp32 or bf16, unit column stride.
      sketch_stride: keep every stride-th block_n-wide chunk, rescaled by
        the exact inverse sampling fraction (diagonal unbiased).
      gram_dtype: ``"bfloat16"`` rounds an fp32 stack to bf16 before the
        products (accumulation stays fp32); ``"float32"`` keeps X's dtype.
    """
    _check_gram_dtype(gram_dtype)
    to_bf16 = gram_dtype == "bfloat16" and X.dtype != torch.bfloat16
    if X.device.type == "cuda":
        return tree_gram_cuda(X, sketch_stride=sketch_stride, block_n=block_n,
                              round_bf16=to_bf16)
    if X.device.type == "cpu":
        return tree_gram_plain(X.to(torch.bfloat16) if to_bf16 else X,
                               sketch_stride, block_n)
    raise ValueError(f"tree_gram_fused: no implementation for device "
                     f"{X.device}")
