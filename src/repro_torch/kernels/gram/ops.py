"""Public wrapper for the tree-Gram kernel: dispatch by the tensor's device.

A CUDA tensor goes to the Hopper kernel, which launches or raises; a CPU
tensor goes to the plain PyTorch version.  There is no fallback from one to
the other.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.gram.kernel import tree_gram_cuda
from repro_torch.kernels.gram.ref import tree_gram_plain

GRAM_DTYPES = ("float32", "bfloat16")


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
    if gram_dtype not in GRAM_DTYPES:
        raise ValueError(f"unknown gram_dtype {gram_dtype!r}; have "
                         f"{GRAM_DTYPES}")
    to_bf16 = gram_dtype == "bfloat16" and X.dtype != torch.bfloat16
    if X.device.type == "cuda":
        return tree_gram_cuda(X, sketch_stride=sketch_stride, block_n=block_n,
                              round_bf16=to_bf16)
    if X.device.type == "cpu":
        return tree_gram_plain(X.to(torch.bfloat16) if to_bf16 else X,
                               sketch_stride, block_n)
    raise ValueError(f"tree_gram_fused: no implementation for device "
                     f"{X.device}")
