"""Public wrapper for flash attention: dispatch by the tensor's device.

A CUDA tensor goes to the Hopper kernel, which launches or raises; a CPU
tensor goes to the plain PyTorch version.  There is no fallback from one
to the other, and no tiling arguments: the TPU kernel's ``block_q`` /
``block_k`` choose its tiles and do not change the function.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda
from repro_torch.kernels.flash_attn.ref import flash_attn_plain


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Softmax attention, queries tail-aligned to the keys.

    q: (b, H, sq, d); k/v: (b, KV, sk, d) with ``H % KV == 0`` -> (b, H, sq,
    d) in q's dtype.
    """
    if q.device.type == "cuda":
        return flash_attn_cuda(q, k, v, causal=causal, window=window,
                               scale=scale)
    if q.device.type == "cpu":
        return flash_attn_plain(q, k, v, causal=causal, window=window,
                                scale=scale)
    raise ValueError(f"flash_attention: no implementation for device "
                     f"{q.device}")
