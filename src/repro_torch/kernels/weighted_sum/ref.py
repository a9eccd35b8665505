"""Plain PyTorch version of the weighted-combine kernel."""

from __future__ import annotations

import torch


def weighted_sum_plain(X: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """d = sum_w c_w X[w, :], accumulated in fp32 in the order w = 0..W-1.

    X: worker-major (W, N), fp32 or bf16; c: (W,).  Returns (N,) in
    X.dtype.  (The JAX kernel reads the transposed (n, p) layout; this
    reads X as it lies.)
    """
    cf = c.float()
    acc = torch.zeros(X.shape[1], dtype=torch.float32, device=X.device)
    for w in range(X.shape[0]):
        acc = acc + cf[w] * X[w].float()
    return acc.to(X.dtype)
