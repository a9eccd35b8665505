"""Public wrapper for the weighted-combine kernel: dispatch by device.

A CUDA tensor goes to the Hopper kernel, which launches or raises; a CPU
tensor goes to the plain PyTorch version.  There is no fallback from one to
the other.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.weighted_sum.kernel import weighted_sum_cuda
from repro_torch.kernels.weighted_sum.ref import weighted_sum_plain


def weighted_sum(X: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """d = sum_w c_w X[w, :] for the worker-major (W, N) stack X; c is cast
    to fp32 (the combine weights keep full precision), d has X's dtype."""
    c = c.to(torch.float32).contiguous()
    if X.device.type == "cuda":
        return weighted_sum_cuda(X, c)
    if X.device.type == "cpu":
        return weighted_sum_plain(X, c)
    raise ValueError(f"weighted_sum: no implementation for device {X.device}")
