"""Public wrappers for the coordinate-statistics and selection kernels:
dispatch by the tensor's device.

A CUDA tensor goes to the Hopper kernel, which launches or raises; a CPU
tensor goes to the plain PyTorch version.  There is no fallback from one to
the other.  Masks and row indices stay device tensors: nothing here reads
them on the host.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.coord_stats.kernel import (bulyan_select_cuda,
                                                    coord_stats_cuda,
                                                    krum_scores_cuda)
from repro_torch.kernels.coord_stats.ref import (COORD_OPS,
                                                 bulyan_select_plain,
                                                 coord_stat_plain,
                                                 krum_scores_plain)

__all__ = ["COORD_OPS", "coord_stat", "krum_scores", "bulyan_select"]


def _no_impl(who: str, device) -> ValueError:
    return ValueError(f"{who}: no implementation for device {device}")


def coord_stat(X: torch.Tensor, op: str, f: int = 1, *,
               mask: torch.Tensor | None = None,
               rows: torch.Tensor | None = None) -> torch.Tensor:
    """Coordinate-wise robust statistic over workers: (W, N) -> (N,) in
    X's dtype (computed in fp32, as the TPU kernel computes it).

    op: ``median`` | ``trimmed_mean`` | ``meamed`` | ``phocas``.  ``mask``:
    optional (R,) membership (bool or 0/1).  ``rows``: optional (R,) row
    indices; the statistic then runs over ``X[rows]`` in that order, read
    in place.
    """
    if op not in COORD_OPS:
        raise ValueError(f"unknown op {op!r}; have {COORD_OPS}")
    if X.device.type == "cuda":
        if mask is not None:
            mask = mask.to(device=X.device, dtype=torch.float32).contiguous()
        if rows is not None:
            rows = rows.to(device=X.device, dtype=torch.int32).contiguous()
        out = coord_stats_cuda(X, op, f, mask=mask, rows=rows)
    elif X.device.type == "cpu":
        out = coord_stat_plain(X, op, f, mask=mask, rows=rows)
    else:
        raise _no_impl("coord_stat", X.device)
    return out.to(X.dtype)


def krum_scores(D2: torch.Tensor, f: int = 1) -> torch.Tensor:
    """Krum score per worker from (W, W) squared distances -> (W,) fp32."""
    D2 = D2.to(torch.float32).contiguous()
    if D2.device.type == "cuda":
        return krum_scores_cuda(D2, f)
    if D2.device.type == "cpu":
        return krum_scores_plain(D2, f)
    raise _no_impl("krum_scores", D2.device)


def bulyan_select(D2: torch.Tensor, f: int = 1) -> torch.Tensor:
    """Bulyan's theta = max(W - 2f, 1) picks, lowest Krum score first;
    (theta,) int32 in selection order."""
    D2 = D2.to(torch.float32).contiguous()
    if D2.device.type == "cuda":
        return bulyan_select_cuda(D2, f)
    if D2.device.type == "cpu":
        return bulyan_select_plain(D2, f)
    raise _no_impl("bulyan_select", D2.device)
