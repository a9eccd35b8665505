"""Flag Aggregator hyper-parameters and the worker-norm helpers the
Gram-space solver needs.  Port of the matching parts of
``repro/core/flag.py``; the dense reference (``flag_subspace``,
``flag_aggregate``) comes with a later slice.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Literal

import torch

__all__ = ["FlagConfig", "default_m", "masked_median_1d", "effective_norms"]


@dataclass(frozen=True)
class FlagConfig:
    """Hyper-parameters of the Flag Aggregator (defaults as the JAX
    package's: m = ceil((p+1)/2), 5 IRLS iterations, tol 1e-10, Beta(1, 1/2)
    with Taylor constant a = 2, i.e. sqrt losses).

    ``norm_mode``: worker norms in the final combine -- ``'raw'`` is
    Algorithm 1, ``'clip'`` caps each norm at the median worker norm,
    ``'unit'`` uses the median norm for all.  ``renormalize`` (FA-N) scales
    the combine weights to sum to 1.
    """

    m: int | None = None
    lam: float = 1.0
    regularizer: Literal["pairwise", "l1", "none"] = "pairwise"
    n_iter: int = 5
    tol: float = 1e-10
    eps: float = 1e-6
    alpha: float = 1.0
    beta: float = 0.5
    a: float = 2.0
    norm_mode: Literal["raw", "clip", "unit"] = "clip"
    renormalize: bool = False


def default_m(p: int) -> int:
    """The paper's subspace dimension: m = ceil((p+1)/2)."""
    return int(math.ceil((p + 1) / 2))


def masked_median_1d(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Median of ``x[mask]`` (mean of the two middle values for an even
    count) with the active count read on the device, never on the host."""
    s = torch.sort(torch.where(mask.bool(), x,
                               torch.full_like(x, math.inf))).values
    na = torch.clamp(mask.to(torch.int64).sum(), min=1)
    return 0.5 * (s[(na - 1) // 2] + s[na // 2])


def effective_norms(norms: torch.Tensor, mode: str,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Worker norms used in the final combine (see FlagConfig.norm_mode);
    with ``mask`` the median covers active workers and inactive entries
    are zeroed."""
    if mode not in ("raw", "clip", "unit"):
        raise ValueError(f"unknown norm_mode {mode!r}")
    if mode == "raw":
        out = norms
    else:
        m = torch.ones_like(norms) if mask is None else mask
        med = masked_median_1d(norms, m)
        out = torch.minimum(norms, med) if mode == "clip" \
            else med.expand_as(norms)
    return out if mask is None else out * mask.to(norms.dtype)
