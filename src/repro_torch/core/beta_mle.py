"""Beta-density maximum-likelihood machinery behind the Flag Aggregator.

The explained variance v_i = ||Y^T g~_i||^2 in [0, 1] of worker i under a
subspace Y is modelled as Beta(alpha, beta); with the paper's Taylor
surrogate log(x) ~ a x^(1/a) - a the negative log-likelihood becomes a sum
of smooth terms, and at (alpha, beta, a) = (1, 1/2, 2) it is the Flag
Median objective sum_i sqrt(1 - v_i).  Port of ``repro/core/beta_mle.py``.
"""

from __future__ import annotations

import torch

__all__ = ["taylor_log", "beta_nll_terms", "irls_weights"]


def taylor_log(x: torch.Tensor, a: float) -> torch.Tensor:
    """The paper's smooth surrogate for ``log``:  a * x**(1/a) - a."""
    return a * torch.pow(x, 1.0 / a) - a


def beta_nll_terms(v: torch.Tensor, *, alpha: float = 1.0, beta: float = 0.5,
                   a: float = 2.0, eps: float = 1e-12) -> torch.Tensor:
    """Per-column smoothed negative log-likelihood terms (constants dropped):

        -(alpha-1) * a * v**(1/a)  -  (beta-1) * a * (1-v)**(1/a).
    """
    v = torch.clamp(v, eps, 1.0 - eps)
    t = torch.zeros_like(v)
    if alpha != 1.0:
        t = t - (alpha - 1.0) * a * torch.pow(v, 1.0 / a)
    if beta != 1.0:
        t = t - (beta - 1.0) * a * torch.pow(1.0 - v, 1.0 / a)
    return t


def irls_weights(v: torch.Tensor, coef, *, alpha: float = 1.0,
                 beta: float = 0.5, a: float = 2.0,
                 eps: float = 1e-10) -> torch.Tensor:
    """IRLS majorizer weights of the smoothed Beta NLL: the dv-slope of each
    term times its objective coefficient ``coef`` (1 for data columns,
    lambda/(p-1) for the pairwise ones).  For (1, 1/2, 2) this is
    coef / (2 sqrt(1 - v)), FlagIRLS's weight."""
    v = torch.clamp(v, 0.0, 1.0 - eps)
    w = torch.zeros_like(v)
    if beta != 1.0:
        w = w + (1.0 - beta) * torch.pow(torch.clamp(1.0 - v, eps, 1.0),
                                         1.0 / a - 1.0)
    if alpha != 1.0:
        w = w + (alpha - 1.0) * torch.pow(torch.clamp(v, eps, 1.0),
                                          1.0 / a - 1.0)
    return coef * torch.clamp(w, 0.0, 1.0 / eps)
