"""The dense Flag Aggregator, its hyper-parameters and the worker-norm
helpers; port of ``repro/core/flag.py``.

``flag_subspace`` and ``flag_aggregate`` are the paper's reference form:
the (n, p) gradient matrix G is materialised, its columns normalised and
stacked with the normalised pairwise differences (the data-dependent
regularizer), and every IRLS iteration takes the top-m left singular
vectors of the weight-scaled stack (``torch.linalg.svd``).  The update is
d = (1/p) Y Y^T G~ nu', Algorithm 1's line 6 with the worker norms of
``norm_mode``.  It is the oracle of the Gram-space solver
(:mod:`repro_torch.core.gram`), off the train step's path; the loop reads
the chordal distance back to the host once an iteration to stop early, as
JAX's ``while_loop`` does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Literal

import torch

from repro_torch.core import beta_mle

__all__ = ["FlagConfig", "default_m", "flag_aggregate", "flag_subspace",
           "masked_median_1d", "effective_norms", "nan_on_nonfinite"]


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


def _pair_indices(p: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    iu = torch.triu_indices(p, p, offset=1, device=device)
    return iu[0], iu[1]


def _build_columns(G: torch.Tensor, cfg: FlagConfig, eps: float):
    """Unit-norm column stack [g~_1 .. g~_p | d~_ij ...], the objective's
    coefficient of each column, and the worker norms."""
    n, p = G.shape
    norms = torch.sqrt(torch.clamp((G * G).sum(dim=0), min=eps))
    Gt = G / norms
    if cfg.regularizer == "pairwise" and cfg.lam > 0.0 and p > 1:
        ii, jj = _pair_indices(p, G.device)
        D = Gt[:, ii] - Gt[:, jj]                       # (n, npairs)
        dn = torch.sqrt(torch.clamp((D * D).sum(dim=0), min=eps))
        cols = torch.cat([Gt, D / dn], dim=1)
        coef = torch.cat([
            torch.ones(p, dtype=G.dtype, device=G.device),
            torch.full((ii.shape[0],), cfg.lam / (p - 1), dtype=G.dtype,
                       device=G.device)])
    else:
        cols = Gt
        coef = torch.ones(p, dtype=G.dtype, device=G.device)
    return cols, coef, norms


def nan_on_nonfinite(fn, M: torch.Tensor) -> tuple:
    """``fn(M)`` (a ``torch.linalg`` decomposition) with every output NaN
    where M holds a NaN or an inf.  LAPACK's and cuSOLVER's eigen- and
    singular-value drivers report such input as a failure to converge, on
    which torch raises; ``jnp.linalg`` returns NaN, so a run of the JAX
    package whose parameters diverged goes on with NaN weights, and the
    port does the same.  Decided on the device: no host read."""
    ok = torch.isfinite(M).all()
    eye = torch.eye(*M.shape[-2:], dtype=M.dtype, device=M.device)
    poison = torch.zeros((), dtype=M.dtype, device=M.device).masked_fill(
        ~ok, math.nan)
    return tuple(o + poison for o in fn(torch.where(ok, M, eye)))


def _top_m_left_singular(Mw: torch.Tensor, m: int) -> torch.Tensor:
    """Top-m left singular vectors of Mw (n, q)."""
    U, _, _ = nan_on_nonfinite(
        lambda a: torch.linalg.svd(a, full_matrices=False), Mw)
    return U[:, :m]


def flag_subspace(G: torch.Tensor, cfg: FlagConfig = FlagConfig()):
    """Run the IRLS; return (Y, aux) with Y (n, m), Y^T Y = I.

    aux: the per-worker explained variances ``explained_variance`` (p,),
    the ``objective``, the ``iterations`` used and ``m``.
    """
    n, p = G.shape
    m = cfg.m if cfg.m is not None else default_m(p)
    if not 1 <= m <= min(n, p):
        raise ValueError(f"subspace dim m={m} must be in [1, min(n,p)="
                         f"{min(n, p)}]")
    cols, coef, _ = _build_columns(G, cfg, cfg.eps)
    kw = dict(alpha=cfg.alpha, beta=cfg.beta, a=cfg.a, eps=cfg.eps)

    def explained(Y):
        Z = Y.T @ cols                                  # (m, q)
        return torch.clamp((Z * Z).sum(dim=0), 0.0, 1.0)

    # Init: one Flag-Mean step (every IRLS weight = its coefficient).
    Y = _top_m_left_singular(cols * torch.sqrt(coef)[None, :], m)
    it = 0
    while it < cfg.n_iter:
        w = beta_mle.irls_weights(explained(Y), coef, **kw)
        Y_new = _top_m_left_singular(cols * torch.sqrt(w)[None, :], m)
        if cfg.regularizer == "l1" and cfg.lam > 0.0:
            # the norm regularizer: soft threshold, then back onto the
            # Stiefel set by QR
            tau = cfg.lam / math.sqrt(n * m)
            Ys = torch.sign(Y_new) * torch.clamp(Y_new.abs() - tau, min=0.0)
            Y_new, _ = torch.linalg.qr(Ys)
        # chordal distance^2: ||Y Y^T - Y' Y'^T||_F^2 = 2 (m - ||Y^T Y'||^2)
        c2 = 2.0 * (m - ((Y.T @ Y_new) ** 2).sum())
        Y, it = Y_new, it + 1
        if bool(c2 < cfg.tol):
            break
    v = explained(Y)
    aux = {
        "explained_variance": v[:p],
        "objective": (coef * beta_mle.beta_nll_terms(v, **kw)).sum(),
        "iterations": it,
        "m": m,
    }
    return Y, aux


def flag_aggregate(G: torch.Tensor, cfg: FlagConfig = FlagConfig()):
    """d = (1/p) Y Y^T G~ nu' (Algorithm 1) for G (n, p), one column per
    worker; returns (d (n,), aux as in :func:`flag_subspace`)."""
    _, p = G.shape
    Y, aux = flag_subspace(G, cfg)
    norms = torch.sqrt(torch.clamp((G * G).sum(dim=0), min=cfg.eps))
    g_sum = (G / norms) @ effective_norms(norms, cfg.norm_mode)
    return (Y @ (Y.T @ g_sum)) / p, aux


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
