"""Baseline Byzantine-resilient aggregators the paper compares against.

Port of ``repro/core/aggregators.py``: every rule takes the worker-major
(p, n) gradient matrix and returns the aggregated (n,) gradient, as plain
PyTorch on any device.  These are the flat references; the train step's
path (:mod:`repro_torch.dist.aggregation`) reads the (W, N) buffer in place
through the kernels of :mod:`repro_torch.kernels.coord_stats` instead.

The coordinate-wise statistics and the Krum / Bulyan selections come from
``kernels/coord_stats/ref.py`` (one source for the kernels' plain versions
and the rules).  The masked selections (``masked_krum_scores``,
``masked_selection_weights``, ``masked_bulyan_select``) have no kernel in
the JAX package and stay plain on both devices; the active count is a
device tensor, never read on the host.

Tie rules, as JAX's: ``jax.lax.top_k`` and ``jnp.argsort`` keep the lower
index on ties, so Multi-Krum's pick is a stable argsort (``torch.topk``
promises no order); ``torch.argmin`` returns the first minimum, as
``jnp.argmin`` does.
"""

from __future__ import annotations

from typing import Callable

import torch

from repro_torch.core.flag import FlagConfig
from repro_torch.core.gram import fa_weights_from_gram, gram_matrix
from repro_torch.kernels.coord_stats.ref import (
    bulyan_select_plain as bulyan_select,
    coord_stat_plain,
    krum_scores_plain as krum_scores,
    mean_nearest,
)

__all__ = [
    "mean", "median", "trimmed_mean", "meamed", "phocas", "krum",
    "multi_krum", "bulyan", "pca_topm", "geometric_median", "flag",
    "get_aggregator", "AGGREGATORS", "pairwise_sq_dists", "krum_scores",
    "bulyan_select", "sq_dists_from_gram",
    "masked_median", "masked_trimmed_mean", "masked_mean_around",
    "masked_krum_scores", "masked_selection_weights", "masked_bulyan_select",
    "MASKED_COORDWISE",
]


# ---------------------------------------------------------------------------
# coordinate-wise rules
# ---------------------------------------------------------------------------

def mean(Gw: torch.Tensor, **_) -> torch.Tensor:
    """Non-robust baseline (paper Fig. 2)."""
    return Gw.mean(dim=0)


def _stat(Gw: torch.Tensor, op: str, f: int = 1,
          mask: torch.Tensor | None = None) -> torch.Tensor:
    return coord_stat_plain(Gw, op, f, mask=mask).to(Gw.dtype)


def median(Gw: torch.Tensor, **_) -> torch.Tensor:
    """Coordinate-wise median [Yin et al. 2018]."""
    return _stat(Gw, "median")


def trimmed_mean(Gw: torch.Tensor, *, f: int = 1, **_) -> torch.Tensor:
    """Coordinate-wise trimmed mean: drop f largest + f smallest per coord."""
    return _stat(Gw, "trimmed_mean", f)


def meamed(Gw: torch.Tensor, *, f: int = 1, **_) -> torch.Tensor:
    """Mean-around-median [Xie et al. 2018]: mean of p-f closest to median."""
    return _stat(Gw, "meamed", f)


def phocas(Gw: torch.Tensor, *, f: int = 1, **_) -> torch.Tensor:
    """Phocas [Xie et al. 2018]: mean of p-f closest to the trimmed mean."""
    return _stat(Gw, "phocas", f)


# ---------------------------------------------------------------------------
# distance-based rules (Gram-computable)
# ---------------------------------------------------------------------------

def sq_dists_from_gram(K: torch.Tensor) -> torch.Tensor:
    """(p, p) squared pairwise distances from a Gram matrix K = G G^T."""
    dg = torch.diagonal(K)
    return torch.clamp(dg[:, None] + dg[None, :] - 2.0 * K, min=0.0)


def pairwise_sq_dists(Gw: torch.Tensor) -> torch.Tensor:
    """(p, p) squared distances from the Gram matrix (one O(n p^2) pass)."""
    return sq_dists_from_gram(gram_matrix(Gw.T))


def krum(Gw: torch.Tensor, *, f: int = 1, **_) -> torch.Tensor:
    """Krum [Blanchard et al. 2017]: the single lowest-score gradient."""
    s = krum_scores(pairwise_sq_dists(Gw), f)
    return Gw[torch.argmin(s)]


def multi_krum(Gw: torch.Tensor, *, f: int = 1, q: int | None = None,
               **_) -> torch.Tensor:
    """Multi-Krum: average the q = p - f - 2 lowest-score gradients."""
    p = Gw.shape[0]
    q = q if q is not None else max(p - f - 2, 1)
    s = krum_scores(pairwise_sq_dists(Gw), f)
    return Gw[torch.argsort(s, stable=True)[:q]].mean(dim=0)


def bulyan(Gw: torch.Tensor, *, f: int = 1, **_) -> torch.Tensor:
    """Bulyan [El Mhamdi et al. 2018]: recursive Multi-Krum selection of
    theta = p - 2f gradients, then per-coordinate mean of the beta =
    theta - 2f values closest to the median (MeaMed with f' = 2f)."""
    S = Gw[bulyan_select(pairwise_sq_dists(Gw), f).long()]
    return _stat(S, "meamed", 2 * f)


# ---------------------------------------------------------------------------
# masked (dynamic worker subset) variants
# ---------------------------------------------------------------------------

def _masked_count(mask: torch.Tensor) -> torch.Tensor:
    """Active-worker count as a device int64 (at least 1)."""
    return torch.clamp((mask != 0).sum(), min=1)


def masked_median(Gw: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-coordinate median over the active rows of Gw (W, n)."""
    return _stat(Gw, "median", mask=mask)


def masked_trimmed_mean(Gw: torch.Tensor, mask: torch.Tensor, *,
                        f: int = 1) -> torch.Tensor:
    """Per-coordinate trimmed mean over the active rows (f capped at
    (W_a - 1) // 2, as unmasked)."""
    return _stat(Gw, "trimmed_mean", f, mask)


def masked_mean_around(Gw: torch.Tensor, center: torch.Tensor, k,
                       mask: torch.Tensor) -> torch.Tensor:
    """Mean of the ``k`` active values nearest ``center``, per coordinate
    (``k`` may be a device count; inactive rows are infinitely far)."""
    if not isinstance(k, int):
        k = torch.clamp(torch.as_tensor(k, device=Gw.device), min=1)
    return mean_nearest(Gw.float(), center.float(), k,
                        mask.to(Gw.device) != 0).to(Gw.dtype)


MASKED_COORDWISE: dict[str, Callable] = {
    "median": lambda Gw, mask, *, f=1: masked_median(Gw, mask),
    "trimmed_mean": masked_trimmed_mean,
    "meamed": lambda Gw, mask, *, f=1: _stat(Gw, "meamed", f, mask),
    "phocas": lambda Gw, mask, *, f=1: _stat(Gw, "phocas", f, mask),
}


def _prefix_sums(S: torch.Tensor, kk: torch.Tensor) -> torch.Tensor:
    """Per row, the sum of its first kk entries (kk a device count)."""
    cols = torch.arange(S.shape[1], device=S.device)[None, :]
    return torch.where(cols < kk, S, 0.0).sum(dim=1)


def masked_krum_scores(D2: torch.Tensor, f: int,
                       mask: torch.Tensor) -> torch.Tensor:
    """Krum scores over the active subset: each active worker sums its
    W_a - f - 2 smallest squared distances to the other active workers;
    inactive workers score +inf."""
    W = D2.shape[0]
    mb = mask != 0
    wa = _masked_count(mask)
    eye = torch.eye(W, dtype=torch.bool, device=D2.device)
    valid = mb[:, None] & mb[None, :] & ~eye
    S = torch.sort(torch.where(valid, D2, float("inf")), dim=1).values
    kk = torch.minimum(torch.clamp(wa - f - 2, min=1),
                       torch.clamp(wa - 1, min=1))
    return _prefix_sums(S, kk)


def masked_selection_weights(D2: torch.Tensor, name: str, f: int,
                             mask: torch.Tensor) -> torch.Tensor:
    """Krum / Multi-Krum combination weights over the active subset.

    A lone active worker scores +inf (no active peers), so active scores
    are made finite before the argmin / rank: the pick never lands on an
    inactive worker, and an all-inactive mask gives the zero vector.
    """
    W = D2.shape[0]
    mb = mask != 0
    mf = mask.to(D2.dtype)
    s = masked_krum_scores(D2, f, mask)
    s = torch.where(mb, torch.where(torch.isfinite(s), s, 0.0),
                    float("inf"))
    if name == "krum":
        hot = torch.nn.functional.one_hot(torch.argmin(s), W)
        return hot.to(D2.dtype) * mf
    wa = _masked_count(mask)
    q = torch.minimum(torch.clamp(wa - f - 2, min=1), wa)
    rank = torch.argsort(torch.argsort(s, stable=True), stable=True)
    return (torch.where(rank < q, 1.0 / q, 0.0) * mf).to(D2.dtype)


def masked_bulyan_select(D2_all: torch.Tensor, f: int, mask: torch.Tensor):
    """Bulyan's recursive selection over the active subset.

    Selected workers keep contributing the finite ``big`` to every row's
    sum (the same count per row); inactive workers are left out (+inf,
    never summed).  Runs W rounds; rounds past theta = W_a - 2f take
    nothing.

    Returns:
      ``(selected, theta)``: a (W,) bool mask of the chosen workers and the
      selection count, both device tensors.
    """
    W = D2_all.shape[0]
    dev = D2_all.device
    mb = mask != 0
    wa = _masked_count(mask)
    theta = torch.minimum(torch.clamp(wa - 2 * f, min=1), wa)
    kk = torch.minimum(torch.clamp(wa - f - 2, min=1),
                       torch.clamp(wa - 1, min=1))
    eye = torch.eye(W, dtype=torch.bool, device=dev)
    ids = torch.arange(W, device=dev)
    active_pairs = mb[:, None] & mb[None, :] & ~eye
    big = 4.0 * torch.where(active_pairs, D2_all, 0.0).max() + 1.0
    avail, selected = mb.clone(), torch.zeros(W, dtype=torch.bool, device=dev)
    for r in range(W):
        valid = avail[:, None] & avail[None, :] & ~eye
        D = torch.where(active_pairs, torch.where(valid, D2_all, big),
                        float("inf"))
        s = _prefix_sums(torch.sort(D, dim=1).values, kk)
        s = torch.where(avail, torch.where(torch.isfinite(s), s, 0.0),
                        float("inf"))
        pick = torch.argmin(s)
        take = (r < theta) & avail.gather(0, pick.reshape(1))[0]
        hit = (ids == pick) & take
        avail = avail & ~hit
        selected = selected | hit
    return selected, theta


# ---------------------------------------------------------------------------
# subspace rules
# ---------------------------------------------------------------------------

def pca_topm(Gw: torch.Tensor, *, m: int | None = None, **_) -> torch.Tensor:
    """Appendix E.2 baseline: one unweighted FA step == PCA reconstruction."""
    cfg = FlagConfig(m=m, lam=0.0, regularizer="none", n_iter=1)
    c, _ = fa_weights_from_gram(gram_matrix(Gw.T), cfg)
    return Gw.T @ c.to(Gw.dtype)


def flag(Gw: torch.Tensor, *, cfg: FlagConfig = FlagConfig(),
         **_) -> torch.Tensor:
    """The paper's Flag Aggregator (Gram-space solver)."""
    c, _ = fa_weights_from_gram(gram_matrix(Gw.T), cfg)
    return Gw.T @ c.to(Gw.dtype)


def geometric_median(Gw: torch.Tensor, *, n_iter: int = 8, eps: float = 1e-8,
                     **_) -> torch.Tensor:
    """Weiszfeld iterations (extra baseline, not in the paper's table)."""
    z = Gw.mean(dim=0)
    for _ in range(n_iter):
        w = torch.rsqrt(torch.clamp(((Gw - z[None, :]) ** 2).sum(dim=1),
                                    min=eps))
        z = (Gw * w[:, None]).sum(dim=0) / w.sum()
    return z


AGGREGATORS: dict[str, Callable] = {
    "mean": mean,
    "median": median,
    "trimmed_mean": trimmed_mean,
    "meamed": meamed,
    "phocas": phocas,
    "krum": krum,
    "multi_krum": multi_krum,
    "bulyan": bulyan,
    "pca": pca_topm,
    "geomed": geometric_median,
    "flag": flag,
}


def get_aggregator(name: str) -> Callable:
    try:
        return AGGREGATORS[name]
    except KeyError:
        raise KeyError(
            f"unknown aggregator {name!r}; have {sorted(AGGREGATORS)}"
        ) from None
