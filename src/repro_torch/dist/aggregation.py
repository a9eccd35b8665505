"""Aggregation of the worker-major (W, N) gradient buffer: every rule.

Port of ``repro/dist/aggregation.py``.  The JAX package aggregates a
pytree of ``(W, ...)`` leaves and never builds the flat stack; here the
train step already holds every worker's gradient in one (W, N) buffer
(columns in the canonical leaf order of :mod:`repro_torch.weights`), so the
"tree" is that buffer and every n-dependent stage reads it in place:

* ``tree_gram`` -- the (W, W) Gram matrix in one pass (Hopper kernel on a
  CUDA buffer, ``sketch_stride`` folded into the chunk walk);
* ``tree_combine`` -- ``d = sum_w c_w g_w`` in one launch over all N;
* ``coord_stat`` -- a coordinate-wise statistic over the workers in one
  launch over all N.  Coordinate-wise rules commute with the leaf split,
  so one launch over the buffer equals the JAX per-leaf map.

Rules and their paths (``GRAM_RULES``, ``COORDWISE_RULES``, ``bulyan``):

* FA, PCA-top-m, mean and the geometric median (Weiszfeld in weight
  space) compute their weights c from K alone, then combine;
* Krum and Multi-Krum score the workers from ``sq_dists_from_gram(K)``
  with the Krum-scores kernel, pick by argmin / stable argsort of the W
  scores, then combine; under a mask, ``masked_selection_weights``;
* median, trimmed mean, MeaMed and Phocas are one ``coord_stat`` launch;
* Bulyan picks theta workers with the Bulyan-select kernel on
  ``sq_dists_from_gram(K)``, then runs MeaMed with f' = 2f over the picked
  rows in pick order, read in place through ``rows=`` (a gathered
  (theta, N) copy would be 13 GB at W = 15, f = 3); under a mask,
  ``masked_bulyan_select`` and the masked MeaMed with the selection as
  mask, in worker order.

Picks, scores and masks stay device tensors: nothing is read on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import aggregators
from repro_torch.core.flag import FlagConfig
from repro_torch.core.gram import fa_weights_from_gram
from repro_torch.kernels.coord_stats.ops import (bulyan_select, coord_stat,
                                                 krum_scores)
from repro_torch.kernels.gram.ops import tree_gram_fused
from repro_torch.kernels.weighted_sum.ops import weighted_sum

__all__ = ["AggregatorConfig", "tree_gram", "tree_combine", "aggregate_tree",
           "compressed_aggregate", "GRAM_RULES", "COORDWISE_RULES", "RULES"]

GRAM_RULES = frozenset({"flag", "pca", "mean", "geomed", "krum",
                        "multi_krum"})
COORDWISE_RULES = frozenset({"median", "trimmed_mean", "meamed", "phocas"})
RULES = GRAM_RULES | COORDWISE_RULES | {"bulyan"}


def check_rule(name: str) -> None:
    """Raise ``KeyError`` listing the registry for an unknown rule."""
    if name not in RULES:
        raise KeyError(f"unknown aggregator {name!r}; have {sorted(RULES)}")


@dataclass(frozen=True)
class AggregatorConfig:
    """Which rule runs and how the Gram matrix is formed.

    ``f`` is the assumed Byzantine count; ``flag`` carries the FA
    hyper-parameters; ``sketch_stride`` > 1 sketches the Gram matrix
    (every stride-th chunk, rescaled); ``gram_dtype`` = ``"bfloat16"``
    rounds the stack to bf16 before the Gram products (fp32 accumulation).
    The backend follows the buffer's device, so there is no ``impl``.
    """

    name: str = "flag"
    f: int = 1
    flag: FlagConfig = FlagConfig()
    sketch_stride: int = 1
    gram_dtype: str = "float32"


def _check_stack(X: torch.Tensor, who: str) -> None:
    if X.dim() != 2:
        raise ValueError(f"{who}: expects the worker-major (W, N) buffer, "
                         f"got shape {tuple(X.shape)}")


def tree_gram(X: torch.Tensor, sketch_stride: int = 1, *,
              gram_dtype: str = "float32") -> torch.Tensor:
    """(W, W) fp32 Gram matrix ``K[i, j] = <g_i, g_j>`` of the worker-major
    buffer in one pass (sketched with ``sketch_stride`` > 1)."""
    _check_stack(X, "tree_gram")
    return tree_gram_fused(X, sketch_stride=sketch_stride,
                           gram_dtype=gram_dtype)


def tree_combine(X: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """``d = sum_w c_w g_w``: (N,) in the buffer's dtype, c kept in fp32."""
    _check_stack(X, "tree_combine")
    return weighted_sum(X, c)


def _geomed_weights(K: torch.Tensor, n_iter: int = 8, eps: float = 1e-8,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Weiszfeld in weight space: z = G^T w stays in span(G), so
    ||g_i - z||^2 = K_ii - 2 (K w)_i + w^T K w (init w = 1/p, the mean)."""
    p = K.shape[0]
    eps = max(eps, 1e-30)
    m = (torch.ones((p,), dtype=K.dtype, device=K.device) if mask is None
         else mask.to(K.dtype))
    w = m / torch.clamp(m.sum(), min=1.0)
    diag = torch.diagonal(K)
    for _ in range(n_iter):
        Kw = K @ w
        d2 = diag - 2.0 * Kw + w @ Kw
        r = torch.rsqrt(torch.clamp(d2, min=eps)) * m
        s = r.sum()
        w = torch.where(s > 0.0, r / torch.clamp(s, min=1e-30), w)
    return w


def _selection_weights(K: torch.Tensor, name: str, f: int) -> torch.Tensor:
    """Krum-family combination weights from the Gram matrix: scores by the
    Krum-scores kernel, then the argmin (Krum) or the q = max(p - f - 2, 1)
    lowest scores, lower index first on ties (Multi-Krum)."""
    p = K.shape[0]
    s = krum_scores(aggregators.sq_dists_from_gram(K), f)
    c = torch.zeros((p,), dtype=K.dtype, device=K.device)
    if name == "krum":
        return c.scatter_(0, torch.argmin(s).reshape(1), 1.0)
    q = max(p - f - 2, 1)
    return c.index_fill_(0, torch.argsort(s, stable=True)[:q], 1.0 / q)


def _gram_weights(K: torch.Tensor, cfg: AggregatorConfig,
                  mask: torch.Tensor | None = None):
    """(c, aux) for every rule expressible as a fixed combine d = G^T c."""
    p = K.shape[0]
    if cfg.name == "flag":
        return fa_weights_from_gram(K, cfg.flag, mask=mask)
    if cfg.name == "pca":
        pca_cfg = FlagConfig(m=cfg.flag.m, lam=0.0, regularizer="none",
                             n_iter=1)
        return fa_weights_from_gram(K, pca_cfg, mask=mask)
    if cfg.name == "mean":
        if mask is None:
            return torch.full((p,), 1.0 / p, dtype=K.dtype,
                              device=K.device), {}
        m = mask.to(K.dtype)
        return m / torch.clamp(m.sum(), min=1.0), {}
    if cfg.name == "geomed":
        return _geomed_weights(K, mask=mask), {}
    if cfg.name in ("krum", "multi_krum"):
        if mask is None:
            return _selection_weights(K, cfg.name, cfg.f), {}
        return aggregators.masked_selection_weights(
            aggregators.sq_dists_from_gram(K), cfg.name, cfg.f, mask), {}
    raise KeyError(cfg.name)


def aggregate_tree(X: torch.Tensor, cfg: AggregatorConfig, *,
                   gram: torch.Tensor | None = None,
                   mask: torch.Tensor | None = None):
    """Aggregate the worker-major gradient buffer.

    Args:
      X: (W, N) worker-major gradients, columns in the canonical leaf order
        (:func:`repro_torch.weights.leaf_items`).  Read, never copied.
      cfg: which rule runs and how the Gram matrix is formed.
      gram: optional precomputed (W, W) Gram estimate; the Gram-space
        rules (and Bulyan's selection) then compute their weights from it
        and ``tree_gram`` is skipped.  The coordinate-wise rules have no
        Gram stage and raise ``ValueError`` on it.
      mask: optional (W,) active-worker membership (0/1), kept on the
        device; every rule then runs on the active subset (masked Gram rows,
        or order statistics at positions from the active count), and
        inactive workers get combine weight exactly 0.
    Returns:
      ``(d, aux)``: d is the (N,) update in X's dtype (its leaves are views,
      :func:`repro_torch.weights.unflatten`); ``aux["weights"]`` is the
      (W,) combination-weight vector, the ``fa_weights`` metric (uniform
      over the active workers for the coordinate-wise rules, which have no
      single linear combine; 1/theta on Bulyan's picks).
    """
    _check_stack(X, "aggregate_tree")
    check_rule(cfg.name)
    if gram is not None and cfg.name in COORDWISE_RULES:
        raise ValueError(f"aggregator {cfg.name!r} is coordinate-wise and "
                         "cannot consume a precomputed Gram matrix")
    W = X.shape[0]
    if mask is not None:
        mask = mask.to(device=X.device, dtype=torch.float32)

    if cfg.name in COORDWISE_RULES:
        d = coord_stat(X, cfg.name, cfg.f, mask=mask)
        if mask is None:
            return d, {"weights": torch.full((W,), 1.0 / W,
                                             dtype=torch.float32,
                                             device=X.device)}
        return d, {"weights": mask / torch.clamp(mask.sum(), min=1.0)}

    K = gram if gram is not None else tree_gram(
        X, cfg.sketch_stride, gram_dtype=cfg.gram_dtype)
    if cfg.name == "bulyan":
        D2 = aggregators.sq_dists_from_gram(K)
        if mask is None:
            # Bulyan's coordinate stage is MeaMed with f' = 2f over the
            # picked rows, read in pick order through rows=.
            picks = bulyan_select(D2, cfg.f)
            d = coord_stat(X, "meamed", 2 * cfg.f, rows=picks)
            theta = picks.numel()
            c = torch.zeros((W,), dtype=torch.float32, device=X.device)
            return d, {"weights": c.index_fill_(0, picks.long(), 1.0 / theta)}
        selected, theta = aggregators.masked_bulyan_select(D2, cfg.f, mask)
        sel = selected.to(torch.float32)
        # masked MeaMed over the selection: W_a = theta, so its keep count
        # max(W_a - 2f, 1) is Bulyan's beta
        d = coord_stat(X, "meamed", 2 * cfg.f, mask=sel)
        return d, {"weights": sel / torch.clamp(theta, min=1)}

    c, aux = _gram_weights(K, cfg, mask)
    d = tree_combine(X, c)
    return d, {**aux, "weights": c}


def compressed_aggregate(X: torch.Tensor, cfg: AggregatorConfig,
                         codec: str = "none", *,
                         mask: torch.Tensor | None = None):
    """The worker->server codec bridge; the port has only ``"none"``: the
    plain :func:`aggregate_tree`, for every rule of ``RULES``, with the
    dense bit count (``comm_bits`` = the fp32-dense payload scaled by the
    active fraction, ``comm_ratio`` = 1)."""
    if codec != "none":
        raise NotImplementedError(
            f"codec {codec!r}: the repro.comm codecs come with a later slice")
    W = X.shape[0]
    bits = float(X.numel() * X.element_size() * 8)
    frac = (torch.ones((), device=X.device) if mask is None
            else torch.clamp(mask.float().sum(), min=1.0) / W)
    d, aux = aggregate_tree(X, cfg, mask=mask)
    return d, {**aux, "comm_bits": bits * frac,
               "comm_ratio": torch.ones((), device=X.device)}
