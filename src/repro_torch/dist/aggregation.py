"""Aggregation of the worker-major (W, N) gradient buffer.

Port of ``repro/dist/aggregation.py`` for the Gram-space rules.  The JAX
package aggregates a pytree of ``(W, ...)`` leaves and never builds the
flat stack; here the train step already holds every worker's gradient in
one (W, N) buffer (columns in the canonical leaf order of
:mod:`repro_torch.weights`), so the "tree" is that buffer and both
n-dependent stages read it in place:

* ``tree_gram`` -- the (W, W) Gram matrix in one pass (Hopper kernel on a
  CUDA buffer, ``sketch_stride`` folded into the chunk walk);
* ``tree_combine`` -- ``d = sum_w c_w g_w`` in one launch over all N.

Between them the rule computes its weights c from K alone: FA
(``fa_weights_from_gram``), PCA-top-m, mean and the geometric median
(Weiszfeld in weight space).  The Krum family, the coordinate-wise rules
and Bulyan need kernels of later slices and raise here.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.flag import FlagConfig
from repro_torch.core.gram import fa_weights_from_gram
from repro_torch.kernels.gram.ops import tree_gram_fused
from repro_torch.kernels.weighted_sum.ops import weighted_sum

__all__ = ["AggregatorConfig", "tree_gram", "tree_combine", "aggregate_tree",
           "compressed_aggregate", "GRAM_RULES", "LATER_RULES"]

GRAM_RULES = frozenset({"flag", "pca", "mean", "geomed"})
# rule -> the kernel port it waits for
LATER_RULES = {
    "krum": "krum_scores (kernels/coord_stats)",
    "multi_krum": "krum_scores (kernels/coord_stats)",
    "median": "coord_stats (kernels/coord_stats)",
    "trimmed_mean": "coord_stats (kernels/coord_stats)",
    "meamed": "coord_stats (kernels/coord_stats)",
    "phocas": "coord_stats (kernels/coord_stats)",
    "bulyan": "bulyan_select + coord_stats (kernels/coord_stats)",
}


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
    raise KeyError(cfg.name)


def aggregate_tree(X: torch.Tensor, cfg: AggregatorConfig, *,
                   gram: torch.Tensor | None = None,
                   mask: torch.Tensor | None = None):
    """Aggregate the worker-major gradient buffer.

    Args:
      X: (W, N) worker-major gradients, columns in the canonical leaf order
        (:func:`repro_torch.weights.leaf_items`).  Read, never copied.
      cfg: which rule runs and how the Gram matrix is formed.
      gram: optional precomputed (W, W) Gram estimate; the rule's weights
        are then computed from it and ``tree_gram`` is skipped.
      mask: optional (W,) active-worker membership (0/1), kept on the
        device; inactive workers get combine weight exactly 0.
    Returns:
      ``(d, aux)``: d is the (N,) update in X's dtype (its leaves are views,
      :func:`repro_torch.weights.unflatten`); ``aux["weights"]`` is the
      (W,) combination-weight vector, the ``fa_weights`` metric.
    """
    _check_stack(X, "aggregate_tree")
    if cfg.name in LATER_RULES:
        raise NotImplementedError(
            f"aggregator {cfg.name!r} needs the port of "
            f"{LATER_RULES[cfg.name]}, which comes with a later slice")
    if cfg.name not in GRAM_RULES:
        raise KeyError(f"unknown aggregator {cfg.name!r}; have "
                       f"{sorted(GRAM_RULES | set(LATER_RULES))}")
    if mask is not None:
        mask = mask.to(device=X.device, dtype=torch.float32)
    K = gram if gram is not None else tree_gram(
        X, cfg.sketch_stride, gram_dtype=cfg.gram_dtype)
    c, aux = _gram_weights(K, cfg, mask)
    d = tree_combine(X, c)
    return d, {**aux, "weights": c}


def compressed_aggregate(X: torch.Tensor, cfg: AggregatorConfig,
                         codec: str = "none", *,
                         mask: torch.Tensor | None = None):
    """The worker->server codec bridge; this slice has only ``"none"``, the
    plain :func:`aggregate_tree` with the dense bit count (``comm_bits`` =
    the fp32-dense payload, ``comm_ratio`` = 1)."""
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
