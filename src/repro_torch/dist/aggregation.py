"""Aggregation of the worker-major (W, N) gradient buffer: every rule.

Port of ``repro/dist/aggregation.py``.  The JAX package aggregates a
pytree of ``(W, ...)`` leaves and never builds the flat stack; here the
train step already holds every worker's gradient in one (W, N) buffer
(columns in the canonical leaf order of :mod:`repro_torch.weights`), so the
"tree" is that buffer and every n-dependent stage reads it in place:

* ``tree_gram`` -- the (W, W) Gram matrix in one pass (Hopper kernel on a
  CUDA buffer, ``sketch_stride`` folded into the chunk walk), or with
  ``fused=False`` one per-matrix Gram launch per leaf (the JAX package's
  looped path, which ``aggregate_tree`` does not take);
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

:func:`compressed_aggregate` routes a :mod:`repro_torch.comm` codec
around ``aggregate_tree``: the CountSketch payload feeds the Gram path of
the Gram rules directly, every other codec runs its (error-feedback)
round in place on the buffer first; both on one device and on a rank's
coordinate shard.

Picks, scores and masks stay device tensors: nothing is read on the host.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.analysis.contract import contract
from repro_torch.comm.compressors import (Codec, CommConfig, get_codec,
                                          leaf_cols, no_reduce)
from repro_torch.comm.error_feedback import ef_round
from repro_torch.core import aggregators
from repro_torch.core.flag import FlagConfig
from repro_torch.core.gram import fa_weights_from_gram
from repro_torch.kernels.coord_stats.ops import (bulyan_select, coord_stat,
                                                 krum_scores)
from repro_torch.kernels.gram.ops import gram, tree_gram_fused
from repro_torch.kernels.weighted_sum.ops import weighted_sum
from repro_torch.weights import Layout

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


def _leaf_matrix(leaf: torch.Tensor, stride: int):
    """(W, n) leaf view -> ((W, n_kept) strided view, fp32 Gram rescale).

    Keeps every stride-th coordinate, with the *exact* inverse kept
    fraction ``n / n_kept`` as the rescale (unbiased diagonal even when n is
    not a multiple of the stride).  The scale is applied to the fp32 Gram,
    never to the matrix.  Leaves narrower than the stride keep every
    coordinate (scale 1, exact) instead of one sample inflated
    stride-fold.  No copy is made.
    """
    n = leaf.shape[1]
    if stride > 1 and n > stride:
        M = leaf[:, ::stride]
        return M, n / M.shape[1]
    return leaf, 1.0


def tree_gram(X: torch.Tensor, sketch_stride: int = 1, *,
              gram_dtype: str = "float32", fused: bool = True,
              leaf_sizes=None) -> torch.Tensor:
    """(W, W) fp32 Gram matrix ``K[i, j] = <g_i, g_j>`` of the worker-major
    buffer.

    The default *fused* path is one pass over the buffer (one kernel
    launch), sketched with ``sketch_stride`` > 1 by keeping every
    stride-th block_n-wide chunk.  ``fused=False`` is the JAX package's
    per-leaf loop: ``leaf_sizes`` (the ``sizes`` of
    ``weights.layout_of(...)``) split the columns into one (W, n_i) view
    per leaf, each leaf keeps every stride-th coordinate (leaves narrower
    than the stride stay exact) and goes to ``gram`` as a transposed,
    strided view -- one launch per leaf, no copy and no padding -- and the
    exact inverse kept fraction rescales each leaf's fp32 Gram.  Both
    sketches keep the diagonal unbiased; they keep different coordinates.
    """
    _check_stack(X, "tree_gram")
    if fused:
        return tree_gram_fused(X, sketch_stride=sketch_stride,
                               gram_dtype=gram_dtype)
    if leaf_sizes is None or sum(leaf_sizes) != X.shape[1] \
            or min(leaf_sizes, default=0) < 1:
        raise ValueError(f"tree_gram(fused=False) needs leaf_sizes, positive "
                         f"and summing to the buffer's {X.shape[1]} columns "
                         f"(weights.layout_of(...).sizes), got {leaf_sizes}")
    W = X.shape[0]
    K = torch.zeros((W, W), dtype=torch.float32, device=X.device)
    off = 0
    for n in leaf_sizes:
        M, scale = _leaf_matrix(X[:, off:off + n], max(1, sketch_stride))
        K = K + gram(M.T, gram_dtype=gram_dtype) * scale
        off += n
    return K


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


def _sharded_mesh(sharded):
    """The mesh of ``sharded=``: a Mesh, or ``True`` for the active
    ``use_sharding`` mesh (JAX's message when there is none)."""
    from repro_torch.dist.sharding import current_mesh
    from repro_torch.launch.mesh import Mesh
    if isinstance(sharded, Mesh):
        return sharded
    mesh = current_mesh()
    if mesh is None:
        raise ValueError(
            "aggregate_tree(sharded=True) needs an active mesh: wrap the "
            "call in repro_torch.dist.sharding.use_sharding(...) or pass "
            "sharded=<repro_torch.launch.mesh.Mesh>")
    return mesh


@contract(fp32_contractions=True, no_host_transfers=True, mask_traced=True,
          no_full_width=True, kernel_race=True, kernel_budget=True)
def aggregate_tree(X: torch.Tensor, cfg: AggregatorConfig, *,
                   gram: torch.Tensor | None = None,
                   mask: torch.Tensor | None = None,
                   sharded=None, leaf_sizes=None):
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
      sharded: shard the aggregation over the mesh's ranks
        (:mod:`repro_torch.dist.sharded`): X is then this rank's ``(W,
        width)`` coordinate-shard buffer of the stack whose leaves have
        ``leaf_sizes`` coordinates (``repro_torch.dist.sharding.
        CoordShards``), the (W, W) Gram meets in one ``all_reduce``, the
        weights run replicated and the combine / coordinate rules stay
        shard-local: d is the rank's ``(width,)`` block
        (``repro_torch.dist.sharded.gather_flat`` puts the ranks' blocks
        together; a tensor-parallel step brings each rank only its
        blocks, ``repro_torch.dist.sharded.TPReturn``).  Pass a
        :class:`repro_torch.launch.mesh.Mesh`, or ``True`` for the active
        ``use_sharding`` mesh.  ``None`` / ``False`` keeps the one-device
        path.
    Returns:
      ``(d, aux)``: d is the (N,) update in X's dtype (its leaves are views,
      :func:`repro_torch.weights.unflatten`), with ``sharded`` this rank's
      ``(width,)`` block of it; ``aux["weights"]`` is the
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
    # The stage that differs when sharded: the Gram (summed over the
    # ranks); the rule dispatch below is the same for both paths.
    gram_of = tree_gram
    if sharded:
        from repro_torch.dist.sharded import sharded_gram_of
        if leaf_sizes is None:
            raise ValueError("aggregate_tree(sharded=...) needs leaf_sizes, "
                             "the per-worker coordinates of each leaf")
        gram_of = sharded_gram_of(X, leaf_sizes, _sharded_mesh(sharded))

    if cfg.name in COORDWISE_RULES:
        d = coord_stat(X, cfg.name, cfg.f, mask=mask)
        if mask is None:
            return d, {"weights": torch.full((W,), 1.0 / W,
                                             dtype=torch.float32,
                                             device=X.device)}
        return d, {"weights": mask / torch.clamp(mask.sum(), min=1.0)}

    K = gram if gram is not None else gram_of(
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


@contract(fp32_contractions=True, no_host_transfers=True, mask_traced=True,
          no_full_width=True)
def compressed_aggregate(X: torch.Tensor, cfg: AggregatorConfig,
                         comm: CommConfig = CommConfig(),
                         ef: torch.Tensor | None = None, *,
                         layout: Layout | None = None,
                         mask: torch.Tensor | None = None,
                         codec: Codec | None = None,
                         sharded=None):
    """Aggregate through a worker->server codec.

    Routes (those of the JAX package's ``compressed_aggregate``):

    * ``comm.codec == "none"`` -- plain :func:`aggregate_tree`; the dense
      buffer is the payload (``comm_bits`` = the fp32 baseline).
    * a Gram-feeding codec (CountSketch) under a rule of ``GRAM_RULES``
      without EF -- the payload, one (W, sum_i k_i) buffer of per-leaf
      sketch blocks, gives the Gram estimate (``tree_gram`` over it), and
      :func:`aggregate_tree` combines the **exact** gradients with the
      weights from it (``gram=``).  Nothing is decoded and no second
      (W, N) buffer is made.  An explicit ``error_feedback=True`` takes
      the last route instead, as in the JAX package.
    * every other case -- the EF round (or the codec without EF) in place
      (:func:`repro_torch.comm.error_feedback.ef_round`), then
      :func:`aggregate_tree` on the decoded buffer.

    Args:
      X: (W, N) fp32 worker-major gradients, columns in ``layout``'s
        order.  Consumed: on the last route it holds the decoded estimates
        on return.
      cfg: the rule.
      comm: codec selection and hyper-parameters.
      ef: the EF memory, X's shape (``repro_torch.comm.init_ef``), updated
        in place, or ``None``; required when ``comm.wants_ef``.
      layout: the per-worker leaf layout (codecs act per leaf); required
        for every codec but ``"none"``.
      mask: optional (W,) active-worker membership on X's device.
        Inactive workers ship no bits (``comm_bits`` scales by the active
        fraction) and their EF memory is frozen.
      codec: ``get_codec(comm)``, built once by a caller that keeps it
        across steps (CountSketch keeps its device maps); built here when
        not given.
      sharded: as :func:`aggregate_tree`'s; X (and ``ef``) are then this
        rank's (W, width) coordinate shards and ``layout`` (required) the
        per-worker layout of the whole stack.  Every route runs on the
        shards: each rank sketches, encodes and decodes its own columns of
        every leaf, and the codec's one cross-rank step is a collective
        (``repro_torch.comm.compressors``: the sketch's ``all_reduce``,
        signSGD's row sums', top-k's threshold counts'), so no rank holds a
        (W, N) gradient, estimate or EF buffer; the decoded shard then
        goes through the sharded :func:`aggregate_tree`.
    Returns:
      ``(d, aux, new_ef)``: d as :func:`aggregate_tree`'s (with
      ``sharded`` this rank's ``(width,)`` block); ``aux`` extends the
      rule's aux with
      ``comm_bits`` (bits shipped worker->server this step, by the codec's
      cost model, float64) and ``comm_ratio`` (dense fp32 bits over the
      codec's); ``new_ef`` is ``ef`` (updated in place when EF runs).
    """
    W = X.shape[0]
    if sharded:
        if layout is None:
            raise ValueError("compressed_aggregate(sharded=...) needs the "
                             "leaf layout of the whole stack")
        N = layout.numel
        route = dict(sharded=sharded, leaf_sizes=layout.sizes)
    else:
        N, route = X.shape[1], {}
    dense = float(W * N * X.element_size() * 8)
    frac = (torch.ones((), dtype=torch.float64, device=X.device)
            if mask is None else
            torch.clamp(mask.to(X.device, torch.float64).sum(), min=1.0) / W)
    if comm.codec == "none":
        d, aux = aggregate_tree(X, cfg, mask=mask, **route)
        return d, {**aux, "comm_bits": dense * frac,
                   "comm_ratio": torch.ones((), dtype=torch.float64,
                                            device=X.device)}, ef
    codec = codec or get_codec(comm)
    if layout is None or (layout.numel != X.shape[1] and not sharded):
        raise ValueError(f"compressed_aggregate: codec {comm.codec!r} needs "
                         f"the leaf layout of X's {X.shape[1]} columns")
    if comm.wants_ef and ef is None:
        raise ValueError(
            f"codec {comm.codec!r} needs error feedback: pass "
            "ef=repro_torch.comm.init_ef(params, workers) and carry it "
            "across steps (or set CommConfig(error_feedback=False))")
    if comm.wants_ef and ef.shape != X.shape:
        raise ValueError(f"compressed_aggregate: the EF memory "
                         f"{tuple(ef.shape)} must have the gradient "
                         f"buffer's shape {tuple(X.shape)}")
    reduce = no_reduce
    if sharded:
        from repro_torch.dist.sharded import (all_reduce_, coord_shards,
                                              shard_index)
        mesh = _sharded_mesh(sharded)
        shards = coord_shards(layout.sizes, mesh)
        if X.shape[1] != shards.width:
            raise ValueError(f"compressed_aggregate(sharded=...): expects "
                             f"this rank's (W, {shards.width}) coordinate "
                             f"shard, got {tuple(X.shape)}")
        cols, reduce = leaf_cols(layout, shards, shard_index(mesh)), \
            all_reduce_
    else:
        cols = leaf_cols(layout)
    bits = codec.bits(layout, W)
    stats = {"comm_bits": bits * frac,
             "comm_ratio": torch.full((), dense / bits, dtype=torch.float64,
                                      device=X.device)}
    if codec.gram_feed and cfg.name in GRAM_RULES and not comm.wants_ef:
        P = (reduce(codec.sketch_cols(X, cols), "sketch_all_reduce")
             if sharded else codec.sketch(X, layout))
        K = tree_gram(P, gram_dtype=cfg.gram_dtype)
        d, aux = aggregate_tree(X, cfg, gram=K, mask=mask, **route)
        return d, {**aux, **stats}, ef
    ef_round(codec, X, cols, ef if comm.wants_ef else None, mask=mask,
             reduce=reduce)
    d, aux = aggregate_tree(X, cfg, mask=mask, **route)
    return d, {**aux, **stats}, ef
