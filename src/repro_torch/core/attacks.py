"""Byzantine attack library on the worker-major (W, N) gradient buffer.

Port of ``repro/core/attacks.py``.  The first ``f`` workers are Byzantine;
every attack rewrites their rows of the buffer **in place** (the buffer is
the step's only copy of the gradients, so no second (W, N) array is made).

  random      uniform noise in [-1, 1] times the leaf's max |g|
  gaussian    N(0, sigma^2) noise, sigma = the leaf's std
  sign_flip   -10 x the worker's own gradient
  zero        zeros
  drop        each coordinate zeroed with probability 0.1
  ipm         -0.1 x the honest mean (Fall of Empires)
  alie        honest mean - 1.5 x honest std (A Little Is Enough)

``random`` and ``gaussian`` scale by a statistic of **each leaf** in the
JAX package, so here they work leaf by leaf on the leaf's column range;
the others are per coordinate and act on whole rows.  Random draws come
from ``torch.Generator``s seeded from ``(seed, leaf index)``; they cannot
match ``jax.random``'s bits.

On a rank's coordinate shard (``shards=``, the sharded train step) every
attack gives the slice of the unsharded values: the per-coordinate ones
act on the shard as they are; ``random`` / ``gaussian`` / ``drop`` draw
each leaf's ``(f, n)`` noise whole from the leaf's generator (one leaf at
a time) and keep the shard's columns; the leaf's max |g| is reduced
across ranks with ``all_reduce`` MAX (exact), its population std from the
ranks' per-shard means and variances (within fp32 reassociation).
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

__all__ = ["ATTACKS", "apply_attack", "byzantine_mask"]


def byzantine_mask(p: int, f: int, device=None) -> torch.Tensor:
    """Boolean (p,) mask, True for Byzantine workers (the first f)."""
    return torch.arange(p, device=device) < f


def _leaf_ranges(sizes: Sequence[int]):
    off = 0
    for i, s in enumerate(sizes):
        yield i, off, off + s
        off += s


def _generator(X: torch.Tensor, seed: int, leaf: int) -> torch.Tensor:
    g = torch.Generator(device=X.device)
    g.manual_seed((int(seed) * 1_000_003 + leaf) % (2 ** 63))
    return g


def _honest_stats(X: torch.Tensor, f: int):
    """Per-coordinate mean and (population) std over the honest rows,
    summed row by row so no (W, N) temporary is made."""
    honest = X[f:]
    denom = max(X.shape[0] - f, 1)
    mu = torch.zeros(X.shape[1], dtype=torch.float32, device=X.device)
    for row in honest:
        mu += row.float()
    mu /= denom
    var = torch.zeros_like(mu)
    for row in honest:
        var += (row.float() - mu) ** 2
    var /= denom
    return mu, torch.sqrt(var)


def _leaf_std(view: torch.Tensor, n: int, reduce) -> torch.Tensor:
    """Population std of a (W, n) leaf of which ``view`` holds this rank's
    columns: the ranks' counts, means and variances combined (Chan et
    al.), two ``all_reduce`` SUMs."""
    W, m = view.shape
    if m:
        var_l, mean_l = torch.var_mean(view, correction=0)
    else:
        var_l = mean_l = torch.zeros((), dtype=view.dtype, device=view.device)
    cnt_l = float(W * m)
    total = float(W * n)
    mean = reduce(mean_l * cnt_l) / total
    m2 = reduce(cnt_l * (var_l + (mean_l - mean) ** 2))
    return torch.sqrt(m2 / total)


def _random(X, f, leaves, seed, reduce, *, scale: float = 1.0):
    for i, leaf, lo, hi, n in leaves:
        local = (torch.linalg.vector_norm(leaf, ord=float("inf"))
                 if leaf.numel() else
                 torch.zeros((), dtype=X.dtype, device=X.device))
        s = scale * (local if reduce is None else reduce(local, "max"))
        noise = torch.rand((f, n), generator=_generator(X, seed, i),
                           device=X.device, dtype=X.dtype)
        leaf[:f] = (noise[:, lo:hi] * 2.0 - 1.0) * s


def _gaussian(X, f, leaves, seed, reduce, *, sigma: float = 1.0):
    for i, leaf, lo, hi, n in leaves:
        s = sigma * (torch.std(leaf, correction=0) if reduce is None
                     else _leaf_std(leaf, n, reduce))
        noise = torch.randn((f, n), generator=_generator(X, seed, i),
                            device=X.device, dtype=X.dtype)
        leaf[:f] = noise[:, lo:hi] * s


def _sign_flip(X, f, leaves, seed, reduce, *, scale: float = 10.0):
    X[:f].mul_(-scale)


def _zero(X, f, leaves, seed, reduce):
    X[:f].zero_()


def _drop(X, f, leaves, seed, reduce, *, loss_rate: float = 0.10):
    """Communication loss: each Byzantine link drops loss_rate of coords."""
    for i, leaf, lo, hi, n in leaves:
        keep = torch.rand((f, n), generator=_generator(X, seed, i),
                          device=X.device) < 1.0 - loss_rate
        leaf[:f].mul_(keep[:, lo:hi])


def _ipm(X, f, leaves, seed, reduce, *, eps: float = 0.1):
    mu, _ = _honest_stats(X, f)
    X[:f] = (-eps * mu).to(X.dtype)


def _alie(X, f, leaves, seed, reduce, *, z: float = 1.5):
    mu, sd = _honest_stats(X, f)
    X[:f] = (mu - z * sd).to(X.dtype)


def _none(X, f, leaves, seed, reduce):
    pass


ATTACKS: dict[str, Callable] = {
    "none": _none,
    "random": _random,
    "gaussian": _gaussian,
    "sign_flip": _sign_flip,
    "zero": _zero,
    "drop": _drop,
    "ipm": _ipm,
    "alie": _alie,
}


def apply_attack(name: str, X: torch.Tensor, f: int, *,
                 leaf_sizes: Sequence[int] | None = None, seed: int = 0,
                 shards=None, shard: int = 0, **kw) -> torch.Tensor:
    """Apply attack ``name`` with ``f`` Byzantine workers to the worker-major
    (W, N) buffer ``X`` in place and return it.

    ``leaf_sizes`` gives the per-worker coordinate count of each leaf in
    buffer order (default: one leaf covering N); ``seed`` seeds the random
    attacks (the train step passes the step index).  With ``shards`` (a
    ``repro_torch.dist.sharding.CoordShards``) X is instead shard
    ``shard``'s (W, width) buffer and the leaves are the layout's (module
    docstring); every rank of the default process group must call it.
    """
    if name not in ATTACKS:
        raise KeyError(f"unknown attack {name!r}; have {sorted(ATTACKS)}")
    if X.dim() != 2:
        raise ValueError(f"apply_attack: X must be (W, N), got {tuple(X.shape)}")
    f = min(max(int(f), 0), X.shape[0])
    if f == 0:
        return X
    if shards is not None:
        from repro_torch.dist.sharded import all_reduce_
        import torch.distributed as dist
        if X.shape[1] != shards.width:
            raise ValueError(f"apply_attack: shard buffer has {X.shape[1]} "
                             f"columns, the layout {shards.width}")
        leaves = [(i, X[:, off:off + hi - lo], lo, hi, n) for
                  (i, off, lo, hi), n in zip(shards.cols(shard), shards.sizes)]

        def reduce(t, op="sum"):
            return all_reduce_(t.contiguous(), "attack_all_reduce",
                               dist.ReduceOp.MAX if op == "max"
                               else dist.ReduceOp.SUM)
    else:
        sizes = list(leaf_sizes) if leaf_sizes is not None else [X.shape[1]]
        if sum(sizes) != X.shape[1]:
            raise ValueError(f"apply_attack: leaf sizes sum to {sum(sizes)}, "
                             f"buffer has {X.shape[1]} columns")
        leaves = [(i, X[:, a:b], 0, b - a, b - a)
                  for i, a, b in _leaf_ranges(sizes)]
        reduce = None
    with torch.no_grad():
        ATTACKS[name](X, f, leaves, seed, reduce, **kw)
    return X
