"""Plain PyTorch versions of the coordinate-statistics and distance-selection
kernels.

Port of ``repro/kernels/coord_stats/ref.py`` (median, trimmed mean, MeaMed,
Phocas over the worker axis) and of the masked statistics and the Krum /
Bulyan selections of ``repro/core/aggregators.py``.  They are the single
source of these rules in the port: :mod:`repro_torch.core.aggregators`
imports them, the CPU path of :mod:`.ops` runs them, and ``chip_smoke.py``
holds the CUDA kernels against them on the card.

Clamps, exactly as the JAX package clamps (``p`` workers, or the active
count ``W_a = max(sum(mask != 0), 1)`` under a mask):

* trimmed mean: trim ``kt = min(f, (p - 1) // 2)`` values per side;
* MeaMed / Phocas: keep the ``ka = max(p - f, 1)`` values nearest the
  center (the median, or the trimmed mean);
* median: ``(S[(p - 1) // 2] + S[p // 2]) * 0.5`` of the sorted column, the
  formula of ``jnp.median`` (and of the masked median) for odd and even p.

Tie rules.  "Nearest" is a stable argsort on ``|g - center|``: on a tie the
lower worker index is kept, as ``jnp.argsort`` does (torch's default sort
is not stable, so ``stable=True`` throughout).  Inactive workers get the
key ``+inf``, as the JAX masked references give them.

Summation order.  Every mean here is a sequential fp32 sum in ascending
order of value followed by one division by the count -- the order the CUDA
kernel uses.  MeaMed and Phocas sum their kept set (the stable argsort's)
in ascending order of value too: in the sorted column that set is
(but for values exactly as far from the center as the set's edge) a
contiguous window, which the kernel sums as it lies.  The order matters
for Phocas: its center is a trimmed mean, and when two values lie almost
equally far from it, the center's last bit decides which one is kept.
With the same sum order the kernel and this version keep the same set.

Columns are walked ``CHUNK`` at a time: a sort of the whole (15, 3.6e8)
buffer would return 21.7 GB of values and 43 GB of int64 indices, more
than the card holds beside the buffer itself.
"""

from __future__ import annotations

import torch

__all__ = ["COORD_OPS", "CHUNK", "coord_stat_plain", "mean_nearest",
           "krum_scores_plain", "bulyan_select_plain"]

COORD_OPS = ("median", "trimmed_mean", "meamed", "phocas")
CHUNK = 1 << 22
_INF = float("inf")


def _row(S: torch.Tensor, i) -> torch.Tensor:
    """S[i] for a Python int or a 0-dim device index (no host read)."""
    if isinstance(i, int):
        return S[i]
    return S.index_select(0, i.reshape(1))[0]


def _median_sorted(S: torch.Tensor, wa) -> torch.Tensor:
    return (_row(S, (wa - 1) // 2) + _row(S, wa // 2)) * 0.5


def _sum_rows(S: torch.Tensor, lo, hi) -> torch.Tensor:
    """sum_{lo <= i < hi} S[i], sequential fp32 in ascending i."""
    acc = torch.zeros(S.shape[1:], dtype=torch.float32, device=S.device)
    for i in range(S.shape[0]):
        if isinstance(lo, int) and isinstance(hi, int):
            if lo <= i < hi:
                acc = acc + S[i]
        else:
            acc = acc + torch.where((i >= lo) & (i < hi), S[i], 0.0)
    return acc


def _count(c, device) -> torch.Tensor:
    """A count as a device float: a tensor divisor keeps the division a
    true IEEE division (a Python scalar may become a reciprocal product)."""
    if isinstance(c, int):
        return torch.tensor(float(c), device=device)
    return c.to(torch.float32)


def _trimmed_sorted(S: torch.Tensor, f: int, wa) -> torch.Tensor:
    if isinstance(wa, int):
        kt = min(f, (wa - 1) // 2)
        cnt = max(wa - 2 * kt, 1)
    else:
        kt = torch.clamp((wa - 1) // 2, max=f)
        cnt = torch.clamp(wa - 2 * kt, min=1)
    return _sum_rows(S, kt, wa - kt) / _count(cnt, S.device)


def mean_nearest(G: torch.Tensor, center: torch.Tensor, ka,
                 active: torch.Tensor | None) -> torch.Tensor:
    """Mean of the ka values of each fp32 column of G nearest ``center``
    (stable; ``ka`` an int or a device count; inactive rows of ``active``
    are infinitely far), summed in ascending order of value."""
    d = (G - center[None, :]).abs()
    if active is not None:
        d = torch.where(active[:, None], d, _INF)
    order = torch.argsort(d, dim=0, stable=True)
    rank = torch.empty_like(order)
    rank.scatter_(0, order, torch.arange(G.shape[0], device=G.device)
                  [:, None].expand_as(order).contiguous())
    # the kept values in ascending order of value, the rest +inf above them
    vals = torch.sort(torch.where(rank < ka, G, _INF), dim=0).values
    return _sum_rows(vals, 0, ka) / _count(ka, G.device)


def _stat_chunk(G: torch.Tensor, op: str, f: int,
                active: torch.Tensor | None, wa) -> torch.Tensor:
    """One statistic over the rows of the fp32 (R, c) block G."""
    keys = G if active is None else torch.where(active[:, None], G, _INF)
    S = torch.sort(keys, dim=0).values
    if op in ("median", "meamed"):
        center = _median_sorted(S, wa)
    else:
        center = _trimmed_sorted(S, f, wa)
    if op in ("median", "trimmed_mean"):
        return center
    ka = max(wa - f, 1) if isinstance(wa, int) else torch.clamp(wa - f, min=1)
    return mean_nearest(G, center, ka, active)


def coord_stat_plain(X: torch.Tensor, op: str, f: int = 1, *,
                     mask: torch.Tensor | None = None,
                     rows: torch.Tensor | None = None) -> torch.Tensor:
    """Coordinate-wise statistic over the workers of X: (W, N) -> (N,) fp32.

    Args:
      X: worker-major (W, N), fp32 or bf16 (computed in fp32).
      op: ``median`` | ``trimmed_mean`` | ``meamed`` | ``phocas``.
      f: assumed Byzantine count, clamped as the module docstring says.
      mask: optional (R,) membership; rows with mask 0 are left out and
        every position comes from the active count (a device tensor, never
        read on the host).
      rows: optional (R,) integer indices: the statistic runs over
        ``X[rows]`` in that order (worker r is ``X[rows[r]]``), read one
        column chunk at a time, never gathered whole.
    """
    if op not in COORD_OPS:
        raise ValueError(f"unknown op {op!r}; have {COORD_OPS}")
    R = X.shape[0] if rows is None else rows.numel()
    if rows is not None:
        rows = rows.to(device=X.device, dtype=torch.long)
    active, wa = None, R
    if mask is not None:
        if mask.shape != (R,):
            raise ValueError(f"mask must have shape ({R},), got "
                             f"{tuple(mask.shape)}")
        active = mask.to(X.device) != 0
        wa = torch.clamp(active.sum(), min=1)
    n = X.shape[1]
    out = torch.empty(n, dtype=torch.float32, device=X.device)
    for c0 in range(0, n, CHUNK):
        G = X[:, c0:c0 + CHUNK]
        if rows is not None:
            G = G.index_select(0, rows)
        out[c0:c0 + CHUNK] = _stat_chunk(G.float(), op, f, active, wa)
    return out


# ---------------------------------------------------------------------------
# (W, W) distance selections (Krum, Bulyan)
# ---------------------------------------------------------------------------

def _k_smallest_sums(D: torch.Tensor, k: int) -> torch.Tensor:
    """Per row, the sum of its k smallest entries, sequential ascending."""
    S = torch.sort(D, dim=1).values
    acc = torch.zeros(D.shape[0], dtype=torch.float32, device=D.device)
    for r in range(k):
        acc = acc + S[:, r]
    return acc


def krum_scores_plain(D2: torch.Tensor, f: int) -> torch.Tensor:
    """Krum score per worker: the sum of its k = max(p - f - 2, 1) smallest
    squared distances to the others (self excluded), ascending.  (p, p) ->
    (p,) fp32."""
    p = D2.shape[0]
    k = max(p - f - 2, 1)
    eye = torch.eye(p, dtype=torch.bool, device=D2.device)
    return _k_smallest_sums(torch.where(eye, _INF, D2.float()), k)


def bulyan_select_plain(D2: torch.Tensor, f: int) -> torch.Tensor:
    """Bulyan's recursive Multi-Krum selection: theta = max(p - 2f, 1)
    workers, lowest Krum score first; (theta,) int32 in selection order.

    Picked workers stay in every later round's sums as the finite
    ``big = 4 max(off-diagonal D2) + 1`` (the same count in every row, so
    the real part decides); the argmin takes the lowest index on ties.
    ``big`` is taken over the off-diagonal entries, as the TPU kernel takes
    it; the JAX reference takes all entries, which is the same for squared
    distances (zero diagonal).
    """
    p = D2.shape[0]
    theta = max(p - 2 * f, 1)
    k = max(p - f - 2, 1)
    D2 = D2.float()
    dev = D2.device
    eye = torch.eye(p, dtype=torch.bool, device=dev)
    big = 4.0 * torch.where(eye, 0.0, D2).max() + 1.0
    ids = torch.arange(p, device=dev)
    avail = torch.ones(p, dtype=torch.bool, device=dev)
    picks = []
    for _ in range(theta):
        D = torch.where(avail[None, :], D2, big)
        s = _k_smallest_sums(torch.where(eye, _INF, D), k)
        pick = torch.argmin(torch.where(avail, s, _INF))
        picks.append(pick)
        avail = avail & (ids != pick)
    return torch.stack(picks).to(torch.int32)
