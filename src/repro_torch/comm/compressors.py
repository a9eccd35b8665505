"""Worker->server gradient codecs on the worker-major (W, N) buffer.

Port of ``repro/comm/compressors.py``.  The JAX codecs act on a pytree of
``(W, ...)`` leaves; here the gradients are one (W, N) buffer whose columns
follow the canonical leaf order of :mod:`repro_torch.weights`, so a codec
acts **per leaf of a** :class:`~repro_torch.weights.Layout`: leaf ``i``
is the column block ``X[:, o:o + n]`` with per-worker shape ``shape``
(``layout.offsets[i]``, ``layout.sizes[i]``, ``layout.shapes[i]``).

Two sets of primitives:

* the payload of any rows of a whole leaf, ``(R, n)``:
  ``encode_leaf(M, i, shape)`` (CountSketch: ``sketch`` of the whole
  buffer) and ``decode_leaf(payload, i, shape, out)``; ``encode`` /
  ``decode`` run them over every leaf (the JAX package's payloads, for
  telemetry and the majority vote);
* the **range** primitives of the error-feedback round (:mod:`repro_torch.
  comm.error_feedback`), which act on a buffer holding coordinates ``[lo,
  hi)`` of each leaf (:class:`LeafCols`; the whole leaf on one device, a
  rank's coordinate shard under sharded aggregation):
  ``encode_range(X, cols, reduce)`` runs the codec's one cross-rank step
  through ``reduce(t, kind)`` (an in-place sum over the ranks, the
  identity on one device) and returns what each leaf's decode needs;
  ``decode_range(p, x, c)`` writes the estimate of leaf range ``c`` over
  ``x`` in place.  The ranks' decodes together equal the one-device
  decode of the whole leaf: identity has no cross-rank step; signSGD
  sums the ranks' parts of each trailing row a shard boundary cuts (one
  ``all_reduce`` of every leaf's scales); top-k finds each row's
  threshold bit by bit from counts summed over the ranks
  (:func:`topk_threshold`); CountSketch sums the ranks' partial
  sketches (it is linear).  Temporaries stay at a block of rows of one
  leaf range (``row_blocks``).

Every codec declares its cost model (``bits``), an exact static count:

  identity     the payload is the gradient; 32 bits a coordinate.
  signsgd      1 bit a coordinate plus one fp32 scale (mean |g|) per
               trailing row of each leaf's shape; biased.
  topk         per leaf the k = round(density n) largest |g| of a worker
               as (index, value) pairs; 32 + ceil(log2 n) bits a kept
               coordinate; biased.
  countsketch  each leaf's coordinates hashed into k = round(ratio n)
               signed buckets; 32 bits a bucket.  Sketch inner products
               estimate gradient inner products without bias, so the
               sketch can feed the Gram path without a decode
               (``gram_feed``).

All counts are per step over all W workers, as in the JAX package.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import NamedTuple

import torch

from repro_torch.analysis.trace import allowed
from repro_torch.weights import Layout

__all__ = ["CommConfig", "Codec", "CODECS", "get_codec", "dense_bits",
           "majority_vote", "leaf_blocks", "LeafCols", "leaf_cols",
           "row_blocks", "topk_threshold", "topk_kept", "no_reduce"]


@dataclass(frozen=True)
class CommConfig:
    """Worker->server compression settings.

    ``codec`` names a registry entry (``"none"`` disables compression);
    ``error_feedback`` of ``None`` resolves to the codec's default (biased
    codecs that cannot feed the Gram path get EF); ``topk_density`` is the
    kept fraction of each leaf's coordinates; ``sketch_ratio`` is the
    CountSketch bucket count as a fraction of each leaf's coordinates;
    ``seed`` fixes the sketch's bucket and sign maps.
    """

    codec: str = "none"
    error_feedback: bool | None = None
    topk_density: float = 1.0 / 16.0
    sketch_ratio: float = 1.0 / 16.0
    seed: int = 0

    @property
    def wants_ef(self) -> bool:
        """Resolved error-feedback switch (None -> the codec's default)."""
        if self.codec == "none":
            return False
        codec = get_codec(self)
        if self.error_feedback is None:
            return codec.biased and not codec.gram_feed
        return self.error_feedback


def leaf_blocks(layout: Layout):
    """``(i, offset, n, shape)`` of every leaf, in buffer order."""
    return zip(range(len(layout.sizes)), layout.offsets, layout.sizes,
               layout.shapes)


class LeafCols(NamedTuple):
    """Coordinates ``[lo, hi)`` of leaf ``i`` (``n`` coordinates a worker,
    per-worker ``shape``), held at columns ``[off, off + hi - lo)`` of a
    worker-major buffer."""

    i: int
    off: int
    lo: int
    hi: int
    n: int
    shape: tuple


def leaf_cols(layout: Layout, shards=None, s: int = 0) -> list[LeafCols]:
    """Every leaf's :class:`LeafCols`: the whole leaf at its offset of the
    (W, N) buffer, or with ``shards`` (a ``repro_torch.dist.sharding.
    CoordShards`` of ``layout.sizes``) shard ``s``'s range in its
    (W, width) buffer."""
    if shards is None:
        return [LeafCols(i, o, 0, n, n, shape)
                for i, o, n, shape in leaf_blocks(layout)]
    return [LeafCols(i, off, lo, hi, n, shape) for (i, off, lo, hi), n, shape
            in zip(shards.cols(s), layout.sizes, layout.shapes)]


# elements of a codec temporary: the range primitives take a leaf's rows
# in blocks of about this many (at least one row)
TEMP_ELEMENTS = 1 << 25


def row_blocks(rows: int, n: int) -> list[tuple[int, int]]:
    """``[(r0, r1), ...]`` covering ``rows`` rows of ``n`` columns, each
    block ~TEMP_ELEMENTS elements or one row."""
    b = max(1, TEMP_ELEMENTS // max(n, 1))
    return [(r, min(r + b, rows)) for r in range(0, rows, b)]


def no_reduce(t: torch.Tensor, kind: str) -> torch.Tensor:
    """The ``reduce`` of one device: the sum over one rank is ``t``."""
    return t


def topk_threshold(h: torch.Tensor, k: int, n: int, offset: int = 0,
                   reduce=no_reduce):
    """The kept set of magnitude top-k, as ``lax.top_k`` keeps it: every
    coordinate with |h| > t, t the k-th largest |h| of the row, then those
    with |h| == t, lowest index first, until there are k.

    ``h`` is (R, m): rows of a leaf of ``n`` coordinates, or the part
    ``[offset, offset + m)`` of each that this rank holds; ``reduce(t,
    kind)`` sums an int64 tensor over the ranks in place (kind
    ``"topk_select"``; :func:`no_reduce` on one device).  Every rank
    calls it with its part, the same ``k`` and ``n`` (an empty part too),
    and gets the same result.

    1. Each rank takes its rows' min(k, m) largest |h| (``torch.topk``).
       Their union over the ranks holds every |h| above the row's k-th
       largest t and at least as many copies of t as the row keeps, so t
       is the union's k-th largest.
    2. t bit by bit, from the top of |h|'s fp32 pattern (for non-negative
       floats the int32 order is the float order): a bit stays set where
       the union still counts >= k values at or above it; each of the 31
       steps counts by binary search in the sorted local values and sums
       a (R,) count over the ranks.
    3. Only where a row must keep some of its ties and not all: the index
       of the last kept tie, bit by bit over the global index
       ((n - 1).bit_length() steps), from the running count of ties along
       this rank's part of the row.

    Returns ``(t, cut)``, (R,) each: t as int32 bits and the highest
    global index of a kept tie (:func:`topk_kept`).  No row is read on
    the host; the one host read is whether any row needs step 3, the same
    on every rank."""
    R, m = h.shape
    dev = h.device
    blocks = row_blocks(R, m)
    # step 1, negated so that the values ascend (searchsorted)
    neg = torch.empty((R, min(k, m)), dtype=torch.float32, device=dev)
    for r0, r1 in blocks:
        torch.neg(torch.topk(h[r0:r1].abs(), neg.shape[1], dim=1).values,
                  out=neg[r0:r1])

    def count(bits, right: bool):
        """The union's count of |h| >= (right) or > the float of bits."""
        q = bits.view(torch.float32).neg()[:, None]
        return reduce(torch.searchsorted(neg, q, right=right)[:, 0],
                      "topk_select")

    t = torch.zeros((R,), dtype=torch.int32, device=dev)
    for b in range(30, -1, -1):
        cand = t | (1 << b)
        t = torch.where(count(cand, True) >= k, cand, t)
    need = k - count(t, False)          # the ties each row keeps
    ties = torch.zeros((R,), dtype=torch.int64, device=dev)
    for r0, r1 in blocks:
        ties[r0:r1] = (h[r0:r1].abs().view(torch.int32)
                       == t[r0:r1, None]).sum(1)
    cut = torch.full((R,), n, dtype=torch.int64, device=dev)
    with allowed("transfer", "top-k's one host read: whether any row must "
                 "cut its ties (the same on every rank): ROADMAP perf item 1"):
        cut_ties = bool((need < reduce(ties, "topk_select")).any())
    if not cut_ties:
        return t, cut
    # step 3: below[r, j] = this rank's ties of row r before local j + 1
    below = torch.empty((R, m), dtype=torch.int32, device=dev)
    for r0, r1 in blocks:
        torch.cumsum(h[r0:r1].abs().view(torch.int32) == t[r0:r1, None],
                     dim=1, dtype=torch.int32, out=below[r0:r1])
    rows = torch.arange(R, device=dev)
    cut.zero_()
    for b in range(max(n - 1, 0).bit_length() - 1, -1, -1):
        cand = cut | (1 << b)
        j = (cand - offset).clamp(0, m)
        before = (torch.where(j > 0, below[rows, (j - 1).clamp(min=0)], 0)
                  if m else torch.zeros_like(j))
        cut = torch.where(reduce(before.long(), "topk_select") < need,
                          cand, cut)
    return t, cut


def topk_kept(h: torch.Tensor, t: torch.Tensor, cut: torch.Tensor,
              offset: int = 0) -> torch.Tensor:
    """(R, m) bool: the coordinates of ``h`` (global ``[offset, offset +
    m)``) that :func:`topk_threshold`'s ``(t, cut)`` keeps."""
    b = h.abs().view(torch.int32)
    g = torch.arange(offset, offset + h.shape[1], device=h.device)
    return (b > t[:, None]) | ((b == t[:, None]) & (g[None, :]
                                                     <= cut[:, None]))


def _ratio_k(ratio: float, n: int) -> int:
    """JAX's ``max(1, min(n, round(ratio * n)))``; Python's ``round``
    rounds half to even (``round(0.5) == 0``, so an 8-wide leaf at 1/16
    keeps 1)."""
    return max(1, min(n, round(ratio * n)))


class Codec:
    """Base codec: ``decode(encode(X))`` approximates X.

    Attributes:
      name: registry name.
      biased: True when ``E[decode(encode(g))] != g``; such codecs need
        error feedback to converge.
      gram_feed: True when the payload rows' inner products estimate the
        gradients' (CountSketch), so the payload can feed ``tree_gram``.
    """

    name: str = "?"
    biased: bool = False
    gram_feed: bool = False

    def encode_leaf(self, M: torch.Tensor, i: int, shape: tuple):
        """(R, n) fp32 rows of leaf ``i`` -> their payload."""
        raise NotImplementedError

    def decode_leaf(self, payload, i: int, shape: tuple,
                    out: torch.Tensor) -> torch.Tensor:
        """Write the (R, n) estimate of ``payload`` into ``out``."""
        raise NotImplementedError

    def encode_range(self, X: torch.Tensor, cols: list,
                     reduce=no_reduce) -> list:
        """The leaf ranges ``cols`` of the (W, width) buffer ``X`` -> per
        range what :meth:`decode_range` needs, after the codec's one
        cross-rank step through ``reduce`` (module docstring)."""
        raise NotImplementedError

    def decode_range(self, p, x: torch.Tensor, c: LeafCols) -> None:
        """Overwrite ``x``, the (W, hi - lo) columns of range ``c`` that
        :meth:`encode_range` read, with their estimate."""
        raise NotImplementedError

    def leaf_bits(self, n: int, shape: tuple) -> float:
        """Payload bits of one worker's leaf of n coordinates."""
        raise NotImplementedError

    def encode(self, X: torch.Tensor, layout: Layout) -> list:
        """Worker-major (W, N) buffer -> one payload per leaf (all rows)."""
        return [self.encode_leaf(X[:, o:o + n], i, shape)
                for i, o, n, shape in leaf_blocks(layout)]

    def decode(self, payload: list, layout: Layout,
               out: torch.Tensor) -> torch.Tensor:
        """Payloads of :meth:`encode` -> the (W, N) estimate, in ``out``."""
        for p, (i, o, n, shape) in zip(payload, leaf_blocks(layout)):
            self.decode_leaf(p, i, shape, out[:, o:o + n])
        return out

    def bits(self, layout: Layout, workers: int) -> float:
        """Total payload bits per step across ``workers`` workers."""
        return float(workers * sum(self.leaf_bits(n, shape)
                                   for _, _, n, shape in leaf_blocks(layout)))


def dense_bits(layout: Layout, workers: int) -> float:
    """Uncompressed worker->server bits per step, fp32 gradients (the
    comm_ratio base)."""
    return float(workers * layout.numel * 32)


class IdentityCodec(Codec):
    """Reference no-op codec: the payload is the gradient itself."""

    name = "identity"

    def encode_leaf(self, M, i, shape):
        return M

    def decode_leaf(self, payload, i, shape, out):
        return out.copy_(payload)

    def encode_range(self, X, cols, reduce=no_reduce):
        return [None] * len(cols)

    def decode_range(self, p, x, c):
        return None                     # x is its own estimate

    def leaf_bits(self, n, shape):
        return 32.0 * n


def _trailing(shape: tuple) -> int:
    return shape[-1] if shape else 1


def _row_segments(lo: int, hi: int, last: int) -> list[tuple]:
    """The trailing rows (``last`` wide) that coordinates [lo, hi) touch,
    as ``(a, b, row, rows)``: coordinates [a, b) are ``rows`` whole rows
    from ``row`` on, or (``rows`` == 1) a part of row ``row`` cut by lo
    or hi."""
    out, a = [], lo
    if a < hi and a % last:
        b = min(hi, (a // last + 1) * last)
        out.append((a, b, a // last, 1))
        a = b
    full = (hi - a) // last
    if full:
        out.append((a, a + full * last, a // last, full))
        a += full * last
    if a < hi:
        out.append((a, hi, a // last, 1))
    return out


def _row_scale_parts(x: torch.Tensor, lo: int, hi: int, last: int,
                     out: torch.Tensor) -> None:
    """Write into ``out`` (W, rows of the leaf) this range's part of each
    trailing row's scale (``x``: the (W, hi - lo) columns of coordinates
    [lo, hi)): a row the range holds whole gets its mean |x|, one worker
    row at a time as ``mean`` over ``(1, rows, last)`` (the one-device
    scale, the JAX package's ``mean(|g|, axis=-1)``); a row cut by lo or
    hi gets the sum of |x| over its part (:func:`cut_rows`; the summed
    parts are divided by ``last``)."""
    for a, b, r, rows in _row_segments(lo, hi, last):
        seg = x[:, a - lo:b - lo]
        for w in range(x.shape[0]):
            part = seg[w:w + 1].abs().view(1, rows, (b - a) // rows)
            out[w, r:r + rows] = (part.mean(-1) if b - a == rows * last
                                  else part.sum(-1))[0]


def cut_rows(lo: int, hi: int, last: int) -> list[int]:
    """The trailing rows (``last`` wide) of which coordinates [lo, hi) hold
    a part but not the whole."""
    return [r for a, b, r, rows in _row_segments(lo, hi, last)
            if b - a != rows * last]


class SignSGDCodec(Codec):
    """signSGD: the sign of every coordinate (int8 on the wire model's 1
    bit) and one fp32 scale, the mean |g| over each trailing row of the
    leaf's shape, per worker.  The decode ``scale * sign`` keeps every
    row's l1 mass (the scaled-sign variant whose EF form converges).  The
    ``ffn.down`` leaf of smollm-360m, (32, 2560, 960), has 81,920 scales a
    worker.

    On a shard a trailing row can be cut between ranks.  Each rank writes
    into one (W, rows) buffer of every leaf's rows the mean of each row it
    holds whole and the sum of |g| over its part of each cut row, zeros
    elsewhere (:meth:`scale_parts`); one ``all_reduce`` (kind
    ``"signsgd_scale_all_reduce"``) finishes every cut row's sum, which
    the ranks holding a part of it divide by the row's length.  A row held
    whole gets the other ranks' 0.0 added: its scale is the mean its rank
    computed, as one device computes it."""

    name = "signsgd"
    biased = True

    def encode_leaf(self, M, i, shape):
        last = _trailing(shape)
        scale = torch.zeros((M.shape[0], M.shape[1] // last),
                            dtype=torch.float32, device=M.device)
        _row_scale_parts(M, 0, M.shape[1], last, scale)
        return {"sign": torch.sign(M).to(torch.int8), "scale": scale}

    def decode_leaf(self, payload, i, shape, out):
        last = _trailing(shape)
        R = out.shape[0]
        torch.mul(payload["sign"].reshape(R, -1, last),
                  payload["scale"][..., None], out=out.view(R, -1, last))
        return out

    def scale_parts(self, X, cols) -> tuple[torch.Tensor, list]:
        """``(S, scales)``: the (W, sum of the leaves' rows) buffer of this
        rank's parts of every scale (``_row_scale_parts``) and its column
        block of each leaf."""
        rows = [c.n // _trailing(c.shape) for c in cols]
        S = torch.zeros((X.shape[0], sum(rows)), dtype=torch.float32,
                        device=X.device)
        scales, ro = [], 0
        for c, nr in zip(cols, rows):
            scales.append(S[:, ro:ro + nr])
            _row_scale_parts(X[:, c.off:c.off + c.hi - c.lo], c.lo, c.hi,
                             _trailing(c.shape), scales[-1])
            ro += nr
        return S, scales

    def encode_range(self, X, cols, reduce=no_reduce):
        S, scales = self.scale_parts(X, cols)
        reduce(S, "signsgd_scale_all_reduce")
        for c, scale in zip(cols, scales):
            last = _trailing(c.shape)
            for r in cut_rows(c.lo, c.hi, last):
                scale[:, r].div_(last)
        return scales

    def decode_range(self, p, x, c):
        last = _trailing(c.shape)
        for a, b, r, rows in _row_segments(c.lo, c.hi, last):
            x[:, a - c.lo:b - c.lo].view(x.shape[0], rows, -1).sign_().mul_(
                p[:, r:r + rows, None])

    def leaf_bits(self, n, shape):
        return float(n + 32 * (n // _trailing(shape)))


def majority_vote(payload: list, layout: Layout) -> torch.Tensor:
    """signSGD-MV server decode: per leaf ``mean_w(scale_w) * sign(sum_w
    sign_w)`` (scales per trailing row) -> the (N,) aggregate.  A
    coordinate-wise median of signs: up to (W - 1) / 2 Byzantine workers
    cannot flip a coordinate the honest majority agrees on."""
    parts = []
    for p, (_, _, n, shape) in zip(payload, leaf_blocks(layout)):
        vote = torch.sign(p["sign"].float().sum(dim=0))
        scale = p["scale"].mean(dim=0)
        parts.append((scale[:, None] * vote.view(-1, _trailing(shape)))
                     .reshape(n))
    return torch.cat(parts)


class TopKCodec(Codec):
    """Magnitude top-k: per leaf and worker the k largest |g| as (index,
    value) pairs, k = max(1, min(n, round(density n))).  Cost model: a
    fp32 value and a ceil(log2 n)-bit index per kept coordinate (the tight
    count, a lower bound on any wire format).

    The kept set is ``lax.top_k``'s, ties at the k-th place included
    (lowest index first): :func:`topk_threshold`, on one device and on a
    shard alike (kind ``"topk_select"``).  The payload's indices are in
    ascending order."""

    name = "topk"
    biased = True

    def __init__(self, density: float):
        if not 0.0 < density <= 1.0:
            raise ValueError(f"topk density must be in (0, 1], got {density}")
        self.density = density

    def _k(self, n: int) -> int:
        return _ratio_k(self.density, n)

    def encode_leaf(self, M, i, shape):
        R, n = M.shape
        k = self._k(n)
        kept = topk_kept(M, *topk_threshold(M, k, n))
        with allowed("transfer", "nonzero sizes its result on the host "
                     "(k a row, known): ROADMAP perf item 1"):
            idx = kept.nonzero()[:, 1].view(R, k)
        return {"idx": idx, "val": torch.gather(M, 1, idx)}

    def decode_leaf(self, payload, i, shape, out):
        return out.zero_().scatter_(1, payload["idx"], payload["val"])

    def encode_range(self, X, cols, reduce=no_reduce):
        return [topk_threshold(X[:, c.off:c.off + c.hi - c.lo], self._k(c.n),
                               c.n, c.lo, reduce) for c in cols]

    def decode_range(self, p, x, c):
        t, cut = p
        for r0, r1 in row_blocks(x.shape[0], x.shape[1]):
            xb = x[r0:r1]
            xb.masked_fill_(topk_kept(xb, t[r0:r1], cut[r0:r1],
                                      c.lo).logical_not_(), 0.0)

    def leaf_bits(self, n, shape):
        return float(self._k(n) * (32 + max(1, math.ceil(math.log2(n)))))


def _slot_table(bucket: torch.Tensor, k: int) -> torch.Tensor:
    """The (L, k) slot table of ``bucket`` (int64, (n,)): entry (r, b) is
    the index of bucket b's r-th coordinate in ascending order, or n
    where the bucket has fewer."""
    n = bucket.numel()
    order = torch.argsort(bucket, stable=True)
    with allowed("transfer", "the slot table is sized on the host once a "
                 "leaf and device, then cached: later steps read nothing"):
        counts = torch.bincount(bucket, minlength=k)
        rows = int(counts.max())
    starts = torch.cumsum(counts, 0) - counts
    sorted_bucket = bucket[order]
    rank = torch.arange(n, device=order.device) - starts[sorted_bucket]
    table = torch.full((rows, k), n, dtype=torch.int32, device=order.device)
    table[rank, sorted_bucket] = order.int()
    return table


def _encode_rows(M, sign, table, out):
    """Sketch M's (R, n) rows into ``out`` (R, k) through the slot table:
    a gather and a reduction in a fixed order."""
    n = M.shape[1]
    v = torch.zeros(n + 1, dtype=torch.float32, device=M.device)
    for r in range(M.shape[0]):         # one row's temporaries at a time
        torch.mul(M[r], sign, out=v[:n])            # v[n] stays 0
        torch.sum(v.index_select(0, table.view(-1)).view(table.shape),
                  dim=0, out=out[r])
    return out


class CountSketchCodec(Codec):
    """CountSketch: coordinate j of a leaf adds ``sign[j] * g[j]`` to
    bucket ``bucket[j]`` of k = max(1, min(n, round(ratio n))).  Sketch
    inner products are unbiased estimates of the gradients' (``gram_feed``);
    the decode ``sign[j] * S[bucket[j]]`` is unbiased per coordinate with
    variance ~ ||g||^2 / k.

    The maps are fixed by ``seed`` and the leaf index, shared by all
    workers and steps.  They are drawn from a **CPU** ``torch.Generator``
    (bucket int32, sign int8), so a run on the card and one on the CPU
    sketch alike; they do not match ``jax.random``'s maps in the JAX
    package.  Each leaf's maps are drawn once and kept on the instance,
    per device (at smollm-360m's width 361.8 M entries, 1.8 GB on the
    card): build one codec and keep it across steps.  A rank holding a
    coordinate range of a leaf keeps that range's maps and slot table
    (:meth:`shard_maps`); the sketch is linear, so the sum over the ranks
    of their ranges' sketches (kind ``"sketch_all_reduce"``) is the whole
    sketch, and each rank decodes its range from it.

    **Deterministic encode.**  One ``index_add_`` of a whole row adds ~16
    values into each bucket with float atomics on CUDA, in an order that
    changes from run to run, so the sketch (and a run resumed from a
    checkpoint) would differ in its last bits.  The encode instead gathers
    the signed coordinates into a dense (L, k) *slot table*, entry (r, b)
    being bucket b's r-th coordinate in ascending order (a zero where the
    bucket has fewer; L the most coordinates any bucket has), and sums the
    table over its rows: a gather and a reduction in a fixed order, the
    same bits on every run.  The table's coordinate indices are computed
    once per leaf and kept with the maps (int32, L / 16 ~ 2.5 of them per
    coordinate, 3.6 GB at smollm-360m's width).
    """

    name = "countsketch"
    gram_feed = True

    def __init__(self, ratio: float, seed: int):
        if not 0.0 < ratio <= 1.0:
            raise ValueError(f"sketch ratio must be in (0, 1], got {ratio}")
        self.ratio = ratio
        self.seed = seed
        self._device_maps: dict = {}

    def _k(self, n: int) -> int:
        return _ratio_k(self.ratio, n)

    def _maps(self, n: int, leaf_idx: int):
        """(bucket int32 (n,), sign int8 (n,)) on the CPU, from the seed."""
        gen = torch.Generator().manual_seed(
            (int(self.seed) * 1_000_003 + int(leaf_idx)) % (2 ** 63))
        bucket = torch.randint(0, self._k(n), (n,), generator=gen,
                               dtype=torch.int32)
        sign = torch.randint(0, 2, (n,), generator=gen, dtype=torch.int8)
        return bucket, sign.mul_(2).sub_(1)

    def maps(self, n: int, leaf_idx: int, device) -> tuple:
        """Leaf ``leaf_idx``'s maps on ``device``, drawn at the first call."""
        key = (n, leaf_idx, str(torch.device(device)))
        if key not in self._device_maps:
            with allowed("transfer", "the sketch maps are drawn on the host "
                         "from the seed and uploaded once a leaf and device, "
                         "then cached: later steps copy nothing"):
                self._device_maps[key] = tuple(
                    t.to(device) for t in self._maps(n, leaf_idx))
        return self._device_maps[key]

    def slots(self, n: int, leaf_idx: int, device) -> torch.Tensor:
        """Leaf ``leaf_idx``'s (L, k) slot table on ``device``: entry (r, b)
        is the index of bucket b's r-th coordinate in ascending order, or n
        where the bucket has fewer (computed at the first call)."""
        key = ("slots", n, leaf_idx, str(torch.device(device)))
        if key not in self._device_maps:
            self._device_maps[key] = _slot_table(
                self.maps(n, leaf_idx, device)[0].long(), self._k(n))
        return self._device_maps[key]

    def shard_maps(self, n: int, leaf_idx: int, lo: int, hi: int, device):
        """(bucket int32, sign int8, slot table) of the leaf's coordinates
        [lo, hi) on ``device``: the whole leaf's (:meth:`maps`,
        :meth:`slots`), or the maps drawn whole on the CPU, cut to the
        range, and the range's own slot table over local indices (drawn
        and built at the first call, then kept)."""
        if (lo, hi) == (0, n):
            return (*self.maps(n, leaf_idx, device),
                    self.slots(n, leaf_idx, device))
        key = ("shard", n, leaf_idx, lo, hi, str(torch.device(device)))
        if key not in self._device_maps:
            bucket, sign = self._maps(n, leaf_idx)
            bucket = bucket[lo:hi].to(device)
            self._device_maps[key] = (
                bucket, sign[lo:hi].to(device),
                _slot_table(bucket.long(), self._k(n)))
        return self._device_maps[key]

    def sketch(self, X: torch.Tensor, layout: Layout) -> torch.Tensor:
        """The whole payload of the (W, N) buffer as one (W, sum_i k_i)
        fp32 buffer of per-leaf column blocks (:meth:`sketch_cols` of
        every leaf whole)."""
        return self.sketch_cols(X, leaf_cols(layout))

    def sketch_cols(self, X: torch.Tensor, cols: list) -> torch.Tensor:
        """The (W, sum_i k_i) fp32 sketch of the leaf ranges ``cols`` of
        ``X``, one column block per leaf, each range bucketed by its leaf's
        maps, encoded one worker row of one range at a time (the temporary
        is one row of a range).  The sum of every shard's is the whole
        payload, up to fp32 reassociation within a bucket."""
        ks = [self._k(c.n) for c in cols]
        P = torch.zeros((X.shape[0], sum(ks)), dtype=torch.float32,
                        device=X.device)
        ko = 0
        for c, k in zip(cols, ks):
            if c.hi > c.lo:
                _, sign, table = self.shard_maps(c.n, c.i, c.lo, c.hi,
                                                 X.device)
                _encode_rows(X[:, c.off:c.off + c.hi - c.lo], sign, table,
                             P[:, ko:ko + k])
            ko += k
        return P

    def decode_leaf(self, payload, i, shape, out):
        bucket, sign = self.maps(out.shape[1], i, out.device)
        return torch.mul(payload.index_select(1, bucket), sign, out=out)

    def encode_range(self, X, cols, reduce=no_reduce):
        P = reduce(self.sketch_cols(X, cols), "sketch_all_reduce")
        blocks, ko = [], 0
        for c in cols:
            k = self._k(c.n)
            blocks.append(P[:, ko:ko + k])
            ko += k
        return blocks

    def decode_range(self, p, x, c):
        if c.hi == c.lo:
            return
        bucket, sign, _ = self.shard_maps(c.n, c.i, c.lo, c.hi, x.device)
        for r0, r1 in row_blocks(x.shape[0], x.shape[1]):
            torch.mul(p[r0:r1].index_select(1, bucket), sign, out=x[r0:r1])

    def leaf_bits(self, n, shape):
        return 32.0 * self._k(n)

    def encode(self, X, layout):
        return self.encode_range(X, leaf_cols(layout))


CODECS = ("identity", "signsgd", "topk", "countsketch")


def get_codec(cfg: CommConfig) -> Codec | None:
    """Resolve a CommConfig to a codec instance (None for ``"none"``)."""
    if cfg.codec == "none":
        return None
    if cfg.codec == "identity":
        return IdentityCodec()
    if cfg.codec == "signsgd":
        return SignSGDCodec()
    if cfg.codec == "topk":
        return TopKCodec(cfg.topk_density)
    if cfg.codec == "countsketch":
        return CountSketchCodec(cfg.sketch_ratio, cfg.seed)
    raise KeyError(f"unknown codec {cfg.codec!r}; have "
                   f"{('none',) + CODECS}")
