"""Worker->server gradient codecs on the worker-major (W, N) buffer.

Port of ``repro/comm/compressors.py``.  The JAX codecs act on a pytree of
``(W, ...)`` leaves; here the gradients are one (W, N) buffer whose columns
follow the canonical leaf order of :mod:`repro_torch.weights`, so a codec
acts **per leaf of a** :class:`~repro_torch.weights.Layout`: leaf ``i``
is the column block ``X[:, o:o + n]`` with per-worker shape ``shape``
(``layout.offsets[i]``, ``layout.sizes[i]``, ``layout.shapes[i]``).

The per-leaf primitives take any number of rows of a leaf, ``(R, n)``,
so the error-feedback round (:mod:`repro_torch.comm.error_feedback`) can
run one worker row of one leaf at a time and keep its temporaries at one
row of the largest leaf:

* ``encode_leaf(M, i, shape)`` -> the payload of those rows;
* ``decode_leaf(payload, i, shape, out)`` writes the (R, n) estimate into
  ``out`` (which may be the rows ``M`` came from).

``encode`` / ``decode`` run them over every leaf and every row.  Every
codec declares its cost model (``bits``), an exact static count:

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

import torch

from repro_torch.weights import Layout

__all__ = ["CommConfig", "Codec", "CODECS", "get_codec", "dense_bits",
           "majority_vote", "leaf_blocks"]


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

    def leaf_bits(self, n, shape):
        return 32.0 * n


def _trailing(shape: tuple) -> int:
    return shape[-1] if shape else 1


class SignSGDCodec(Codec):
    """signSGD: the sign of every coordinate (int8 on the wire model's 1
    bit) and one fp32 scale, the mean |g| over each trailing row of the
    leaf's shape, per worker.  The decode ``scale * sign`` keeps every
    row's l1 mass (the scaled-sign variant whose EF form converges).  The
    ``ffn.down`` leaf of smollm-360m, (32, 2560, 960), has 81,920 scales a
    worker."""

    name = "signsgd"
    biased = True

    def encode_leaf(self, M, i, shape):
        last = _trailing(shape)
        rows = M.reshape(M.shape[0], -1, last)
        return {"sign": torch.sign(M).to(torch.int8),
                "scale": rows.abs().mean(dim=-1)}

    def decode_leaf(self, payload, i, shape, out):
        last = _trailing(shape)
        R = out.shape[0]
        torch.mul(payload["sign"].reshape(R, -1, last),
                  payload["scale"][..., None], out=out.view(R, -1, last))
        return out

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

    The decode does not depend on the pairs' order (``sorted=False``).
    Exactly equal |g| at the k-th place may be kept in another choice than
    ``lax.top_k``'s; equal values decode alike (the zero rows of an
    embedding gradient), a tie of +a and -a does not."""

    name = "topk"
    biased = True

    def __init__(self, density: float):
        if not 0.0 < density <= 1.0:
            raise ValueError(f"topk density must be in (0, 1], got {density}")
        self.density = density

    def _k(self, n: int) -> int:
        return _ratio_k(self.density, n)

    def encode_leaf(self, M, i, shape):
        k = self._k(M.shape[1])
        idx = torch.topk(M.abs(), k, dim=1, sorted=False).indices
        return {"idx": idx, "val": torch.gather(M, 1, idx)}

    def decode_leaf(self, payload, i, shape, out):
        return out.zero_().scatter_(1, payload["idx"], payload["val"])

    def leaf_bits(self, n, shape):
        return float(self._k(n) * (32 + max(1, math.ceil(math.log2(n)))))


def _slot_table(bucket: torch.Tensor, k: int) -> torch.Tensor:
    """The (L, k) slot table of ``bucket`` (int64, (n,)): entry (r, b) is
    the index of bucket b's r-th coordinate in ascending order, or n
    where the bucket has fewer."""
    n = bucket.numel()
    order = torch.argsort(bucket, stable=True)
    counts = torch.bincount(bucket, minlength=k)
    starts = torch.cumsum(counts, 0) - counts
    sorted_bucket = bucket[order]
    rank = torch.arange(n, device=order.device) - starts[sorted_bucket]
    table = torch.full((int(counts.max()), k), n, dtype=torch.int32,
                       device=order.device)
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
    card): build one codec and keep it across steps.

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
        """(sign int8, slot table) of the leaf's coordinates [lo, hi) on
        ``device``: the leaf's maps drawn whole on the CPU, cut to the
        range, and the range's own slot table over local indices (drawn
        and built at the first call, then kept)."""
        key = ("shard", n, leaf_idx, lo, hi, str(torch.device(device)))
        if key not in self._device_maps:
            bucket, sign = self._maps(n, leaf_idx)
            self._device_maps[key] = (
                sign[lo:hi].to(device),
                _slot_table(bucket[lo:hi].long().to(device), self._k(n)))
        return self._device_maps[key]

    def encode_leaf(self, M, i, shape, out=None):
        """The (R, k) sketch of M's rows; written into ``out`` if given."""
        n, k = M.shape[1], self._k(M.shape[1])
        _, sign = self.maps(n, i, M.device)
        table = self.slots(n, i, M.device)
        if out is None:
            out = torch.empty((M.shape[0], k), dtype=torch.float32,
                              device=M.device)
        return _encode_rows(M, sign, table, out)

    def sketch_shard(self, Xs: torch.Tensor, shards, s: int) -> torch.Tensor:
        """Shard ``s``'s part of the payload: the (W, sum_i k_i) sketch of
        this rank's coordinate-shard buffer ``Xs`` (layout ``shards``, a
        ``repro_torch.dist.sharding.CoordShards``), each leaf's columns
        bucketed by the leaf's own maps.  The sketch is linear, so the sum
        of every shard's part is the whole payload of :meth:`sketch` (up
        to fp32 reassociation within a bucket)."""
        ks = [self._k(n) for n in shards.sizes]
        P = torch.zeros((Xs.shape[0], sum(ks)), dtype=torch.float32,
                        device=Xs.device)
        ko = 0
        for (i, off, lo, hi), n, k in zip(shards.cols(s), shards.sizes, ks):
            if hi > lo:
                sign, table = self.shard_maps(n, i, lo, hi, Xs.device)
                _encode_rows(Xs[:, off:off + hi - lo], sign, table,
                             P[:, ko:ko + k])
            ko += k
        return P

    def decode_leaf(self, payload, i, shape, out):
        bucket, sign = self.maps(out.shape[1], i, out.device)
        return torch.mul(payload.index_select(1, bucket), sign, out=out)

    def leaf_bits(self, n, shape):
        return 32.0 * self._k(n)

    def sketch(self, X: torch.Tensor, layout: Layout) -> torch.Tensor:
        """The whole payload as one (W, sum_i k_i) fp32 buffer of per-leaf
        column blocks, encoded one worker row of one leaf at a time (the
        temporary is one row of a leaf, never a (W, n) block)."""
        ks = [self._k(n) for n in layout.sizes]
        P = torch.empty((X.shape[0], sum(ks)), dtype=torch.float32,
                        device=X.device)
        ko = 0
        for (i, o, n, shape), k in zip(leaf_blocks(layout), ks):
            for w in range(X.shape[0]):
                self.encode_leaf(X[w:w + 1, o:o + n], i, shape,
                                 out=P[w:w + 1, ko:ko + k])
            ko += k
        return P

    def encode(self, X, layout):
        P = self.sketch(X, layout)
        blocks, ko = [], 0
        for n in layout.sizes:
            k = self._k(n)
            blocks.append(P[:, ko:ko + k])
            ko += k
        return blocks


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
