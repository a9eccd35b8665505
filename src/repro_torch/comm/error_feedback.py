"""Error feedback (EF) memory for biased gradient compression.

Port of ``repro/comm/error_feedback.py``.  Every worker remembers what the
codec dropped and adds it back next round:

    h_t      = g_t + e_t
    payload  = encode(h_t)
    e_{t+1}  = h_t - decode(payload)

The memory has the layout of the gradient buffer it goes with: one
worker-major (W, N) fp32 buffer on one device, or under sharded
aggregation the rank's (W, width) coordinate shard of it
(``repro_torch.dist.sharding.CoordShards``).  At smollm-360m's width with
W = 15 the whole buffer is 21.7 GB, so :func:`ef_round` runs **in place**
on the gradient buffer X and the memory E, leaf range by leaf range:

  1. ``X += E``: X holds h;
  2. the codec's encode of every range, with its one cross-rank step
     (``Codec.encode_range``; none on one device);
  3. per range: ``E <- X`` on active rows, decode into X in place,
     ``E -= X`` on active rows, which leaves ``h - decoded``.

Temporaries stay at a block of rows of one leaf range
(``compressors.row_blocks``), where JAX's ``h``, ``decoded`` and
``new_ef`` would be three more (W, N) buffers.  The one-device round and
a rank's are the same code: only ``reduce`` differs.
"""

from __future__ import annotations

import torch

from repro_torch.comm.compressors import (Codec, leaf_cols, no_reduce,
                                          row_blocks)
from repro_torch.weights import Layout

__all__ = ["init_ef", "ef_round", "ef_encode_decode"]


def init_ef(params: torch.Tensor, workers: int,
            width: int | None = None) -> torch.Tensor:
    """Zero EF memory on the device of the flat (N,) parameter vector
    ``params``: (workers, N) fp32, or (workers, width) for a rank's
    coordinate shard of width ``width``."""
    return torch.zeros((workers, params.numel() if width is None else width),
                       dtype=torch.float32, device=params.device)


def ef_round(codec: Codec, X: torch.Tensor, cols: list,
             ef: torch.Tensor | None = None,
             mask: torch.Tensor | None = None, reduce=no_reduce):
    """One EF round over the leaf ranges ``cols`` (``compressors.
    LeafCols``) of the worker-major fp32 buffer ``X``, in place.

    Args:
      codec: the active compressor.
      X: (W, width) gradients; on return the ranges hold the decoded
        estimates the aggregator consumes (columns outside every range,
        a shard's padding, are left as they are).
      cols: the leaf ranges X holds (``compressors.leaf_cols``).
      ef: the EF memory, X's shape, updated in place, or ``None`` to run
        the codec without compensation.
      mask: optional (W,) active-worker membership (0/1) on X's device.
        An inactive worker transmits nothing this round: its memory is
        frozen (bit-equal) and resumes when it rejoins.  Its row of X is
        still decoded, as in the JAX package.
      reduce: ``reduce(t, kind)``, an in-place sum over the ranks that
        hold the other ranges of the same leaves
        (``repro_torch.dist.sharded.all_reduce_``), or :func:`compressors.
        no_reduce` when X holds every leaf whole.
    Returns:
      ``(X, ef)``, the same tensors.
    """
    keep = None if mask is None else mask.to(X.device).bool()[:, None]
    with torch.no_grad():
        if ef is not None:
            X.add_(ef)
        payload = codec.encode_range(X, cols, reduce)
        for c, p in zip(cols, payload):
            x = X[:, c.off:c.off + c.hi - c.lo]
            if ef is None:
                codec.decode_range(p, x, c)
                continue
            e = ef[:, c.off:c.off + c.hi - c.lo]
            if keep is None:
                e.copy_(x)
                codec.decode_range(p, x, c)
                e.sub_(x)
                continue
            torch.where(keep, x, e, out=e)
            codec.decode_range(p, x, c)
            for r0, r1 in row_blocks(X.shape[0], x.shape[1]):
                eb = e[r0:r1]
                torch.where(keep[r0:r1], eb - x[r0:r1], eb, out=eb)
    return X, ef


def ef_encode_decode(codec: Codec, X: torch.Tensor, layout: Layout,
                     ef: torch.Tensor | None = None,
                     mask: torch.Tensor | None = None):
    """:func:`ef_round` on one device: ``X`` and ``ef`` are (W, N), every
    leaf of ``layout`` whole.  Returns ``(X, ef)``."""
    return ef_round(codec, X, leaf_cols(layout), ef, mask)
