"""Error feedback (EF) memory for biased gradient compression.

Port of ``repro/comm/error_feedback.py``.  Every worker remembers what the
codec dropped and adds it back next round:

    h_t      = g_t + e_t
    payload  = encode(h_t)
    e_{t+1}  = h_t - decode(payload)

The memory is one worker-major (W, N) fp32 buffer, the same layout as the
gradient buffer.  At smollm-360m's width with W = 15 each is 21.7 GB, so
the round runs **in place** on the two of them, one worker row of one
leaf at a time (``X[w, o:o + n]`` is contiguous):

  1. ``X += E``: X holds h;
  2. encode X (the payload of one row of one leaf);
  3. ``E <- X`` on active rows;
  4. decode into X in place;
  5. ``E -= X`` on active rows, which leaves ``h - decoded``.

Temporaries stay at one row of the largest leaf (78.6 M entries at full
width), where JAX's ``h``, ``decoded`` and ``new_ef`` would be three more
(W, N) buffers.
"""

from __future__ import annotations

import torch

from repro_torch.comm.compressors import Codec, leaf_blocks
from repro_torch.weights import Layout

__all__ = ["init_ef", "ef_encode_decode"]


def init_ef(params: torch.Tensor, workers: int) -> torch.Tensor:
    """Zero EF memory: (workers, N) fp32 on the device of the flat (N,)
    parameter vector ``params``."""
    return torch.zeros((workers, params.numel()), dtype=torch.float32,
                       device=params.device)


def ef_encode_decode(codec: Codec, X: torch.Tensor, layout: Layout,
                     ef: torch.Tensor | None = None,
                     mask: torch.Tensor | None = None):
    """One EF round over the (W, N) fp32 buffer ``X``, in place.

    Args:
      codec: the active compressor.
      X: worker-major gradients; on return they are the decoded estimates
        the aggregator consumes.
      layout: the per-worker leaf layout of X's columns.
      ef: the EF memory of :func:`init_ef`, updated in place, or ``None``
        to run the codec without compensation.
      mask: optional (W,) active-worker membership (0/1) on X's device.
        An inactive worker transmits nothing this round: its memory is
        frozen (bit-equal) and resumes when it rejoins.  Its row of X is
        still decoded, as in the JAX package.
    Returns:
      ``(X, ef)``, the same tensors.
    """
    keep = None if mask is None else mask.to(X.device).bool()
    with torch.no_grad():
        for i, o, n, shape in leaf_blocks(layout):
            for w in range(X.shape[0]):
                x = X[w:w + 1, o:o + n]
                if ef is None:
                    codec.decode_leaf(codec.encode_leaf(x, i, shape), i,
                                      shape, out=x)
                    continue
                e = ef[w:w + 1, o:o + n]
                x.add_(e)
                payload = codec.encode_leaf(x, i, shape)
                if keep is None:
                    e.copy_(x)
                    codec.decode_leaf(payload, i, shape, out=x)
                    e.sub_(x)
                else:
                    torch.where(keep[w], x, e, out=e)
                    codec.decode_leaf(payload, i, shape, out=x)
                    torch.where(keep[w], e - x, e, out=e)
    return X, ef
