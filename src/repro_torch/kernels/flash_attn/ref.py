"""Plain PyTorch version of the flash-attention kernel (port of
``repro/kernels/flash_attn/ref.py``).

Softmax attention with fp32 scores, the finite ``NEG`` mask value, the
probabilities multiplied by the mask (a fully masked row gives 0, not NaN)
and queries aligned to the tail of the keys: query i sits at absolute
position ``i + sk - sq``, so the same function serves a square prefill,
a chunked-prefill tail (sq < sk) and one decode query (sq = 1).

Beyond the JAX reference, k and v may carry fewer heads than q (GQA):
``KV`` heads with ``H % KV == 0``, query head h reading KV head
``h // (H // KV)``.  With ``KV == H`` this is exactly the JAX function;
with ``KV < H`` it equals it on k and v repeated ``H // KV`` times, which
is what the JAX package's ``attend`` hands its kernel.  The sum ``p @ v``
is normalised at the end, as the kernels do it (the JAX reference divides
``p`` first: the same value up to fp32 rounding).  Plain tensor code, so
it has autograd: the port's training forward runs it as
``models.attention.attend``.
"""

from __future__ import annotations

import torch

NEG = -1e30


def attention_mask(seq_q: int, seq_k: int, *, causal: bool,
                   window: int | None, device=None) -> torch.Tensor:
    """(seq_q, seq_k) boolean mask.  Query i sits at absolute position
    i + (seq_k - seq_q) (decode convention: queries are the tail)."""
    row = torch.arange(seq_q, device=device)[:, None] + (seq_k - seq_q)
    col = torch.arange(seq_k, device=device)[None, :]
    mask = torch.ones((seq_q, seq_k), dtype=torch.bool, device=device)
    if causal:
        mask &= col <= row
    if window is not None:
        mask &= col > row - window
    return mask


def flash_attn_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, window: int | None = None,
                     scale: float | None = None) -> torch.Tensor:
    """q: (b, H, sq, d), k/v: (b, KV, sk, d) -> (b, H, sq, d) in q.dtype."""
    b, H, sq, d = q.shape
    KV, sk = k.shape[1], k.shape[2]
    if H % KV:
        raise ValueError(f"flash_attn_plain: {H} query heads are not a "
                         f"multiple of {KV} KV heads")
    scale = scale if scale is not None else d ** -0.5
    qg = q.reshape(b, KV, H // KV, sq, d).float()
    s = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2)) * scale
    mask = attention_mask(sq, sk, causal=causal, window=window,
                          device=q.device)
    s = torch.where(mask, s, torch.full_like(s, NEG))
    p = torch.exp(s - s.amax(dim=-1, keepdim=True)) * mask
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.float()[:, :, None])
    o = torch.where(l > 0, o / torch.clamp(l, min=1e-30), torch.zeros_like(o))
    return o.reshape(b, H, sq, d).to(q.dtype)
