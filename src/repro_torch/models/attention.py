"""GQA attention for the training forward (port of the dense path of
``repro/models/attention.py``).

``attend`` computes what the JAX package's ``xla_flash`` computes --
causal (and optionally sliding-window) softmax attention with fp32 scores,
the finite ``NEG`` mask value and queries aligned to the tail of the keys
-- as plain tensor code over the whole sequence.  At the training lengths
of this slice one key chunk covers the sequence, where ``xla_flash``'s
online softmax reduces to exactly this.
"""

from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig

NEG = -1e30


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           causal: bool = True, window: int | None = None,
           scale: float | None = None) -> torch.Tensor:
    """q: (B, H, Sq, D); k/v: (B, KV, Sk, D) -> (B, H, Sq, D) in q.dtype."""
    B, H, Sq, D = q.shape
    KV, Sk = k.shape[1], k.shape[2]
    G = H // KV
    scale = scale if scale is not None else D ** -0.5
    qg = q.reshape(B, KV, G, Sq, D).float()
    s = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2)) * scale
    row = (Sk - Sq) + torch.arange(Sq, device=q.device)[:, None]
    col = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= col <= row
    if window is not None:
        mask &= col > row - window
    s = torch.where(mask, s, torch.full_like(s, NEG))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * mask
    l = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p, v.float()[:, :, None])
    o = torch.where(l > 0, o / torch.clamp(l, min=1e-30), torch.zeros_like(o))
    return o.reshape(B, H, Sq, D).to(q.dtype)


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor):
    B, S, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    cdt = layers.dtype_of(cfg.compute_dtype)
    q = layers.linear(p["wq"], x, cdt).reshape(B, S, H, hd).transpose(1, 2)
    k = layers.linear(p["wk"], x, cdt).reshape(B, S, KV, hd).transpose(1, 2)
    v = layers.linear(p["wv"], x, cdt).reshape(B, S, KV, hd).transpose(1, 2)
    if cfg.pos == "rope":
        pos = positions[:, None, :]
        q = layers.apply_rope(q, pos, theta=cfg.rope_theta,
                              rope_fraction=cfg.rope_fraction)
        k = layers.apply_rope(k, pos, theta=cfg.rope_theta,
                              rope_fraction=cfg.rope_fraction)
    return q, k, v


def attn_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
               positions: torch.Tensor) -> torch.Tensor:
    """Training path.  x: (B, S, d) -> (B, S, d)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions)
    o = attend(q, k, v, causal=True, window=cfg.window)
    o = o.transpose(1, 2).reshape(B, S, cfg.num_heads * cfg.head_dim)
    return layers.linear(p["wo"], o, layers.dtype_of(cfg.compute_dtype))
