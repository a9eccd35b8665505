"""Primitive layers as functions on tensors (port of
``repro/models/layers.py``).

Parameters are plain dicts of tensors.  Numerics follow the JAX package:
``linear``/``unembed`` take operands in the compute dtype and return the
compute dtype (on the card a bf16 product accumulates in fp32: the entry
points turn off cuBLAS's reduced-precision bf16 reduction); norms run in
fp32 and cast back; RoPE rotates *interleaved* pairs (x[..., 0::2],
x[..., 1::2]), not the rotate-half layout.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


def truncated_normal_(t: torch.Tensor, fan_in: int, scale: float,
                      gen: torch.Generator) -> torch.Tensor:
    """He-style fan-in init in place: N(0, 1) truncated to [-2, 2] times
    scale / sqrt(fan_in)."""
    std = scale / max(fan_in, 1) ** 0.5
    return torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0,
                                       generator=gen).mul_(std)


# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------

def linear(p, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    y = torch.matmul(x.to(compute_dtype), p["w"].to(compute_dtype))
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def apply_norm(p, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    elif kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def embed(p, ids: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    return p["table"][ids.long()].to(compute_dtype)


def unembed(p, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    """Logits against the (tied or untied) table, in the compute dtype."""
    return torch.matmul(x.to(compute_dtype), p["table"].to(compute_dtype).T)


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, rope_fraction: float = 1.0,
               theta: float = 10000.0, device=None):
    """Inverse frequencies for the rotated fraction of head_dim."""
    rot = int(head_dim * rope_fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0,
               rope_fraction: float = 1.0) -> torch.Tensor:
    """x: (..., seq, head_dim), positions: (..., seq) int."""
    inv, rot = rope_freqs(x.shape[-1], rope_fraction, theta, x.device)
    if rot == 0:
        return x
    ang = positions[..., None].float() * inv          # (..., seq, rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """tanh soft-capping (off when cap is 0)."""
    if cap and cap > 0:
        return torch.tanh(x / cap) * cap
    return x


def _gelu(x):
    # jax.nn.gelu defaults to the tanh approximation
    return F.gelu(x, approximate="tanh")


ACTS = {"silu": F.silu, "gelu": _gelu, "tanh": torch.tanh}
