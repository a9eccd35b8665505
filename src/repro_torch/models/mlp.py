"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain 2-layer MLPs
(port of ``repro/models/mlp.py``).  Under tensor parallelism (``tp``)
``up`` / ``gate`` are column-parallel and ``down`` row-parallel where the
rank holds a block of ``mlp``: the hidden activation stays the rank's
block, and one sum over the group follows ``down``."""

from __future__ import annotations

import torch

from repro_torch.models import activations, layers
from repro_torch.models.config import ModelConfig


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig, tp=None,
              d_ff: int | None = None) -> torch.Tensor:
    """``d_ff``: the block's whole width (``cfg.d_ff`` unless given:
    deepseek's dense head is ``dense_d_ff_first`` wide)."""
    cdt = layers.dtype_of(cfg.compute_dtype)
    act = activations.ACTS[cfg.act]
    if tp is not None and p["up"]["w"].shape[-1] == (d_ff or cfg.d_ff):
        tp = None                     # mlp replicated: a plain block
    if tp is not None:
        x = tp.copy(x)
    h = layers.linear(p["up"], x, cdt)
    if "gate" in p:
        h = activations.gated(cfg.act, h, layers.linear(p["gate"], x, cdt))
    else:
        h = act(h)
    return layers.row_linear(p["down"], h, cdt, tp)
