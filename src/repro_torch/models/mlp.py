"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain 2-layer MLPs
(port of ``repro/models/mlp.py``)."""

from __future__ import annotations

import torch

from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


def mlp_apply(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    cdt = layers.dtype_of(cfg.compute_dtype)
    act = layers.ACTS[cfg.act]
    h = layers.linear(p["up"], x, cdt)
    if "gate" in p:
        h = h * act(layers.linear(p["gate"], x, cdt))
    else:
        h = act(h)
    return layers.linear(p["down"], h, cdt)
