"""Architecture registry of the port: the configurations it runs.

``get_config(arch_id)`` resolves a configuration (smollm-360m, xlstm-1.3b,
recurrentgemma-9b); ``reduce_for_smoke`` derives the CPU-sized variant
exactly as ``repro.configs.reduce_for_smoke`` does (2 layers, d_model
256, 4 heads of 64, vocab 512, RG-LRU width 256, fp32 compute).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.recurrentgemma_9b import CONFIG as _recurrentgemma
from repro_torch.configs.smollm_360m import CONFIG as _smollm
from repro_torch.configs.xlstm_1_3b import CONFIG as _xlstm
from repro_torch.models.config import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [_xlstm, _smollm, _recurrentgemma]}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(ARCHS)}")
    return ARCHS[name]


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model 256, fp32 compute."""
    kinds_unique = tuple(dict.fromkeys(cfg.layer_kinds()))[:2]
    pattern = kinds_unique if len(kinds_unique) == 2 else kinds_unique * 2
    kv = 4 if cfg.num_kv_heads == cfg.num_heads else 2
    return dataclasses.replace(
        cfg, name=cfg.name + "-smoke",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=kv,
        head_dim=64,
        d_ff=512 if cfg.d_ff > 0 else 0,
        vocab_size=512,
        block_pattern=pattern,
        rglru_width=256 if cfg.rglru_width else 0,
        window=min(cfg.window, 64) if cfg.window else None,
        compute_dtype="float32",   # CPU smoke: exact numerics
    )
