"""Architecture registry of the port: the configurations it runs.

``get_config(arch_id)`` resolves a configuration (the JAX registry's ten,
in its order: xlstm-1.3b, smollm-360m, mixtral-8x7b, starcoder2-15b,
stablelm-1.6b, command-r-35b, deepseek-moe-16b, musicgen-medium,
recurrentgemma-9b, phi-3-vision-4.2b); ``reduce_for_smoke`` derives the
CPU-sized variant exactly as ``repro.configs.reduce_for_smoke`` does (2
layers, d_model 256, 4 heads of 64, vocab 512, RG-LRU width 256, fp32
compute; MoE: 4 experts, top-2, at most 1 shared, d_expert 128, capacity
factor 4.0, and deepseek's dense head plus 2 MoE layers; a frontend: 8
prefix embeddings of width 32).
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.command_r_35b import CONFIG as _command_r
from repro_torch.configs.deepseek_moe_16b import CONFIG as _deepseek
from repro_torch.configs.mixtral_8x7b import CONFIG as _mixtral
from repro_torch.configs.musicgen_medium import CONFIG as _musicgen
from repro_torch.configs.phi3_vision_4_2b import CONFIG as _phi3v
from repro_torch.configs.recurrentgemma_9b import CONFIG as _recurrentgemma
from repro_torch.configs.smollm_360m import CONFIG as _smollm
from repro_torch.configs.stablelm_1_6b import CONFIG as _stablelm
from repro_torch.configs.starcoder2_15b import CONFIG as _starcoder2
from repro_torch.configs.xlstm_1_3b import CONFIG as _xlstm
from repro_torch.models.config import ModelConfig, MoESettings

ARCHS: dict[str, ModelConfig] = {
    c.name: c for c in [
        _xlstm, _smollm, _mixtral, _starcoder2, _stablelm, _command_r,
        _deepseek, _musicgen, _recurrentgemma, _phi3v,
    ]
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; the port has {sorted(ARCHS)}")
    return ARCHS[name]


def reduce_for_smoke(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family variant: 2 layers, d_model 256, <= 4 experts,
    fp32 compute."""
    kinds_unique = tuple(dict.fromkeys(cfg.layer_kinds()))[:2]
    pattern = kinds_unique if len(kinds_unique) == 2 else kinds_unique * 2
    kv = 4 if cfg.num_kv_heads == cfg.num_heads else 2
    changes = dict(
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
    if cfg.moe is not None:
        changes["moe"] = MoESettings(
            num_experts=4, top_k=2, num_shared=min(cfg.moe.num_shared, 1),
            d_expert=128,
            # drop-free at smoke scale, so decode equals prefill
            capacity_factor=4.0)
        changes["moe_skip_first"] = cfg.moe_skip_first
        changes["dense_d_ff_first"] = 256 if cfg.moe_skip_first else 0
        if cfg.moe_skip_first:
            changes["num_layers"] = 3   # dense head + 2 MoE body layers
    if cfg.frontend is not None:
        changes["num_prefix_embeds"] = 8
        changes["d_frontend"] = 32
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **changes)
