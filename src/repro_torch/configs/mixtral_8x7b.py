"""mixtral-8x7b [moe] — 8 experts top-2, SWA [arXiv:2401.04088].

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, MoE 8e top-2,
sliding-window 4096.  Experts are tensor-parallel over d_ff
(expert_mlp -> model); the 8-expert axis is too small to shard 16 ways.
The SWA ring cache bounds decode memory: long_500k runs natively.
Copy of ``repro/configs/mixtral_8x7b.py``.
"""

from repro_torch.models.config import ModelConfig, MoESettings

CONFIG = ModelConfig(
    name="mixtral-8x7b",
    arch_type="moe",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=32000,
    moe=MoESettings(num_experts=8, top_k=2, d_expert=14336),
    window=4096,
    norm="rmsnorm",
    act="silu",
    pos="rope",
    rope_theta=1e6,
)
