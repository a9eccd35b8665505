"""deepseek-moe-16b [moe] — 2 shared + 64 routed top-6 [arXiv:2401.06066].

28L d_model=2048 16H (MHA kv=16) d_ff=1408(expert) vocab=102400.
Fine-grained experts (d_expert=1408), 64 routed top-6 + 2 shared; layer 0
keeps a dense FFN of width 10944 (the paper's design).  The 64-expert axis
shards over the 16-way model axis (expert parallelism, 4 experts/device) —
the contrast with mixtral's within-expert TP is deliberate (see DESIGN §4).
Copy of ``repro/configs/deepseek_moe_16b.py``.
"""

from repro_torch.models.config import ModelConfig, MoESettings

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    arch_type="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    d_ff=1408,
    vocab_size=102400,
    moe=MoESettings(num_experts=64, top_k=6, num_shared=2, d_expert=1408),
    moe_skip_first=True,
    dense_d_ff_first=10944,
    norm="rmsnorm",
    act="silu",
    pos="rope",
)
