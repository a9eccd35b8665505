"""starcoder2-15b [dense] — GQA, RoPE [arXiv:2402.19173].

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152.  LayerNorm + bias,
plain (non-gated) GELU MLP per the StarCoder2 recipe.
Copy of ``repro/configs/starcoder2_15b.py``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    arch_type="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    d_ff=24576,
    vocab_size=49152,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    use_bias=True,
    pos="rope",
    rope_theta=1e5,
)
