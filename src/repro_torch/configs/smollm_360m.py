"""smollm-360m [dense] -- llama-arch small.

32L d_model=960 15H (GQA kv=5) d_ff=2560 vocab=49152: RMSNorm, SwiGLU,
RoPE, tied embeddings.  Copy of ``repro/configs/smollm_360m.py``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="smollm-360m",
    arch_type="dense",
    num_layers=32,
    d_model=960,
    num_heads=15,
    num_kv_heads=5,
    d_ff=2560,
    vocab_size=49152,
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    pos="rope",
    tie_embeddings=True,
)
