"""recurrentgemma-9b [hybrid] — RG-LRU + local attn, 1:2 [arXiv:2402.19427].

38L d_model=4096 16H (MQA kv=1, head_dim 256) d_ff=12288 vocab=256000.
Pattern (rglru, rglru, attn) x 12 + 2 trailing rglru (38 = 12*3 + 2 — the
tail exercises the non-period path).  Local attention window 2048,
GeGLU, RMSNorm, logit soft-cap 30, tied embeddings.  Decode state is
O(window + d_rnn): long_500k runs natively.
Copy of ``repro/configs/recurrentgemma_9b.py``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    arch_type="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "attn"),
    window=2048,
    norm="rmsnorm",
    act="gelu",
    gated_mlp=True,
    pos="rope",
    tie_embeddings=True,
    logit_softcap=30.0,
    rglru_width=4096,
)
