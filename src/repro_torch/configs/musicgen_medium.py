"""musicgen-medium [audio] — decoder-only over EnCodec tokens
[arXiv:2306.05284].

48L d_model=1536 24H (MHA kv=24) d_ff=6144 vocab=2048 (EnCodec codebook).
Sinusoidal positions, LayerNorm, plain GELU MLP.  The EnCodec conv codec
and the T5 text encoder are not modelled: a batch carries the token
stream and a (B, 64, 768) conditioning-embedding prefix,
``prefix_embeds``, which the frontend projector splices in front of the
sequence (``models/transformer._embed_inputs``).
Copy of ``repro/configs/musicgen_medium.py``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-medium",
    arch_type="audio",
    num_layers=48,
    d_model=1536,
    num_heads=24,
    num_kv_heads=24,
    d_ff=6144,
    vocab_size=2048,
    norm="layernorm",
    act="gelu",
    gated_mlp=False,
    use_bias=True,
    pos="sinusoidal",
    frontend="audio",
    num_prefix_embeds=64,
    d_frontend=768,
)
