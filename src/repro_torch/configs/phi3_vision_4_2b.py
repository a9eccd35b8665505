"""phi-3-vision-4.2b [vlm] — phi3-mini + CLIP
[hf:microsoft/Phi-3-vision-128k-instruct].

32L d_model=3072 32H (MHA kv=32) d_ff=8192 vocab=32064.  RMSNorm, SwiGLU,
RoPE.  The CLIP ViT is not modelled: a batch carries (B, 256, 1024) patch
embeddings, ``prefix_embeds``; the projector (2-layer GELU MLP into
d_model) and the image-token splice are (``models/transformer.
_embed_inputs``), and the loss masks the image prefix.
Copy of ``repro/configs/phi3_vision_4_2b.py``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="phi-3-vision-4.2b",
    arch_type="vlm",
    num_layers=32,
    d_model=3072,
    num_heads=32,
    num_kv_heads=32,
    d_ff=8192,
    vocab_size=32064,
    norm="rmsnorm",
    act="silu",
    gated_mlp=True,
    pos="rope",
    frontend="vision",
    num_prefix_embeds=256,
    d_frontend=1024,
)
