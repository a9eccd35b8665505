"""command-r-35b [dense] — GQA, no-bias [hf:CohereForAI/c4ai-command-r-v01].

40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000.  No biases,
LayerNorm, SwiGLU, tied embeddings, RoPE theta 8e6.  The 256k vocab makes
the unembedding the memory hot-spot (see EXPERIMENTS §Roofline).
Copy of ``repro/configs/command_r_35b.py``.
"""

from repro_torch.models.config import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    arch_type="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    norm="layernorm",
    act="silu",
    gated_mlp=True,
    use_bias=False,
    pos="rope",
    rope_theta=8e6,
    tie_embeddings=True,
)
