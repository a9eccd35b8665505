"""Model configuration dataclass (port of ``repro/models/config.py``).

An architecture is data: the transformer assembler
(:mod:`repro_torch.models.transformer`) is driven by this config alone.
This slice runs the dense attention family (``block_pattern`` of
``"attn"`` blocks, RMSNorm or LayerNorm, gated or plain MLP, RoPE);
MoE, recurrent blocks and multimodal frontends come with later slices, so
their fields are not carried here.  ``remat`` and ``scan_layers`` have no
counterpart: PyTorch runs the layer loop eagerly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | ...
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    block_pattern: tuple[str, ...] = ("attn",)
    window: int | None = None         # sliding-window attention
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "silu"                 # silu | gelu
    gated_mlp: bool = True
    use_bias: bool = False
    tie_embeddings: bool = False
    pos: str = "rope"                 # rope | none
    compute_dtype: str = "bfloat16"   # matmul/activation dtype
    param_dtype: str = "float32"
    logit_softcap: float = 0.0

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % self.num_kv_heads != 0:
            raise ValueError(f"{self.name}: heads {self.num_heads} % kv "
                             f"{self.num_kv_heads} != 0")

    def layer_kinds(self) -> tuple[str, ...]:
        return tuple(self.block_pattern[i % len(self.block_pattern)]
                     for i in range(self.num_layers))

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Exact parameter count of :func:`transformer.init_params`."""
        from repro_torch.models.transformer import param_shapes
        total = 0
        for shape in param_shapes(self):
            n = 1
            for s in shape:
                n *= s
            total += n
        return total
