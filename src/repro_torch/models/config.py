"""Model configuration dataclass (port of ``repro/models/config.py``).

An architecture is data: the transformer assembler
(:mod:`repro_torch.models.transformer`) is driven by this config alone.
The port runs the dense attention family (``block_pattern`` of ``"attn"``
blocks, RMSNorm or LayerNorm, gated or plain MLP, RoPE), the recurrent
blocks: xLSTM's ``"mlstm"`` / ``"slstm"`` (``arch_type`` ``ssm``) and
RecurrentGemma's ``"rglru"`` beside local attention (``hybrid``), with
their fields (``mlstm_proj_factor``, ``slstm_proj_factor``,
``conv_width``, ``rglru_width``) at the JAX package's defaults, and the
Mixture-of-Experts family (``arch_type`` ``moe``): :class:`MoESettings`
in ``moe``, and ``moe_skip_first`` / ``dense_d_ff_first`` for
deepseek-moe's dense-FFN layer 0, which the stack keeps as its ``head``,
and the multimodal frontends (``arch_type`` ``audio`` / ``vlm``):
``frontend`` (``"vision"`` or ``"audio"``) adds a projector that maps a
batch's ``prefix_embeds`` (B, ``num_prefix_embeds``, ``d_frontend``) into
``d_model`` and splices them in front of the tokens; ``pos`` is
``"rope"``, ``"sinusoidal"`` (added to the embedded sequence) or
``"none"``.  The encoders that would make ``prefix_embeds`` (CLIP's ViT,
EnCodec / T5) are not part of the model, in the JAX package as here.
``remat`` and ``scan_layers`` have no counterpart: PyTorch runs the layer
loop eagerly.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass


@dataclass(frozen=True)
class MoESettings:
    """Mixture-of-Experts block settings (the JAX package's defaults).

    ``d_expert`` is the per-expert FFN width (0 -> ``d_ff``);
    ``num_shared`` experts run densely on every token (deepseek-moe).
    Routing is top-k softmax with capacity-based slot dropping
    (:mod:`repro_torch.models.moe`)."""
    num_experts: int
    top_k: int
    num_shared: int = 0
    d_expert: int = 0
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01   # load-balance loss weight
    router_z_weight: float = 1e-3     # router logit z-loss


@dataclass(frozen=True)
class ModelConfig:
    name: str
    arch_type: str                    # dense | moe | ssm | hybrid | audio | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                 # 0 -> d_model // num_heads
    block_pattern: tuple[str, ...] = ("attn",)
    moe: MoESettings | None = None
    moe_skip_first: bool = False      # deepseek: layer 0 keeps a dense FFN
    dense_d_ff_first: int = 0         # ... of this width
    window: int | None = None         # sliding-window attention
    rope_theta: float = 10000.0
    rope_fraction: float = 1.0
    norm: str = "rmsnorm"             # rmsnorm | layernorm
    act: str = "silu"                 # silu | gelu
    gated_mlp: bool = True
    use_bias: bool = False
    tie_embeddings: bool = False
    pos: str = "rope"                 # rope | sinusoidal | none
    # multimodal frontends (the encoders themselves are not modelled):
    frontend: str | None = None       # None | 'vision' | 'audio'
    num_prefix_embeds: int = 0        # patches / conditioning frames
    d_frontend: int = 0               # frontend embedding width
    # recurrent blocks:
    mlstm_proj_factor: float = 2.0    # mLSTM up-projection
    slstm_proj_factor: float = 1.3334 # sLSTM post-FFN factor (4/3)
    conv_width: int = 4               # short conv in rglru/mlstm blocks
    rglru_width: int = 0              # 0 -> d_model
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

    def is_moe_layer(self, layer_idx: int) -> bool:
        if self.moe is None:
            return False
        return not (self.moe_skip_first and layer_idx == 0)

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    def param_count(self) -> int:
        """Exact parameter count of :func:`transformer.init_params`."""
        from repro_torch.models.transformer import count_params_analytic
        return count_params_analytic(self)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k of the routed experts
        and the shared ones)."""
        from repro_torch.models.transformer import count_params_analytic
        return count_params_analytic(self, active_only=True)
