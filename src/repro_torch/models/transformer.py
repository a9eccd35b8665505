"""Transformer assembler: config -> params / training forward.

Port of the dense training path of ``repro/models/transformer.py``.  The
parameter tree has the JAX package's layout (see
:mod:`repro_torch.weights`): ``embed``, ``final_norm``, ``head`` (empty),
``body`` -- one dict per block of the repeating ``block_pattern`` period,
each leaf stacked over the ``n_periods`` full periods -- and ``tail``, the
unstacked remainder.  The forward loops over the periods in Python; each
stacked leaf is unbound once per forward, so its gradient comes back as
one stacked tensor.

Blocks are pre-norm residual: ``x += attn(norm1(x))`` then
``x += mlp(norm2(x))``.  The tied unembedding is followed by an fp32
softcap and an fp32 log-softmax.  Decode caches, MoE, SSM and RG-LRU
blocks come with later slices.
"""

from __future__ import annotations

import torch

from repro_torch.models import attention, layers, mlp as mlp_lib
from repro_torch.models.config import ModelConfig
from repro_torch.weights import leaf_items, layout_of, map_tree, unflatten

SUPPORTED_KINDS = ("attn",)


def stack_layout(cfg: ModelConfig):
    """-> (n_periods, period_kinds, tail_kinds)."""
    kinds = cfg.layer_kinds()
    unsupported = sorted(set(kinds) - set(SUPPORTED_KINDS))
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {unsupported} come with a later slice")
    period = len(cfg.block_pattern)
    n_periods = len(kinds) // period
    return (n_periods, tuple(kinds[:period]),
            tuple(kinds[n_periods * period:]))


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _block_shapes(cfg: ModelConfig, lead: tuple = ()):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def norm():
        p = {"scale": _meta(*lead, d)}
        if cfg.norm == "layernorm":
            p["bias"] = _meta(*lead, d)
        return p

    def lin(i, o):
        p = {"w": _meta(*lead, i, o)}
        if cfg.use_bias:
            p["b"] = _meta(*lead, o)
        return p

    p = {"norm1": norm(),
         "mixer": {"wq": lin(d, H * hd), "wk": lin(d, KV * hd),
                   "wv": lin(d, KV * hd), "wo": lin(H * hd, d)}}
    if cfg.d_ff > 0:
        p["norm2"] = norm()
        p["ffn"] = {"up": lin(d, cfg.d_ff), "down": lin(cfg.d_ff, d)}
        if cfg.gated_mlp:
            p["ffn"]["gate"] = lin(d, cfg.d_ff)
    return p


def param_shapes_tree(cfg: ModelConfig):
    """The parameter tree with ``meta`` tensors as leaves (shapes only)."""
    n_periods, period_kinds, tail = stack_layout(cfg)
    tree = {
        "embed": {"table": _meta(cfg.vocab_size, cfg.d_model)},
        "final_norm": {"scale": _meta(cfg.d_model)},
        "head": [],
        "body": ([_block_shapes(cfg, (n_periods,)) for _ in period_kinds]
                 if n_periods > 0 else None),
        "tail": [_block_shapes(cfg) for _ in tail],
    }
    if cfg.norm == "layernorm":
        tree["final_norm"]["bias"] = _meta(cfg.d_model)
    if not cfg.tie_embeddings:
        tree["unembed"] = {"table": _meta(cfg.vocab_size, cfg.d_model)}
    return tree


def param_shapes(cfg: ModelConfig) -> list[tuple[int, ...]]:
    """Leaf shapes in canonical order."""
    return [tuple(t.shape) for _, t in leaf_items(param_shapes_tree(cfg))]


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cpu"):
    """Random parameters from ``seed``: truncated-normal fan-in linears
    (zero biases), unit norm scales, N(0, 1/d_model) embeddings.  Leaves
    are fp32 views of one flat vector in canonical order.  The numbers are
    drawn on the CPU and then moved, so a seed gives the same weights on
    every device."""
    if cfg.param_dtype != "float32":
        raise NotImplementedError("the port keeps fp32 parameters")
    layout = layout_of(param_shapes_tree(cfg))
    flat = torch.empty(layout.numel, dtype=torch.float32)
    params = unflatten(flat, layout)
    gen = torch.Generator()
    gen.manual_seed(seed)
    with torch.no_grad():
        for path, t in leaf_items(params):
            kind = path[-1]
            if kind == "w":
                layers.truncated_normal_(t, t.shape[-2], 1.0, gen)
            elif kind == "table":
                t.normal_(generator=gen).mul_(cfg.d_model ** -0.5)
            elif kind == "scale":
                t.fill_(1.0)
            else:                                    # biases
                t.zero_()
    return unflatten(flat.to(device), layout)


def _unstack(tree, n: int):
    """Stacked (n, ...) leaves -> n trees of per-layer views (one unbind
    per leaf, so autograd stacks the layer gradients back in one op)."""
    parts = {id(t): t.unbind(0) for _, t in leaf_items(tree)}
    return [map_tree(lambda t, i=i: parts[id(t)][i], tree) for i in range(n)]


def block_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor) -> torch.Tensor:
    h = layers.apply_norm(p["norm1"], x, cfg.norm)
    x = x + attention.attn_apply(p["mixer"], h, cfg,
                                 positions=positions).to(x.dtype)
    if "ffn" in p:
        h = layers.apply_norm(p["norm2"], x, cfg.norm)
        x = x + mlp_lib.mlp_apply(p["ffn"], h, cfg).to(x.dtype)
    return x


def apply_stack(params, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor) -> torch.Tensor:
    n_periods, period_kinds, _ = stack_layout(cfg)
    if n_periods > 0:
        per_block = [_unstack(blk, n_periods) for blk in params["body"]]
        for i in range(n_periods):
            for j in range(len(period_kinds)):
                x = block_apply(per_block[j][i], x, cfg, positions=positions)
    for blk in params["tail"]:
        x = block_apply(blk, x, cfg, positions=positions)
    return x


def forward(params, batch, cfg: ModelConfig):
    """Training forward.  batch: {tokens (B, S), labels (B, S)[, loss_mask]}.
    Returns (loss, metrics)."""
    cdt = layers.dtype_of(cfg.compute_dtype)
    tokens = batch["tokens"]
    B, S = tokens.shape
    x = layers.embed(params["embed"], tokens, cdt)
    positions = torch.arange(S, device=tokens.device)[None].expand(B, S)
    x = apply_stack(params, x, cfg, positions=positions)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = layers.softcap(layers.unembed(table, x, cdt).float(),
                            cfg.logit_softcap)
    labels = batch["labels"].long()
    loss_mask = batch.get("loss_mask")
    if loss_mask is None:
        loss_mask = torch.ones(labels.shape, dtype=torch.bool,
                               device=labels.device)
    logp = torch.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels[..., None])[..., 0]
    denom = torch.clamp(loss_mask.sum(), min=1)
    loss = (nll * loss_mask).sum() / denom
    metrics = {"loss": loss,
               "ppl_proxy": torch.exp(torch.clamp(loss, 0.0, 20.0))}
    return loss, metrics
