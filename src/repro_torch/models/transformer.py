"""Transformer assembler: config -> params / training forward / prefill /
decode (port of ``repro/models/transformer.py``).

The parameter tree has the JAX package's layout (see
:mod:`repro_torch.weights`): ``embed``, ``final_norm``, ``head`` (empty),
``body`` -- one dict per block of the repeating ``block_pattern`` period,
each leaf stacked over the ``n_periods`` full periods -- and ``tail``, the
unstacked remainder.  The stack loops over the periods in Python; each
stacked leaf is unbound once per forward, so its gradient comes back as
one stacked tensor.

Blocks are pre-norm residual: ``x += attn(norm1(x))`` then
``x += mlp(norm2(x))``.  The tied unembedding is followed by an fp32
softcap.  Which attention runs is chosen by the caller: ``forward``
(training) runs the plain ``attend`` with autograd, ``prefill`` the
flash-attention kernel (dispatched by device), ``decode_step`` the cached
one-token path.

Caches mirror the JAX layout: ``{"head": [], "body": [...], "tail":
[...]}``, the body holding one ``{"k", "v"}`` dict per block of the
period with leaves stacked ``(n_periods, B, KV, cache_len, head_dim)``.
``decode_step`` writes them in place.  MoE, SSM and RG-LRU blocks come
with later slices.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn.ops import flash_attention
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
                positions: torch.Tensor, cache=None, step=None, ring=False,
                attend_fn=attention.attend) -> torch.Tensor:
    """One block.  With ``cache`` it decodes one token at position
    ``step``, writing the new key and value into ``cache`` in place."""
    h = layers.apply_norm(p["norm1"], x, cfg.norm)
    if cache is not None:
        out, _ = attention.attn_decode(p["mixer"], h, cfg, cache, step=step,
                                       ring=ring)
    else:
        out = attention.attn_apply(p["mixer"], h, cfg, positions=positions,
                                   attend_fn=attend_fn)
    x = x + out.to(x.dtype)
    if "ffn" in p:
        h = layers.apply_norm(p["norm2"], x, cfg.norm)
        x = x + mlp_lib.mlp_apply(p["ffn"], h, cfg).to(x.dtype)
    return x


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype: torch.dtype = torch.bfloat16, *, lead: tuple = (),
                     device="cpu") -> dict:
    if kind == "attn":
        return attention.init_cache(cfg, batch, max_len, dtype, lead=lead,
                                    device=device)
    raise NotImplementedError(f"{kind} caches come with a later slice")


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16, *, device="cpu"):
    """Zero decode caches in the JAX layout (see module doc)."""
    n_periods, period_kinds, tail = stack_layout(cfg)
    return {
        "head": [],
        "body": ([block_cache_init(cfg, kind, batch, max_len, dtype,
                                   lead=(n_periods,), device=device)
                  for kind in period_kinds] if n_periods > 0 else None),
        "tail": [block_cache_init(cfg, kind, batch, max_len, dtype,
                                  device=device) for kind in tail],
    }


def apply_stack(params, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, caches=None, step=None, ring=False,
                attend_fn=attention.attend) -> torch.Tensor:
    """Body periods then tail.  With ``caches`` every block decodes one
    token at position ``step`` and updates its cache in place."""
    n_periods, period_kinds, _ = stack_layout(cfg)

    def run(p, x, cache):
        return block_apply(p, x, cfg, positions=positions, cache=cache,
                           step=step, ring=ring, attend_fn=attend_fn)

    if n_periods > 0:
        per_block = [_unstack(blk, n_periods) for blk in params["body"]]
        # select views (not unbind's), so the decode writes in place
        per_cache = ([[map_tree(lambda t, i=i: t[i], c)
                       for i in range(n_periods)] for c in caches["body"]]
                     if caches is not None else None)
        for i in range(n_periods):
            for j in range(len(period_kinds)):
                x = run(per_block[j][i], x,
                        per_cache[j][i] if per_cache is not None else None)
    for j, blk in enumerate(params["tail"]):
        x = run(blk, x, caches["tail"][j] if caches is not None else None)
    return x


def _embed(params, tokens: torch.Tensor, cfg: ModelConfig):
    """Token embedding and positions 0..S-1."""
    B, S = tokens.shape
    cdt = layers.dtype_of(cfg.compute_dtype)
    x = layers.embed(params["embed"], tokens, cdt)
    return x, torch.arange(S, device=tokens.device)[None].expand(B, S)


def _logits(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = layers.unembed(table, x, layers.dtype_of(cfg.compute_dtype))
    return layers.softcap(logits.float(), cfg.logit_softcap)


def forward(params, batch, cfg: ModelConfig):
    """Training forward.  batch: {tokens (B, S), labels (B, S)[, loss_mask]}.
    Returns (loss, metrics)."""
    x, positions = _embed(params, batch["tokens"], cfg)
    x = apply_stack(params, x, cfg, positions=positions)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    logits = _logits(params, x, cfg)
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


def decode_step(params, token: torch.Tensor, caches, step: int,
                cfg: ModelConfig, *, max_len: int):
    """One-token serve step.  token: (B, 1) -> (logits (B, 1, V) fp32,
    caches), the caches updated in place and returned."""
    cdt = layers.dtype_of(cfg.compute_dtype)
    x = layers.embed(params["embed"], token, cdt)
    x = apply_stack(params, x, cfg, positions=None, caches=caches,
                    step=int(step), ring=attention.cache_is_ring(cfg, max_len))
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    return _logits(params, x, cfg), caches


def prefill(params, batch, cfg: ModelConfig) -> torch.Tensor:
    """Full-sequence forward returning fp32 logits (B, S, V): the inference
    prefill path, attention through ``flash_attention``.  batch:
    {tokens (B, S)}."""
    x, positions = _embed(params, batch["tokens"], cfg)
    x = apply_stack(params, x, cfg, positions=positions,
                    attend_fn=flash_attention)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    return _logits(params, x, cfg)
