"""Transformer assembler: config -> params / training forward / prefill /
decode (port of ``repro/models/transformer.py``).

The parameter tree has the JAX package's layout (see
:mod:`repro_torch.weights`): ``embed``, ``final_norm``, ``head`` -- the
unstacked layer 0 when ``moe_skip_first`` keeps it out of the body
(deepseek-moe's dense-FFN layer), else empty -- ``body`` -- one dict per
block of the repeating ``block_pattern`` period, each leaf stacked over
the ``n_periods`` full periods -- and ``tail``, the unstacked remainder
(recurrentgemma-9b's 38 = 12 x 3 + 2) -- and, for a config with a
``frontend``, ``frontend`` = {``proj1`` (d_frontend, d_model), ``proj2``
(d_model, d_model)}, the projector of the batch's ``prefix_embeds`` (no
bias).  The stack loops over the periods in Python; each stacked leaf is
unbound once per forward, so its gradient comes back as one stacked
tensor.

Block kinds: ``attn`` (GQA attention), ``mlstm`` / ``slstm`` (xLSTM,
:mod:`repro_torch.models.ssm`) and ``rglru`` (RecurrentGemma,
:mod:`repro_torch.models.rglru`).  Blocks are pre-norm residual: ``x +=
mixer(norm1(x))``; ``attn`` and ``rglru`` blocks then add ``x +=
ffn(norm2(x))`` when ``d_ff > 0`` or the config has MoE, while the xLSTM
blocks carry their own projections (JAX's ``_has_ffn``).  The FFN is the
MoE block (:mod:`repro_torch.models.moe`) in a body ``attn`` block of an
MoE config and in a head or tail layer for which ``cfg.is_moe_layer``
holds, else the dense MLP (of width ``dense_d_ff_first`` in deepseek's
head layer).  ``apply_stack`` sums the MoE blocks' router losses
(``moe_aux``, ``moe_z``); ``forward`` adds them to the loss and reports
them in its metrics, ``prefill`` and ``decode_step`` drop them.  The
unembedding is followed by an fp32 softcap.  ``forward`` and ``prefill``
embed through ``_embed_inputs``: the projected prefix (when the config
has a frontend and the batch ``prefix_embeds``) goes in front of the
tokens, is masked out of the loss, and attention stays causal over it;
``pos="sinusoidal"`` adds the sinusoid to the whole sequence there and at
``step`` in ``decode_step``, which has no prefix.  Which attention runs is
chosen by the caller: ``forward`` (training) runs the plain ``attend``
with autograd, ``prefill`` the
flash-attention kernel (dispatched by device), ``decode_step`` the cached
one-token path; the recurrent blocks run chunk 256 in both forwards and
one step (chunk 1) in decode, as the JAX package does.

Tensor parallelism over the mesh's ``model`` axis (``forward``'s ``tp``,
a ``repro_torch.dist.tensor_parallel.TensorParallel``) covers every
configuration: ``param_shapes_tree`` carries the JAX init's logical axes,
:func:`tp_layout` resolves them under the mesh's rules, ``init_params(...,
layout=)`` gives a rank's blocks of the whole tree's draws, and
``forward`` runs the vocab-parallel embedding, attention and MLP
(:mod:`repro_torch.models.attention`, :mod:`repro_torch.models.mlp`), the
MoE block with its banks split over ``d_e`` or over the experts
(:mod:`repro_torch.models.moe`), the recurrent blocks over their state
widths and heads (:mod:`repro_torch.models.ssm`,
:mod:`repro_torch.models.rglru`), the vocab-parallel unembedding and
log-softmax; a tied table takes both gradients on its local block.  The
frontend projector splits nothing under the rules: it runs replicated.

Caches mirror the JAX layout: ``{"head": [...], "body": [...], "tail":
[...]}``, the body holding one cache per block of the period with leaves
stacked over the periods: ``{"k", "v"}`` (B, KV, cache_len, head_dim) for
attention, ``((C, n, m), conv_state)`` for mLSTM, ``(c, n, m, h)`` for
sLSTM and ``(h, conv_state)`` for RG-LRU.  Recurrent states are fp32; a
conv state has the promoted dtype of the cache dtype and the compute
dtype, which is the dtype the JAX package's state takes after its first
step.  ``decode_step`` writes every cache in place.
"""

from __future__ import annotations

import math

import torch

from repro_torch.analysis.trace import allowed
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.models import activations, attention, layers
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import rglru as rglru_lib
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.weights import (TPLayout, leaf_items, layout_of, map_tree,
                                 pack, tp_slice, unflatten)

SUPPORTED_KINDS = ("attn", "mlstm", "slstm", "rglru")


# the routed expert banks (JAX's count_params_analytic's rule)
_BANKS = ("w_up", "w_gate", "w_down")


def stack_layout(cfg: ModelConfig):
    """-> (head, n_periods, period_kinds, body_start, tail): ``head`` and
    ``tail`` as ``((layer_idx, kind), ...)``, as the JAX package's."""
    kinds = cfg.layer_kinds()
    unsupported = sorted(set(kinds) - set(SUPPORTED_KINDS))
    if unsupported:
        raise NotImplementedError(
            f"{cfg.name}: block kinds {unsupported} come with a later slice")
    off = 1 if cfg.moe_skip_first else 0
    head = tuple((i, kinds[i]) for i in range(off))
    period = len(cfg.block_pattern)
    n_periods = (len(kinds) - off) // period
    tail_start = off + n_periods * period
    tail = tuple((i, kinds[i]) for i in range(tail_start, len(kinds)))
    return head, n_periods, tuple(kinds[off:off + period]), off, tail


def _has_ffn(cfg: ModelConfig, kind: str) -> bool:
    return kind in ("attn", "rglru") and (cfg.d_ff > 0
                                          or cfg.moe is not None)


def _ffn_width(cfg: ModelConfig, layer_idx: int) -> int:
    """The dense MLP's width in layer ``layer_idx`` (deepseek's dense head
    layer is ``dense_d_ff_first`` wide)."""
    return (cfg.dense_d_ff_first if cfg.moe_skip_first and layer_idx == 0
            else cfg.d_ff)


def _block_shapes(cfg: ModelConfig, kind: str, layer_idx: int,
                  lead: tuple = ()):
    d, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim

    def lin(i, o, axes=("embed", "mlp")):
        return layers.linear_shapes(i, o, lead=lead, use_bias=cfg.use_bias,
                                    axes=axes)

    if kind == "attn":
        col, row = ("embed", "qkv"), ("qkv", "embed")
        mixer = {"wq": lin(d, H * hd, col), "wk": lin(d, KV * hd, col),
                 "wv": lin(d, KV * hd, col), "wo": lin(H * hd, d, row)}
    elif kind == "mlstm":
        mixer = ssm.mlstm_block_shapes(cfg, lead=lead)
    elif kind == "slstm":
        mixer = ssm.slstm_block_shapes(cfg, lead=lead)
    elif kind == "rglru":
        mixer = rglru_lib.rglru_block_shapes(cfg, lead=lead)
    else:
        raise ValueError(f"unknown block kind {kind!r}")
    p = {"norm1": layers.norm_shapes(d, cfg.norm, lead=lead), "mixer": mixer}
    if _has_ffn(cfg, kind):
        p["norm2"] = layers.norm_shapes(d, cfg.norm, lead=lead)
        if cfg.is_moe_layer(layer_idx):
            p["ffn"] = moe_lib.moe_shapes(cfg, lead=lead)
        else:
            d_ff = _ffn_width(cfg, layer_idx)
            p["ffn"] = {"up": lin(d, d_ff),
                        "down": lin(d_ff, d, ("mlp", "embed"))}
            if cfg.gated_mlp:
                p["ffn"]["gate"] = lin(d, d_ff)
    return p


def param_shapes_tree(cfg: ModelConfig):
    """The parameter tree with ``meta`` tensors as leaves (shapes only),
    each with the logical ``axes`` the JAX package's init annotates it
    with (a stacked body leaf's period axis has none)."""
    head, n_periods, period_kinds, body_start, tail = stack_layout(cfg)
    table = ("vocab", "embed")
    tree = {
        "embed": {"table": layers.meta(cfg.vocab_size, cfg.d_model,
                                       axes=table)},
        "final_norm": layers.norm_shapes(cfg.d_model, cfg.norm),
        "head": [_block_shapes(cfg, kind, i) for i, kind in head],
        "body": ([_block_shapes(cfg, kind, body_start + j, (n_periods,))
                  for j, kind in enumerate(period_kinds)]
                 if n_periods > 0 else None),
        "tail": [_block_shapes(cfg, kind, i) for i, kind in tail],
    }
    if not cfg.tie_embeddings:
        tree["unembed"] = {"table": layers.meta(cfg.vocab_size, cfg.d_model,
                                                axes=table)}
    if cfg.frontend is not None:
        # no bias, whatever use_bias says: JAX's projector never has one
        tree["frontend"] = {
            "proj1": layers.linear_shapes(cfg.d_frontend, cfg.d_model,
                                          axes=(None, "embed")),
            "proj2": layers.linear_shapes(cfg.d_model, cfg.d_model,
                                          axes=("embed", "embed"))}
    return tree


def tp_layout(cfg: ModelConfig, mesh, rules, rank: int = 0) -> TPLayout:
    """The rank's tensor-parallel layout of ``cfg``'s parameters on
    ``mesh`` under ``rules`` (``repro_torch.dist.sharding.param_layout``
    of :func:`param_shapes_tree`'s axes)."""
    from repro_torch.dist.sharding import param_layout
    return param_layout(param_shapes_tree(cfg), mesh, rules, rank)


def count_params_analytic(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count of :func:`init_params` (from shapes alone).
    ``active_only``: the parameters a token touches, the routed expert
    banks counted at ``top_k / num_experts`` (integer division, as the
    JAX package counts them)."""
    layout = layout_of(param_shapes_tree(cfg))
    total = layout.numel
    if active_only and cfg.moe is not None:
        routed = sum(n for path, n in zip(layout.paths, layout.sizes)
                     if "ffn" in path and path[-1] in _BANKS
                     and "shared" not in path)
        total = total - routed + routed * cfg.moe.top_k // \
            cfg.moe.num_experts
    return total


def count_embedding_params(cfg: ModelConfig) -> int:
    """Parameters of the embedding and (untied) unembedding tables."""
    tree = param_shapes_tree(cfg)
    return sum(tree[k]["table"].numel() for k in ("embed", "unembed")
               if k in tree)


def init_params(cfg: ModelConfig, *, seed: int = 0, device="cpu",
                layout: TPLayout | None = None):
    """Random parameters from ``seed``, each leaf by the JAX package's law:
    every ``w`` and ``r`` truncated normal with fan-in the first axis of
    the unstacked leaf (``repro/models/layers.py:19``; a body leaf's
    leading period axis is not part of it), so the MoE router's fan-in is
    d_model and an expert bank's (``w_up`` / ``w_gate`` / ``w_down``,
    (E, d_in, d_out)) is its expert count E, as ``moe_init`` draws it; the
    conv's ``w`` N(0, 1) /
    width (:func:`ssm.conv_init_`), RG-LRU's Lambda the inverse softplus
    of -log U(0.9, 0.999) (:func:`rglru.lam_init_`), zero biases, unit norm
    scales, N(0, 1/d_model) embeddings.  Leaves are fp32 views of one flat
    vector in canonical order.  Each leaf is drawn in blocks of
    ``layers.DRAW_BLOCK`` weights, block b of leaf i from a generator
    seeded with ``layers.block_seed(seed, i, b)``, across the host's cores
    (the values do not depend on their number).  The numbers are drawn
    on the CPU and then moved, so a seed gives the same weights on every
    device.  With a tensor-parallel ``layout`` the tree is the rank's
    blocks (``weights.tp_slice``) of those same draws, leaves views of
    the rank's flat vector; only the draw blocks that hold some of the
    rank's block are drawn (:func:`_blocks_needed`).  Under a
    ``FakeTensorMode`` (a trace, ``launch.dryrun``) the leaves are
    allocated and not drawn: a fake tensor holds no values, and a random
    draw has no fake implementation."""
    from torch._subclasses.fake_tensor import is_fake
    if cfg.param_dtype != "float32":
        raise NotImplementedError("the port keeps fp32 parameters")
    full = layout_of(param_shapes_tree(cfg))
    if is_fake(torch.empty(0)):
        local = full if layout is None else layout.local
        return unflatten(torch.empty(local.numel, device=device), local)
    flat = torch.empty(full.numel, dtype=torch.float32)
    params = unflatten(flat, full)
    jobs = []
    with torch.no_grad():
        for i, (path, t) in enumerate(leaf_items(params)):
            kind = path[-1]
            shape = t.shape[1:] if path[0] == "body" else t.shape
            need = _blocks_needed(layout, i)
            if kind == "w" and path[-2] == "conv":
                jobs.append((t, seed, i, lambda b, g, width=t.shape[-2]:
                             ssm.conv_init_(b, g, width), need))
            elif kind in ("w", "r") + _BANKS:
                jobs.append((t, seed, i, lambda b, g, fan_in=shape[0]:
                             layers.truncated_normal_(b, fan_in, 1.0, g),
                             need))
            elif kind == "lam":
                jobs.append((t, seed, i, rglru_lib.lam_init_, need))
            elif kind == "table":
                jobs.append((t, seed, i, lambda b, g: b.normal_(
                    generator=g).mul_(cfg.d_model ** -0.5), need))
            elif kind == "scale":
                t.fill_(1.0)
            else:                                    # biases
                t.zero_()
        layers.draw_blocks_(jobs)
    if layout is None:
        return unflatten(flat.to(device), full)
    flat, local = pack(tp_slice(params, layout))
    return unflatten(flat.to(device), local)


def _blocks_needed(layout: TPLayout | None, i: int):
    """Which ``layers.DRAW_BLOCK`` blocks of leaf ``i``'s flat draw hold
    some of the rank's block under ``layout`` (a boolean array), or
    ``None`` for all of them."""
    import numpy as np
    if layout is None or layout.dims[i] is None:
        return None
    shape, d = layout.full.shapes[i], layout.dims[i]
    outer = math.prod(shape[:d])
    run = shape[d] // layout.parts * math.prod(shape[d + 1:])
    lo = (np.arange(outer, dtype=np.int64) * layout.parts + layout.index) \
        * run
    nb = -(-math.prod(shape) // layers.DRAW_BLOCK)
    edge = np.zeros(nb + 1, dtype=np.int64)
    np.add.at(edge, lo // layers.DRAW_BLOCK, 1)
    np.add.at(edge, (lo + run - 1) // layers.DRAW_BLOCK + 1, -1)
    return np.cumsum(edge[:nb]) > 0


def _unstack(tree, n: int):
    """Stacked (n, ...) leaves -> n trees of per-layer views (one unbind
    per leaf, so autograd stacks the layer gradients back in one op)."""
    parts = {id(t): t.unbind(0) for _, t in leaf_items(tree)}
    return [map_tree(lambda t, i=i: parts[id(t)][i], tree) for i in range(n)]


def _write_(dst, src) -> None:
    """Copy the leaves of the tree ``src`` into ``dst``'s, in place."""
    for (_, d), (_, v) in zip(leaf_items(dst), leaf_items(src)):
        d.copy_(v)


def block_apply(p, x: torch.Tensor, cfg: ModelConfig, kind: str, *,
                positions: torch.Tensor, is_moe: bool = False, cache=None,
                step=None, ring=False, attend_fn=attention.attend, tp=None,
                d_ff: int | None = None):
    """One block -> ``(x, losses)``, the MoE block's router losses (empty
    without one).  With ``cache`` it decodes one token at position
    ``step`` and updates ``cache`` in place: attention writes the new key
    and value, a recurrent block its whole state (one step, chunk 1).
    ``d_ff``: a dense MLP's whole width (``_ffn_width``); ``tp`` the
    tensor-parallel group (a decode's ``cache`` is then the rank's
    block, :func:`init_caches`)."""
    h = layers.apply_norm(p["norm1"], x, cfg.norm)
    if kind == "attn":
        if cache is not None:
            out, _ = attention.attn_decode(p["mixer"], h, cfg, cache,
                                           step=step, ring=ring, tp=tp)
        else:
            out = attention.attn_apply(p["mixer"], h, cfg,
                                       positions=positions,
                                       attend_fn=attend_fn, tp=tp)
    else:
        if kind == "mlstm":
            out, new = (ssm.mlstm_block_apply(p["mixer"], h, cfg, tp=tp)
                        if cache is None else
                        ssm.mlstm_block_decode(p["mixer"], h, cfg, cache,
                                               tp))
        elif kind == "slstm":
            out, new = ssm.slstm_block_apply(p["mixer"], h, cfg, cache, tp)
        elif kind == "rglru":
            out, new = rglru_lib.rglru_block_apply(p["mixer"], h, cfg, cache,
                                                   tp)
        else:
            raise ValueError(f"unknown block kind {kind!r}")
        if cache is not None:
            _write_(cache, new)
    x = x + out.to(x.dtype)
    losses = {}
    if "ffn" in p:
        h = layers.apply_norm(p["norm2"], x, cfg.norm)
        if is_moe:
            out, losses = moe_lib.moe_apply(p["ffn"], h, cfg, tp=tp)
        else:
            out = mlp_lib.mlp_apply(p["ffn"], h, cfg, tp, d_ff)
        x = x + out.to(x.dtype)
    return x, losses


def block_cache_init(cfg: ModelConfig, kind: str, batch: int, max_len: int,
                     dtype: torch.dtype = torch.bfloat16, *, lead: tuple = (),
                     device="cpu"):
    """One block's zero decode cache (see the module doc); ``lead`` axes
    go in front (the stacked layers of a period).  Every leaf carries
    logical axes -- the attention cache and the mLSTM's cell state the
    JAX package's, the conv states ``("sub_batch", None, "state")``, the
    RG-LRU's h ``("sub_batch", "state")``, the sLSTM's state
    ``("sub_batch", "heads", None)`` -- and under an active
    ``use_sharding`` the rank allocates its block of each
    (``dist.sharding.local_shape``): its rows, and the channels or heads
    its tensor-parallel decode runs on."""
    from repro_torch.dist.sharding import local_shape
    if kind == "attn":
        return attention.init_cache(cfg, batch, max_len, dtype, lead=lead,
                                    device=device)
    conv_dtype = torch.promote_types(dtype,
                                     layers.dtype_of(cfg.compute_dtype))

    def conv_state(d):
        return torch.zeros((*lead, *local_shape(
            (batch, cfg.conv_width - 1, d), ("sub_batch", None, "state"))),
            dtype=conv_dtype, device=device)
    if kind == "mlstm":
        d_in = int(cfg.mlstm_proj_factor * cfg.d_model)
        H = cfg.num_heads
        return (ssm.mlstm_state_init(batch, H, d_in // H, d_in // H,
                                     lead=lead, device=device),
                conv_state(d_in))
    if kind == "slstm":
        return ssm.slstm_state_init(batch, cfg.num_heads,
                                    cfg.d_model // cfg.num_heads,
                                    lead=lead, device=device)
    if kind == "rglru":
        d_rnn = cfg.rglru_width or cfg.d_model
        return (torch.zeros((*lead, *local_shape(
            (batch, d_rnn), ("sub_batch", "state"))), dtype=torch.float32,
            device=device), conv_state(d_rnn))
    raise ValueError(f"unknown block kind {kind!r}")


def init_caches(cfg: ModelConfig, batch: int, max_len: int,
                dtype: torch.dtype = torch.bfloat16, *, device="cpu"):
    """Zero decode caches in the JAX layout (see module doc); under an
    active ``use_sharding`` the rank's blocks (:func:`block_cache_init`),
    ``batch`` the whole batch."""
    head, n_periods, period_kinds, _, tail = stack_layout(cfg)
    return {
        "head": [block_cache_init(cfg, kind, batch, max_len, dtype,
                                  device=device) for _, kind in head],
        "body": ([block_cache_init(cfg, kind, batch, max_len, dtype,
                                   lead=(n_periods,), device=device)
                  for kind in period_kinds] if n_periods > 0 else None),
        "tail": [block_cache_init(cfg, kind, batch, max_len, dtype,
                                  device=device) for _, kind in tail],
    }


def apply_stack(params, x: torch.Tensor, cfg: ModelConfig, *,
                positions: torch.Tensor, caches=None, step=None, ring=False,
                attend_fn=attention.attend, tp=None):
    """Head, body periods, then tail -> ``(x, aux)``: ``aux`` the router
    losses summed over the MoE blocks (``{"moe_aux", "moe_z"}``; empty for
    a config without MoE).  With ``caches`` every block decodes one token
    at position ``step`` and updates its cache in place."""
    head, n_periods, period_kinds, body_start, tail = stack_layout(cfg)
    aux: dict = {}

    def run(p, x, kind, cache, is_moe, layer_idx):
        x, losses = block_apply(p, x, cfg, kind, positions=positions,
                                is_moe=is_moe, cache=cache, step=step,
                                ring=ring, attend_fn=attend_fn, tp=tp,
                                d_ff=_ffn_width(cfg, layer_idx))
        for k, v in losses.items():
            aux[k] = aux[k] + v if k in aux else v
        return x

    for j, (i, kind) in enumerate(head):
        x = run(params["head"][j], x, kind,
                caches["head"][j] if caches is not None else None,
                cfg.is_moe_layer(i), i)
    if n_periods > 0:
        per_block = [_unstack(blk, n_periods) for blk in params["body"]]
        # select views (not unbind's), so the decode writes in place
        per_cache = ([[map_tree(lambda t, i=i: t[i], c)
                       for i in range(n_periods)] for c in caches["body"]]
                     if caches is not None else None)
        for i in range(n_periods):
            for j, kind in enumerate(period_kinds):
                x = run(per_block[j][i], x, kind,
                        per_cache[j][i] if per_cache is not None else None,
                        cfg.moe is not None and kind == "attn",
                        body_start + j)
    for j, (i, kind) in enumerate(tail):
        x = run(params["tail"][j], x, kind,
                caches["tail"][j] if caches is not None else None,
                cfg.is_moe_layer(i), i)
    return x, aux


def _embed_inputs(params, batch, cfg: ModelConfig, tp=None):
    """Token (and frontend prefix) embedding -> ``(x, positions,
    loss_mask)``, the steps of the JAX package's ``_embed_inputs``: the
    tokens embedded in the compute dtype; with a frontend and a batch
    that carries ``prefix_embeds`` (B, P, d_frontend), the projector
    ``proj2(gelu(proj1(prefix)))`` spliced in front of them and the loss
    mask ``False`` over the prefix, then the caller's ``loss_mask`` (or
    all ``True``); positions 0 .. S - 1 over the whole sequence; for
    ``pos="sinusoidal"`` the sinusoid added to all of it, the prefix
    included.  ``loss_mask`` is ``None`` when there is no prefix and the
    batch has none.  With ``tp`` a table split over the vocabulary is
    looked up vocab-parallel."""
    cdt = layers.dtype_of(cfg.compute_dtype)
    tokens = batch["tokens"]
    B, S_tok = tokens.shape
    x = layers.embed(params["embed"], tokens, cdt, _vocab_tp(
        params["embed"], cfg, tp))
    loss_mask = batch.get("loss_mask")
    if cfg.frontend is not None and "prefix_embeds" in batch:
        fe = params["frontend"]
        pe = layers.linear(fe["proj2"], activations.gelu(layers.linear(
            fe["proj1"], batch["prefix_embeds"], cdt)), cdt)
        x = torch.cat([pe, x], dim=1)
        pm = torch.zeros((B, pe.shape[1]), dtype=torch.bool,
                         device=x.device)
        tm = (loss_mask.bool() if loss_mask is not None else
              torch.ones((B, S_tok), dtype=torch.bool, device=x.device))
        loss_mask = torch.cat([pm, tm], dim=1)
    S = x.shape[1]
    positions = torch.arange(S, device=x.device)[None].expand(B, S)
    if cfg.pos == "sinusoidal":
        x = x + layers.sinusoidal_positions(positions, cfg.d_model).to(cdt)
    return x, positions, loss_mask


def _vocab_tp(table, cfg: ModelConfig, tp):
    """``tp`` where ``table`` is the rank's block of the vocabulary."""
    return tp if tp is not None and \
        table["table"].shape[0] != cfg.vocab_size else None


def _logits(params, x: torch.Tensor, cfg: ModelConfig,
            tp=None) -> torch.Tensor:
    """fp32 logits; with ``tp`` and a split table, the rank's block of
    the vocabulary."""
    table = params["embed"] if cfg.tie_embeddings else params["unembed"]
    logits = layers.unembed(table, x, layers.dtype_of(cfg.compute_dtype),
                            _vocab_tp(table, cfg, tp))
    return layers.softcap(logits.float(), cfg.logit_softcap)


def _nll(logits: torch.Tensor, labels: torch.Tensor, cfg: ModelConfig,
         tp=None) -> torch.Tensor:
    """Per-position NLL of ``labels`` under the log-softmax of the fp32
    ``logits``; vocab-parallel where ``logits`` are the rank's block."""
    if tp is not None and logits.shape[-1] != cfg.vocab_size:
        return tp.vocab_nll(logits, labels)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, labels[..., None])[..., 0]


def forward(params, batch, cfg: ModelConfig, tp=None):
    """Training forward.  batch: {tokens (B, S), labels (B, S)[,
    loss_mask (B, S)][, prefix_embeds (B, P, d_frontend)]}; with a
    frontend prefix the labels are left-padded with zeros over it and the
    prefix is masked out of the loss.  Returns (loss, metrics): the loss
    plus the summed router losses of an MoE config, whose metrics report
    ``moe_aux`` and ``moe_z`` beside the token loss ``loss``.  With ``tp``
    (a ``TensorParallel`` group) ``params`` are the rank's blocks of a
    :func:`tp_layout` and the forward is tensor-parallel; the loss and
    metrics are the same on every rank of the group."""
    x, positions, loss_mask = _embed_inputs(params, batch, cfg, tp)
    x, aux = apply_stack(params, x, cfg, positions=positions, tp=tp)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    logits = _logits(params, x, cfg, tp)
    labels = batch["labels"].long()
    if logits.shape[1] != labels.shape[1]:          # frontend prefix
        prefix = logits.shape[1] - labels.shape[1]
        labels = torch.cat([labels.new_zeros((labels.shape[0], prefix)),
                            labels], dim=1)
    if loss_mask is None:
        loss_mask = torch.ones(labels.shape, dtype=torch.bool,
                               device=labels.device)
    nll = _nll(logits, labels, cfg, tp)
    denom = torch.clamp(loss_mask.sum(), min=1)
    loss = (nll * loss_mask).sum() / denom
    total = loss + sum(aux.values()) if aux else loss
    metrics = {"loss": loss, **aux,
               "ppl_proxy": torch.exp(torch.clamp(loss, 0.0, 20.0))}
    return total, metrics


def decode_step(params, token: torch.Tensor, caches, step: int,
                cfg: ModelConfig, *, max_len: int, tp=None):
    """One-token serve step.  token: (B, 1) -> (logits (B, 1, V) fp32,
    caches), the caches updated in place and returned.  With ``tp`` (a
    ``TensorParallel`` serving group) ``params`` are the rank's blocks of
    a :func:`tp_layout`, ``caches`` its blocks (:func:`init_caches` under
    the same rules) and ``token`` its rows; the logits are the rank's
    block of the vocabulary where the table splits (``TensorParallel.
    vocab_argmax`` picks the greedy token across the blocks)."""
    cdt = layers.dtype_of(cfg.compute_dtype)
    with allowed("recompile", "the decode position is a Python int, so each "
                 "position is a program of its own: ROADMAP perf item 1 "
                 "(CUDA graphs)"):
        x = layers.embed(params["embed"], token, cdt,
                         _vocab_tp(params["embed"], cfg, tp))
        if cfg.pos == "sinusoidal":
            pos = torch.full(token.shape, int(step), device=token.device)
            x = x + layers.sinusoidal_positions(pos, cfg.d_model).to(cdt)
        x, _ = apply_stack(params, x, cfg, positions=None, caches=caches,
                           step=int(step),
                           ring=attention.cache_is_ring(cfg, max_len), tp=tp)
        x = layers.apply_norm(params["final_norm"], x, cfg.norm)
        return _logits(params, x, cfg, tp), caches


def prefill(params, batch, cfg: ModelConfig, tp=None) -> torch.Tensor:
    """Full-sequence forward returning fp32 logits (B, S, V): the inference
    prefill path, attention through ``flash_attention``.  batch:
    {tokens (B, S_tok)[, prefix_embeds (B, P, d_frontend)]}; with a
    frontend prefix S = P + S_tok, the prefix's positions first.  With
    ``tp`` the training forward's tensor-parallel path on the rank's
    blocks, attention through ``flash_attention`` on each rank (its heads,
    or every head where they do not divide over the group); the logits
    are the rank's block of the vocabulary where the table splits."""
    x, positions, _ = _embed_inputs(params, batch, cfg, tp)
    x, _ = apply_stack(params, x, cfg, positions=positions,
                       attend_fn=flash_attention, tp=tp)
    x = layers.apply_norm(params["final_norm"], x, cfg.norm)
    return _logits(params, x, cfg, tp)
