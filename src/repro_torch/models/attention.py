"""GQA attention: the training forward, prefill and cached decode (port of
``repro/models/attention.py``).

Three paths, chosen by which function the caller runs (there is no
switch):

* ``attend`` -- the training forward's attention: the flash kernel's
  plain version (``kernels.flash_attn.ref.flash_attn_plain``), plain
  tensor code with autograd.  It computes what the JAX package's
  ``xla_flash`` computes -- causal (and optionally sliding-window) softmax
  attention with fp32 scores, the finite ``NEG`` mask value and queries
  aligned to the tail of the keys -- over the whole sequence; at the
  training lengths of the port one key chunk covers the sequence, where
  ``xla_flash``'s online softmax reduces to exactly this.  The JAX
  training path uses XLA attention too.
* ``kernels.flash_attn.ops.flash_attention`` -- prefill: the Hopper
  flash-attention kernel on the card, its plain version on the CPU.
  ``transformer.prefill`` passes it down as ``attend_fn``.
* ``attn_decode`` -- one token against a (possibly ring) KV cache: scores
  as plain tensor code (``torch.matmul``), as the JAX package computes
  them outside any kernel.

Layout: activations (B, S, d_model); caches {"k", "v"} of (B, KV,
cache_len, head_dim); the decode position is one step count for the
whole batch.

Tensor parallelism (the training forward's ``tp``): ``wq`` / ``wk`` /
``wv`` are column-parallel and ``wo`` row-parallel over ``qkv`` where the
rank holds a block of it.  Where the heads and the KV heads both divide
over the ranks, each rank's block is whole heads of aligned GQA groups and
attention runs on its local heads; otherwise (smollm-360m's 15 / 5 heads
on 2 ranks) the blocks end mid-head: q, k and v are gathered over the
group before RoPE, attention runs on every head on every rank, and its
output is split back to the rank's ``qkv`` block before ``wo``.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attn.ref import NEG, flash_attn_plain
from repro_torch.models import layers
from repro_torch.models.config import ModelConfig


# The training forward's attention: the flash kernel's plain version, which
# has autograd (the kernel has no backward).
attend = flash_attn_plain


def _project(p, x: torch.Tensor, cfg: ModelConfig, tp):
    """q, k, v as (B, S, width) and whether they hold the rank's heads
    only (else every head): column-parallel where the rank holds a
    ``qkv`` block of the weight, gathered unless the heads divide."""
    cdt = layers.dtype_of(cfg.compute_dtype)
    full = {"wq": cfg.num_heads * cfg.head_dim,
            "wk": cfg.num_kv_heads * cfg.head_dim,
            "wv": cfg.num_kv_heads * cfg.head_dim}
    split = {n: tp is not None and p[n]["w"].shape[-1] != w
             for n, w in full.items()}
    xc = tp.copy(x) if any(split.values()) else x
    ys = {n: layers.linear(p[n], xc if split[n] else x, cdt) for n in full}
    if not any(split.values()):
        return ys["wq"], ys["wk"], ys["wv"], False
    if all(split.values()) and cfg.num_heads % tp.parts == 0 \
            and cfg.num_kv_heads % tp.parts == 0:
        return ys["wq"], ys["wk"], ys["wv"], True
    names = [n for n in full if split[n]]
    G = tp.gather(torch.cat([ys[n] for n in names], dim=-1))
    off = 0
    for n in names:
        w = ys[n].shape[-1]
        ys[n] = torch.cat([G[m][..., off:off + w] for m in range(tp.parts)],
                          dim=-1)
        off += w
    return ys["wq"], ys["wk"], ys["wv"], False


def _project_qkv(p, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, tp=None):
    """(B, heads, S, hd) q, k, v, RoPE applied; with ``tp`` the rank's
    heads where they divide over the group, else every head."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    q, k, v, _ = _project(p, x, cfg, tp)
    q = q.reshape(B, S, -1, hd).transpose(1, 2)
    k = k.reshape(B, S, -1, hd).transpose(1, 2)
    v = v.reshape(B, S, -1, hd).transpose(1, 2)
    if cfg.pos == "rope":
        pos = positions[:, None, :]
        q = layers.apply_rope(q, pos, theta=cfg.rope_theta,
                              rope_fraction=cfg.rope_fraction)
        k = layers.apply_rope(k, pos, theta=cfg.rope_theta,
                              rope_fraction=cfg.rope_fraction)
    return q, k, v


def attn_apply(p, x: torch.Tensor, cfg: ModelConfig, *,
               positions: torch.Tensor, attend_fn=attend,
               tp=None) -> torch.Tensor:
    """Training / prefill path.  x: (B, S, d) -> (B, S, d).  ``attend_fn``
    is ``attend`` (training) or ``flash_attention`` (prefill); ``tp`` the
    training forward's tensor-parallel group (module docstring)."""
    B, S, _ = x.shape
    q, k, v = _project_qkv(p, x, cfg, positions, tp)
    o = attend_fn(q, k, v, causal=True, window=cfg.window)
    return _out(p, o.transpose(1, 2).reshape(B, S, -1), cfg, tp)


def _out(p, o: torch.Tensor, cfg: ModelConfig, tp) -> torch.Tensor:
    """``wo`` on the heads' output ``o``: row-parallel where the rank holds
    a ``qkv`` block of it, ``o`` first cut to that block where it holds
    every head."""
    cdt = layers.dtype_of(cfg.compute_dtype)
    rows = p["wo"]["w"].shape[-2]
    if tp is None or rows == cfg.num_heads * cfg.head_dim:
        return layers.row_linear(p["wo"], o, cdt)
    if o.shape[-1] != rows:             # every head here: the rank's block
        o = tp.split(o)
    return layers.row_linear(p["wo"], o, cdt, tp)


def cache_is_ring(cfg: ModelConfig, max_len: int) -> bool:
    return cfg.window is not None and cfg.window < max_len


CACHE_AXES = ("sub_batch", "kv_heads", "cache_seq", "head_dim")


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.bfloat16, *, lead: tuple = (),
               device="cpu") -> dict:
    """Ring buffer of size window for SWA archs, else full-length cache;
    ``lead`` axes go in front (the stacked layers of a period).  The
    cache carries the JAX package's logical axes :data:`CACHE_AXES`:
    under an active ``use_sharding`` the rank allocates only its block
    (``dist.sharding.local_shape``), e.g. its rows of the batch and its KV
    heads or its block of ``head_dim``."""
    from repro_torch.dist.sharding import local_shape
    clen = cfg.window if cache_is_ring(cfg, max_len) else max_len
    shape = (*lead, *local_shape(
        (batch, cfg.num_kv_heads, clen, cfg.head_dim), CACHE_AXES))
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attn_decode(p, x: torch.Tensor, cfg: ModelConfig, cache: dict, *,
                step: int, ring: bool, tp=None):
    """One-token decode.  x: (B, 1, d); step: the absolute position.

    Writes the new key and value into ``cache`` **in place** (slot
    ``step % clen`` of a ring buffer, else ``min(step, clen - 1)``), where
    the JAX package returns an updated copy: that saves a copy of every
    layer's cache per token.  Returns ``(out, cache)`` with the same cache
    dict.

    With ``tp`` (the serving group; ``cache`` the rank's block,
    :func:`init_cache`) the layout is read off the cache's shape, one of
    the three ``launch.dryrun.rules_for`` gives:

    * KV heads split: the rank's heads, whole GQA groups (q / k / v from
      its column blocks), attend to its KV heads; ``wo`` row-parallel;
    * ``head_dim`` split (its heads split or replicated): q, k and v are
      gathered whole (as the training forward's mid-head path gathers
      them), the rank writes its ``head_dim`` block of the new key and
      value, its scores are partial sums over that block, summed over
      the group before the softmax (kind ``tp_cache_scores``); its output
      is every head's ``head_dim`` block, gathered whole (kind
      ``tp_cache_out``) and cut to the rank's ``qkv`` rows of ``wo``;
    * replicated: every head on every rank, the output cut to the rank's
      rows of ``wo``.
    """
    B = x.shape[0]
    hd = cfg.head_dim
    positions = torch.full((B, 1), step, dtype=torch.long, device=x.device)
    q, k_new, v_new = _project_qkv(p, x, cfg, positions, tp)  # (B,*,1,hd)

    k, v = cache["k"], cache["v"]
    KVl, clen, hdl = k.shape[1], k.shape[2], k.shape[3]
    if k_new.shape[1] != KVl:
        raise ValueError(f"attn_decode: the cache holds {KVl} KV heads, "
                         f"the projection gives {k_new.shape[1]}")
    lo = tp.index * hdl if hdl != hd else 0
    slot = step % clen if ring else min(step, clen - 1)
    k[:, :, slot] = k_new[:, :, 0, lo:lo + hdl].to(k.dtype)
    v[:, :, slot] = v_new[:, :, 0, lo:lo + hdl].to(v.dtype)

    idx = torch.arange(clen, device=x.device)
    filled = (idx <= step) | (step >= clen) if ring else idx <= step
    Hl = q.shape[1]
    qg = q[..., lo:lo + hdl].reshape(B, KVl, Hl // KVl, 1, hdl).float()
    s = torch.matmul(qg, k.float()[:, :, None].transpose(-1, -2))
    if hdl != hd:
        s = tp.all_reduce_(s.contiguous(), "tp_cache_scores")
    s = torch.where(filled, s * (hd ** -0.5), torch.full_like(s, NEG))
    w = torch.softmax(s, dim=-1)
    o = torch.matmul(w, v.float()[:, :, None])           # (B,KV,G,1,hdl)
    if hdl != hd:
        o = torch.cat(list(tp.all_gather(o.contiguous(), "tp_cache_out")
                           .unbind(0)), dim=-1)
    return _out(p, o.reshape(B, 1, Hl * hd).to(x.dtype), cfg, tp), cache
