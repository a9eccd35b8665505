"""Primitive layers as functions on tensors (port of
``repro/models/layers.py``).

Parameters are plain dicts of tensors.  Numerics follow the JAX package:
``linear``/``unembed`` take operands in the compute dtype and return the
compute dtype (on the card a bf16 product accumulates in fp32: the entry
points turn off cuBLAS's reduced-precision bf16 reduction); norms run in
fp32 and cast back; sinusoidal positions are fp32 and the caller casts
them; RoPE rotates *interleaved* pairs (x[..., 0::2],
x[..., 1::2]), not the rotate-half layout.

Shape trees carry the JAX init's logical axes: a :func:`meta` leaf's
``axes`` (``linear_shapes``' ``w`` ``("embed", "mlp")`` unless the caller
names others, its ``b`` the last of them; the tables ``("vocab",
"embed")``), from which ``repro_torch.dist.sharding.param_layout`` splits
a leaf over the mesh's ``model`` axis.  Under tensor parallelism
(``tp``, a ``repro_torch.dist.tensor_parallel.TensorParallel``) a
column-parallel product is :func:`linear` on the rank's column block of
``w`` (and of ``b``), its input passed through ``tp.copy`` by the caller;
:func:`row_linear` is the row-parallel product, and :func:`embed` /
:func:`unembed` take the rank's block of the vocabulary.
"""

from __future__ import annotations

import math

import torch

from repro_torch.analysis.trace import allowed
from repro_torch.models import activations


def dtype_of(name: str) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16,
            "float16": torch.float16}[name]


DRAW_BLOCK = 1 << 24


def block_seed(seed: int, leaf: int, block: int) -> int:
    """Seed of block ``block`` of leaf ``leaf``'s draw.  The CPU generator
    keeps the low 32 bits of a seed: these stay distinct for fewer than
    4,294 leaves of fewer than 1,000,003 blocks each."""
    return ((int(seed) * 1_000_003 + int(leaf)) * 1_000_003
            + int(block)) % (2 ** 63)


def draw_blocks_(jobs) -> None:
    """Fill tensors in place, block by block, across host threads.

    ``jobs`` is an iterable of ``(t, seed, leaf, fill[, need])``: ``t`` a
    contiguous CPU tensor, ``fill(block, gen)`` filling a flat block in
    place from a generator, ``need`` a boolean mask of the blocks to draw
    (default: all; the others stay as they are).  ``t`` is cut into
    blocks of ``DRAW_BLOCK`` entries, block b drawn from its own
    ``torch.Generator`` seeded with ``block_seed(seed, leaf, b)``, so the
    values do not depend on the number of threads (``os.cpu_count()``),
    on the order the blocks run in, or on which others are drawn.  Torch
    releases the GIL inside its ops, so the blocks draw in parallel."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    def one(block, seed, leaf, b, fill):
        gen = torch.Generator()
        gen.manual_seed(block_seed(seed, leaf, b))
        fill(block, gen)

    work = []
    for t, seed, leaf, fill, *need in jobs:
        flat = t.view(-1)
        for b, start in enumerate(range(0, flat.numel(), DRAW_BLOCK)):
            if not need or need[0] is None or need[0][b]:
                work.append((flat[start:start + DRAW_BLOCK], seed, leaf, b,
                             fill))
    with ThreadPoolExecutor(max_workers=os.cpu_count()) as pool:
        for fut in [pool.submit(one, *w) for w in work]:
            fut.result()


def truncated_normal_(t: torch.Tensor, fan_in: int, scale: float,
                      gen: torch.Generator) -> torch.Tensor:
    """He-style fan-in init in place: N(0, 1) truncated to [-2, 2] times
    scale / sqrt(fan_in).  ``t`` is a contiguous CPU tensor (one block of
    :func:`draw_blocks_`).  A draw outside [-2, 2] is drawn again
    (rejection, the truncated law), and only those ~4.6 % are: one pass of
    normals, where ``nn.init.trunc_normal_`` redraws the whole tensor until
    no draw is out (~7 passes; 9.4e9 weights would take minutes), and a
    stream that does not depend on the torch version's sampler."""
    std = scale / max(fan_in, 1) ** 0.5
    flat = t.view(-1)
    flat.normal_(generator=gen)
    out = (flat.abs() > 2.0).nonzero().squeeze(1)
    while out.numel():
        flat[out] = torch.empty(out.numel()).normal_(generator=gen)
        out = out[flat[out].abs() > 2.0]
    return t.mul_(std)


def meta(*shape, axes=None) -> torch.Tensor:
    """A shape-only leaf (``meta`` device) of a parameter-shape tree, its
    logical ``axes`` (one a dimension, ``None`` for no axis) as its
    ``axes`` attribute (``None``: replicated)."""
    t = torch.empty(shape, device="meta")
    t.axes = tuple(axes) if axes is not None else None
    return t


# ---------------------------------------------------------------------------
# linear
# ---------------------------------------------------------------------------

def linear_shapes(d_in: int, d_out: int, *, lead: tuple = (),
                  use_bias: bool = False,
                  axes: tuple = ("embed", "mlp")) -> dict:
    """``linear_init``'s leaves as shapes with its logical ``axes`` (``b``
    takes the last); ``lead`` axes go in front, with no logical axis."""
    none = (None,) * len(lead)
    p = {"w": meta(*lead, d_in, d_out, axes=none + tuple(axes))}
    if use_bias:
        p["b"] = meta(*lead, d_out, axes=none + tuple(axes[-1:]))
    return p


LOW_PRECISION = (torch.bfloat16, torch.float16)


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (``b`` 2-D, or both batched 3-D) written in fp32 from
    low-precision operands: on the card the tensor cores' product with an
    fp32 output (``torch.mm`` / ``torch.bmm`` with ``out_dtype``); on the
    CPU, which has no such kernel, the operands upcast first (each product
    of two bf16 values is exact in fp32)."""
    if a.device.type != "cuda":
        return torch.matmul(a.float(), b.float())
    if b.dim() == 2:
        return torch.mm(a.reshape(-1, a.shape[-1]), b,
                        out_dtype=torch.float32).reshape(
                            *a.shape[:-1], b.shape[-1])
    return torch.bmm(a, b, out_dtype=torch.float32)


def _grad_w(a: torch.Tensor, g: torch.Tensor, batched: bool):
    """The gradient of ``b`` in ``a @ b`` (``b`` 2-D unless ``batched``)."""
    if batched:
        return a.transpose(-1, -2) @ g
    return a.reshape(-1, a.shape[-1]).T @ g.reshape(-1, g.shape[-1])


class _ProductF32(torch.autograd.Function):
    """``a @ b`` of low-precision operands with an fp32 result
    (:func:`_mm_f32`).  The backward is the low-precision product's own:
    the gradient cast to ``a``'s dtype, as a compute-dtype product's
    gradient arrives."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _mm_f32(a, b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = g.to(a.dtype)
        ga = torch.matmul(g, b.transpose(-1, -2)) \
            if ctx.needs_input_grad[0] else None
        gb = _grad_w(a, g, b.dim() == 3) if ctx.needs_input_grad[1] else None
        return ga, gb


class _Fp32Input(torch.autograd.Function):
    """``x.to(w.dtype) @ w`` for an fp32 ``x`` and a low-precision ``w``
    whose gradient of ``x`` comes back in fp32 (:func:`_mm_f32`), as
    JAX's transposed product with ``preferred_element_type=jnp.float32``
    gives it, not rounded to the compute dtype first."""

    @staticmethod
    def forward(ctx, x, w):
        xc = x.to(w.dtype)
        ctx.save_for_backward(xc, w)
        return torch.matmul(xc, w)

    @staticmethod
    def backward(ctx, g):
        xc, w = ctx.saved_tensors
        gx = _mm_f32(g, w.transpose(-1, -2)) \
            if ctx.needs_input_grad[0] else None
        gw = _grad_w(xc, g, w.dim() == 3) if ctx.needs_input_grad[1] \
            else None
        return gx, gw


def matmul_c(x: torch.Tensor, w: torch.Tensor,
             compute_dtype: torch.dtype) -> torch.Tensor:
    """``x @ w`` with both operands in the compute dtype.  Where ``x`` is
    fp32 at a lower compute dtype and needs a gradient (a column-parallel
    input: ``TensorParallel.copy`` carries it in fp32), that gradient is
    the fp32 partial product the copy sums over its group
    (:class:`_Fp32Input`)."""
    wc = w.to(compute_dtype)
    if x.dtype == torch.float32 and compute_dtype in LOW_PRECISION \
            and x.requires_grad and torch.is_grad_enabled():
        return _Fp32Input.apply(x, wc)
    return torch.matmul(x.to(compute_dtype), wc)


def linear(p, x: torch.Tensor, compute_dtype: torch.dtype) -> torch.Tensor:
    y = matmul_c(x, p["w"], compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


def product_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (``b`` 2-D, or both batched 3-D) in fp32 from operands
    in a compute dtype, as JAX's ``preferred_element_type=jnp.float32``
    contracts: the partial products a row-parallel layer sums over its
    group, so that the sum runs in fp32 and one cast follows it."""
    if a.dtype == torch.float32 and b.dtype == torch.float32:
        return torch.matmul(a, b)
    return _ProductF32.apply(a, b)


def row_linear(p, x: torch.Tensor, compute_dtype: torch.dtype,
               tp=None) -> torch.Tensor:
    """The second product of a block (attention's ``wo``, the MLP's
    ``down``).  With ``tp`` it is row-parallel: ``x`` and ``w`` are the
    rank's blocks of the contraction, the partial products (fp32,
    :func:`product_f32`) are summed over the group in fp32 and cast to
    the compute dtype once, after the sum, as JAX's partitioned
    ``linear`` all-reduces its fp32 product before the cast; the bias
    (replicated: JAX's ``b`` axis is ``embed``) is added once, after
    that."""
    if tp is None:
        return linear(p, x, compute_dtype)
    y = tp.reduce(product_f32(x.to(compute_dtype),
                              p["w"].to(compute_dtype))).to(compute_dtype)
    if "b" in p:
        y = y + p["b"].to(compute_dtype)
    return y


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def norm_shapes(d: int, kind: str = "rmsnorm", *, lead: tuple = ()) -> dict:
    """``norm_init``'s leaves as shapes (unit scale, zero bias)."""
    p = {"scale": meta(*lead, d)}
    if kind == "layernorm":
        p["bias"] = meta(*lead, d)
    return p


def apply_norm(p, x: torch.Tensor, kind: str = "rmsnorm",
               eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    if kind == "rmsnorm":
        y = xf * torch.rsqrt((xf * xf).mean(dim=-1, keepdim=True) + eps)
    elif kind == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    else:
        raise ValueError(kind)
    y = y * p["scale"].float()
    if "bias" in p:
        y = y + p["bias"].float()
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------

def embed(p, ids: torch.Tensor, compute_dtype: torch.dtype,
          tp=None) -> torch.Tensor:
    """Rows of the table.  With ``tp`` the table is the rank's block of
    the vocabulary (block ``tp.index``): ids outside it look up row 0 and
    are zeroed, and the group's lookups are summed (one rank's row and
    zeros: exact)."""
    if tp is None:
        return p["table"][ids.long()].to(compute_dtype)
    Vl = p["table"].shape[0]
    lo = tp.index * Vl
    ids = ids.long()
    inside = (ids >= lo) & (ids < lo + Vl)
    rows = p["table"][torch.where(inside, ids - lo, 0)].to(compute_dtype)
    with allowed("precision", "one rank's row and zeros: the sum is exact "
                 "in any dtype"):
        return tp.reduce(torch.where(inside[..., None], rows,
                                     torch.zeros_like(rows)))


def unembed(p, x: torch.Tensor, compute_dtype: torch.dtype,
            tp=None) -> torch.Tensor:
    """Logits against the (tied or untied) table, in the compute dtype;
    with ``tp`` this rank's block of the vocabulary's logits (its input
    through ``tp.copy``)."""
    if tp is not None:
        x = tp.copy(x)
    return matmul_c(x, p["table"].T, compute_dtype)


# ---------------------------------------------------------------------------
# positions
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, rope_fraction: float = 1.0,
               theta: float = 10000.0, device=None):
    """Inverse frequencies for the rotated fraction of head_dim."""
    rot = int(head_dim * rope_fraction)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta: float = 10000.0,
               rope_fraction: float = 1.0) -> torch.Tensor:
    """x: (..., seq, head_dim), positions: (..., seq) int."""
    inv, rot = rope_freqs(x.shape[-1], rope_fraction, theta, x.device)
    if rot == 0:
        return x
    ang = positions[..., None].float() * inv          # (..., seq, rot/2)
    cos, sin = torch.cos(ang), torch.sin(ang)
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x1 * sin + x2 * cos
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


def sinusoidal_positions(positions: torch.Tensor,
                         d_model: int) -> torch.Tensor:
    """Classic transformer sinusoids, fp32: positions (..., seq) ->
    (..., seq, d_model), ``[sin, cos]`` concatenated (not interleaved)."""
    half = d_model // 2
    freq = torch.exp(-math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=positions.device) / half)
    ang = positions[..., None].float() * freq
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def softcap(x: torch.Tensor, cap: float) -> torch.Tensor:
    """tanh soft-capping (off when cap is 0)."""
    if cap and cap > 0:
        return activations.tanh(x / cap) * cap
    return x
