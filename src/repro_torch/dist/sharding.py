"""Logical-axis sharding rules and the gradient stack's coordinate shards
(port of ``repro/dist/sharding.py``).

Model code in the JAX package annotates values with *logical* axes
(``shard(x, ("sub_batch", "seq", "embed"))``); a launcher activates a
mesh plus a logical->mesh translation with :func:`use_sharding`, and
every annotation becomes a GSPMD sharding constraint.  The port keeps the
vocabulary, the rules and their resolution (:func:`logical_spec`), so a
launcher decides the same layout from the same mesh: the sharded train
step splits its workers over the mesh exactly where the ``worker`` rule
resolves to a mesh axis, and :func:`param_layout` splits a parameter leaf
over ``model`` exactly where its logical axes (those the JAX package's
init annotates, carried by ``repro_torch.models`` as the ``axes`` of the
shape tree's leaves) resolve to it: each rank holds the block GSPMD would
place on its device.  Activations are not annotated: the tensor-parallel
model code (``repro_torch.dist.tensor_parallel``) places them itself, and
:func:`shard` checks an annotation's rank and returns the tensor
unchanged.

Resolution rules (in priority order):

  1. ``None`` logical entries and names missing from the rule set resolve to
     unconstrained dimensions.
  2. A rule value may be a mesh-axis name, a tuple of mesh axes (the dim is
     sharded over their product, e.g. ``worker -> ("pod", "data")``), or
     ``None`` (explicitly replicated).
  3. A mesh axis is consumed at most once per value; later dimensions that
     map to an already-used axis stay unconstrained.
  4. A dimension whose size does not divide the mapped axis product stays
     unconstrained rather than erroring.

The counterpart of the JAX package's ``shard_grad_stack`` is
:class:`CoordShards`, the layout of the gradient stack's coordinate
shards: every leaf of ``n`` coordinates is zero-padded to ``shards *
chunk`` (``chunk = ceil(n / shards)``) and shard ``s`` holds its columns
``[s * chunk, (s + 1) * chunk)``; a rank's buffer is its blocks of every
leaf, concatenated in canonical leaf order into one contiguous ``(W,
sum chunk)`` array -- the JAX package's ``_to_view`` layout, so a sketched
Gram samples the same local chunk stream as JAX's per-shard ``tree_gram``.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from contextvars import ContextVar
from dataclasses import dataclass
from typing import Any, Mapping, Sequence

import torch

from repro_torch.launch.mesh import Mesh
from repro_torch.weights import TPLayout, layout_of, leaf_items

__all__ = ["shard", "use_sharding", "current_mesh", "current_rules",
           "logical_spec", "DEFAULT_RULES", "CoordShards", "resolve_rules",
           "param_layout", "local_block", "local_shape"]


# Logical axis vocabulary (that of the JAX package's model substrate):
#   worker      -- the FA worker axis of worker-major batches / gradients
#   batch       -- global data batch (training inputs)
#   sub_batch   -- per-worker batch inside the loss
#   seq / cache_seq -- sequence and KV-cache length
#   embed       -- d_model residual stream
#   vocab       -- embedding / unembedding vocabulary dim
#   mlp / qkv   -- FFN hidden and attention projection contraction dims
#   heads / kv_heads / head_dim -- attention head layout
#   experts / expert_mlp -- MoE expert bank layout
#   state       -- recurrent-cell widths (rglru / xLSTM)
#   grad_worker / grad_coord -- the worker-major gradient stack under
#     sharded aggregation: the worker axis replicated (every rank holds
#     all W rows of its coordinate shard), the coordinates spread over the
#     whole mesh.
DEFAULT_RULES: dict[str, Any] = {
    "worker": ("data",),
    "batch": ("data",),
    "grad_worker": None,
    "grad_coord": ("data", "model"),
    "sub_batch": None,
    "seq": None,
    "cache_seq": None,
    "embed": None,
    "vocab": "model",
    "mlp": "model",
    "qkv": "model",
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "experts": None,
    "expert_mlp": "model",
    "state": "model",
}


@dataclass(frozen=True)
class _ShardCtx:
    mesh: Mesh
    rules: Mapping[str, Any]


_CTX: ContextVar[_ShardCtx | None] = ContextVar("repro_torch_shard_ctx",
                                                default=None)


def current_mesh() -> Mesh | None:
    ctx = _CTX.get()
    return ctx.mesh if ctx else None


def current_rules() -> Mapping[str, Any] | None:
    ctx = _CTX.get()
    return ctx.rules if ctx else None


@contextmanager
def use_sharding(mesh: Mesh, rules: Mapping[str, Any] | None = None):
    """Activate ``mesh`` + logical rules inside the ``with`` block.

    ``rules`` overrides :data:`DEFAULT_RULES` per logical name.  On a mesh
    with a ``pod`` axis the ``worker`` / ``batch`` defaults widen to
    ``(pod, data)`` and ``grad_coord`` to ``(pod, data, model)`` before
    the overrides apply.  On exit the previous context is restored."""
    token = _CTX.set(_ShardCtx(mesh, resolve_rules(mesh, rules)))
    try:
        yield
    finally:
        _CTX.reset(token)


def resolve_rules(mesh: Mesh, rules: Mapping[str, Any] | None = None
                  ) -> dict[str, Any]:
    """The rules :func:`use_sharding` activates for ``mesh`` and the
    overrides ``rules``."""
    resolved = dict(DEFAULT_RULES)
    if "pod" in mesh.shape:
        resolved["worker"] = ("pod", "data")
        resolved["batch"] = ("pod", "data")
        resolved["grad_coord"] = ("pod", "data", "model")
    if rules:
        resolved.update(rules)
    return resolved


def _as_axis_tuple(mapped: Any) -> tuple[str, ...]:
    if mapped is None:
        return ()
    if isinstance(mapped, str):
        return (mapped,)
    return tuple(mapped)


def logical_spec(shape: Sequence[int], axes: Sequence[str | None],
                 mesh: Mesh, rules: Mapping[str, Any]) -> tuple:
    """Translate logical ``axes`` to partition entries under ``rules``:
    per dimension ``None``, one mesh-axis name or a tuple of names, as the
    entries of JAX's ``PartitionSpec`` (resolution rules in the module
    docstring)."""
    if len(axes) != len(shape):
        raise ValueError(f"logical axes {tuple(axes)} do not match "
                         f"rank-{len(shape)} value of shape {tuple(shape)}")
    used: set[str] = set()
    entries: list[Any] = []
    for dim, name in zip(shape, axes):
        mapped = rules.get(name) if name is not None else None
        axs = tuple(a for a in _as_axis_tuple(mapped)
                    if a in mesh.shape and a not in used)
        size = math.prod(mesh.shape[a] for a in axs) if axs else 1
        if axs and size > 1 and dim % size == 0:
            entries.append(axs if len(axs) > 1 else axs[0])
            used.update(axs)
        else:
            entries.append(None)
    return tuple(entries)


def param_layout(tree, mesh: Mesh, rules: Mapping[str, Any],
                 rank: int = 0) -> TPLayout:
    """The tensor-parallel layout of the parameter shape ``tree`` (leaves
    with ``shape`` and ``axes``, the logical axes of the JAX package's
    init; a leaf without ``axes`` is replicated) on ``mesh`` under
    ``rules``, for the rank ``rank`` of the mesh: leaf i splits its
    dimension ``dims[i]`` over ``model`` where :func:`logical_spec`
    resolves it there, and the rank holds block ``coords(rank)["model"]``.
    A parameter dimension resolved to another mesh axis raises
    ``NotImplementedError``: only ``model`` partitions weights."""
    dims = []
    for path, t in leaf_items(tree):
        axes = getattr(t, "axes", None) or (None,) * t.dim()
        d = None
        for j, e in enumerate(logical_spec(tuple(t.shape), axes, mesh,
                                           rules)):
            if e is None:
                continue
            if e != "model":
                raise NotImplementedError(
                    f"parameter {path} resolves dimension {j} to {e!r}: "
                    "only the model axis partitions weights")
            d = j
        dims.append(d)
    return TPLayout(layout_of(tree), tuple(dims), mesh.shape.get("model", 1),
                    mesh.coords(rank).get("model", 0))


def local_block(shape: Sequence[int], axes: Sequence[str | None],
                rank: int | None = None) -> tuple[slice, ...]:
    """This rank's block of a value of ``shape`` with logical ``axes``
    under the active :func:`use_sharding` (one slice a dimension; the
    whole value without an active mesh): a dimension :func:`logical_spec`
    resolves to mesh axes is cut into their product's blocks, block index
    row-major over those axes in the rule's order, as a ``PartitionSpec``
    entry places them.  ``rank`` defaults to this process's rank in the
    default group (0 without one)."""
    ctx = _CTX.get()
    if ctx is None:
        return tuple(slice(0, n) for n in shape)
    if rank is None:
        import torch.distributed as dist
        rank = dist.get_rank() if dist.is_initialized() else 0
    coords = ctx.mesh.coords(rank)
    out = []
    for n, e in zip(shape, logical_spec(tuple(shape), axes, ctx.mesh,
                                        ctx.rules)):
        idx, parts = 0, 1
        for a in _as_axis_tuple(e):
            idx, parts = idx * ctx.mesh.shape[a] + coords[a], \
                parts * ctx.mesh.shape[a]
        k = n // parts
        out.append(slice(idx * k, (idx + 1) * k))
    return tuple(out)


def local_shape(shape: Sequence[int], axes: Sequence[str | None],
                rank: int | None = None) -> tuple[int, ...]:
    """The shape of :func:`local_block`'s block."""
    return tuple(s.stop - s.start for s in local_block(shape, axes, rank))


def shard(x: torch.Tensor, axes: Sequence[str | None]) -> torch.Tensor:
    """Check ``x``'s logical ``axes`` against the active mesh and return
    ``x``: activations are placed by the model code itself, so no layout
    is applied.  Under
    an active :func:`use_sharding` a rank mismatch raises ``ValueError``,
    as the JAX package's constraint does; without one ``x`` comes back
    unchecked, as there."""
    ctx = _CTX.get()
    if ctx is not None:
        logical_spec(tuple(x.shape), axes, ctx.mesh, ctx.rules)
    return x


@dataclass(frozen=True)
class CoordShards:
    """The coordinate-shard layout of a worker-major gradient stack whose
    leaves have ``sizes`` coordinates each (canonical order), split into
    ``shards`` shards (module docstring).  Buffers in three layouts:

    * canonical: ``(..., N)``, leaf i at ``flat_offsets[i]``;
    * padded: ``(padded_numel,)``, leaf i at ``padded_offsets[i]``,
      ``shards * chunks[i]`` wide, its first ``sizes[i]`` entries the
      leaf (so a leaf's gradient is one contiguous view) and the rest 0;
    * local: ``(..., width)``, one shard's ``chunks[i]`` columns of leaf i
      at ``offsets[i]``."""

    sizes: tuple[int, ...]
    shards: int

    @property
    def chunks(self) -> tuple[int, ...]:
        return tuple(-(-n // self.shards) for n in self.sizes)

    @property
    def width(self) -> int:
        return sum(self.chunks)

    @property
    def numel(self) -> int:
        return sum(self.sizes)

    @property
    def padded_numel(self) -> int:
        return self.shards * self.width

    @staticmethod
    def _cumsum(xs) -> tuple[int, ...]:
        out, acc = [], 0
        for x in xs:
            out.append(acc)
            acc += x
        return tuple(out)

    @property
    def offsets(self) -> tuple[int, ...]:
        return self._cumsum(self.chunks)

    @property
    def flat_offsets(self) -> tuple[int, ...]:
        return self._cumsum(self.sizes)

    @property
    def padded_offsets(self) -> tuple[int, ...]:
        return self._cumsum(self.shards * c for c in self.chunks)

    def cols(self, s: int) -> list[tuple[int, int, int, int]]:
        """Shard ``s``'s columns: per leaf ``(leaf, local offset, lo,
        hi)``, the leaf's coordinates ``[lo, hi)`` (empty where the shard
        holds only padding) at ``[offset, offset + hi - lo)`` of the local
        buffer."""
        return [(i, off, min(s * c, n), min((s + 1) * c, n))
                for i, (n, c, off) in enumerate(zip(
                    self.sizes, self.chunks, self.offsets))]

    def local(self, X: torch.Tensor, s: int) -> torch.Tensor:
        """Shard ``s``'s ``(W, width)`` buffer from a canonical ``(W, N)``
        stack (a copy, padding zeroed)."""
        out = torch.zeros((X.shape[0], self.width), dtype=X.dtype,
                          device=X.device)
        for (i, off, lo, hi), a in zip(self.cols(s), self.flat_offsets):
            out[:, off:off + hi - lo] = X[:, a + lo:a + hi]
        return out

    def padded_views(self, row: torch.Tensor, shapes) -> list[torch.Tensor]:
        """Leaf i of the padded ``row`` as a view shaped ``shapes[i]``."""
        return [row[p:p + n].view(shape) for p, n, shape in
                zip(self.padded_offsets, self.sizes, shapes)]

    def take(self, row: torch.Tensor, ids: slice, out: torch.Tensor) -> None:
        """Copy the shards ``ids`` (a slice of shard indices) of the padded
        ``row`` into the rows of the local-layout ``out``, one copy per
        leaf."""
        for p, c, off in zip(self.padded_offsets, self.chunks, self.offsets):
            out[:, off:off + c].copy_(
                row[p:p + self.shards * c].view(self.shards, c)[ids])

    def gather(self, G: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """The canonical ``(N,)`` vector from every shard's local ``(width,)``
        block, ``G`` being ``(shards, width)``; padding is dropped."""
        for n, c, off, a in zip(self.sizes, self.chunks, self.offsets,
                                self.flat_offsets):
            full = n // c
            out[a:a + full * c].view(full, c).copy_(G[:full, off:off + c])
            rem = n - full * c
            if rem:
                out[a + full * c:a + n].copy_(G[full, off:off + rem])
        return out
