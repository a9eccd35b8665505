"""Parameter trees, their canonical flat order, and weight carry-over.

The port keeps the JAX package's parameter layout: a nested dict whose
leaves are tensors, with the repeated layers stacked along a leading axis
(``params["body"]`` is a list with one dict per block of the repeating
period, each leaf shaped ``(n_periods, ...)``).

**Canonical flattening order.**  Every flat view of a tree -- the flat
parameter vector, each row of the (W, N) gradient buffer, the update d --
lays the leaves out in the order ``jax.tree.leaves`` gives on the JAX
params dict: dict keys sorted, lists in index order, ``None`` holding no
leaf, each leaf flattened row-major.  For smollm-360m that is::

    body[0].ffn.down.w, body[0].ffn.gate.w, body[0].ffn.up.w,
    body[0].mixer.wk.w, body[0].mixer.wo.w, body[0].mixer.wq.w,
    body[0].mixer.wv.w, body[0].norm1.scale, body[0].norm2.scale,
    embed.table, final_norm.scale

(11 leaves, N = 361,821,120).  With the same order in both packages a
``sketch_stride > 1`` Gram keeps the same coordinates in each.  The order
is pinned by ``tests/test_torch_train.py``, which fails if either package's
tree changes shape.

**Tensor-parallel blocks.**  Under tensor parallelism over the mesh's
``model`` axis a rank holds one block of each partitioned leaf
(:class:`TPLayout`: which dimension of each leaf splits into how many
equal parts, and the rank's index), and its local tree has the same
structure and canonical order with those dimensions cut: ``TPLayout.
local`` is its :class:`Layout`.  :func:`tp_slice` cuts a rank's blocks
out of a whole tree (the weight carry-across from the JAX package's
parameters), :func:`tp_unslice` puts the ranks' trees back together,
:func:`tp_take` packs a rank's blocks of a flat vector into its local
layout (the ZeRO-1 moments' blocks, ``repro_torch.dist.zero1``, are a
``TPLayout`` over the rank's local tree).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ["leaf_items", "Layout", "layout_of", "unflatten", "pack",
           "pack_workers", "params_from_jax", "params_to_numpy", "map_tree",
           "TPLayout", "tp_slice", "tp_unslice", "tp_take"]


def leaf_items(tree, prefix: tuple = ()) -> list[tuple[tuple, object]]:
    """``[(path, leaf), ...]`` in the canonical order (see module doc)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out.extend(leaf_items(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, sub in enumerate(tree):
            out.extend(leaf_items(sub, prefix + (i,)))
        return out
    return [(prefix, tree)]


def map_tree(fn, tree):
    """Apply ``fn`` to every leaf, keeping the structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_tree(fn, v) for v in tree)
    return fn(tree)


@dataclass(frozen=True)
class Layout:
    """Where each leaf lives in a flat vector: the tree's structure with
    every leaf replaced by its index in canonical order, and each leaf's
    path and shape in that order."""

    skeleton: object
    paths: tuple[tuple, ...]
    shapes: tuple[tuple[int, ...], ...]

    @property
    def sizes(self) -> tuple[int, ...]:
        return tuple(int(np.prod(s, dtype=np.int64)) for s in self.shapes)

    @property
    def offsets(self) -> tuple[int, ...]:
        offs, acc = [], 0
        for s in self.sizes:
            offs.append(acc)
            acc += s
        return tuple(offs)

    @property
    def numel(self) -> int:
        return sum(self.sizes)


def layout_of(tree, lead: int = 0) -> Layout:
    """Layout of ``tree``; ``lead`` leading axes of every leaf (the worker
    axis of a worker-major tree) are not part of the flat layout."""
    items = leaf_items(tree)
    index = {id(leaf): i for i, (_, leaf) in enumerate(items)}
    skeleton = map_tree(lambda leaf: index[id(leaf)], tree)
    return Layout(skeleton, tuple(p for p, _ in items),
                  tuple(tuple(leaf.shape[lead:]) for _, leaf in items))


def unflatten(flat: torch.Tensor, layout: Layout):
    """The tree whose leaves are views of ``flat`` (N,) in canonical order."""
    if flat.shape[-1] != layout.numel:
        raise ValueError(f"unflatten: vector has {flat.shape[-1]} entries, "
                         f"layout needs {layout.numel}")
    views = [flat[o:o + s].view(shape) for o, s, shape in
             zip(layout.offsets, layout.sizes, layout.shapes)]
    return map_tree(lambda i: views[i], layout.skeleton)


def _as_tensor(leaf, device, dtype) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().to(device=device, dtype=dtype)
    return torch.tensor(np.asarray(leaf), device=device, dtype=dtype)


def pack(tree, device="cpu", dtype=torch.float32):
    """Copy the leaves of ``tree`` (tensors or numpy arrays) into one flat
    vector in canonical order.  Returns ``(flat, layout)``."""
    layout = layout_of(tree)
    flat = torch.empty(layout.numel, dtype=dtype, device=device)
    for (_, leaf), o, s in zip(leaf_items(tree), layout.offsets, layout.sizes):
        flat[o:o + s] = _as_tensor(leaf, device, dtype).reshape(-1)
    return flat, layout


def pack_workers(tree, device="cpu", dtype=torch.float32):
    """Copy a worker-major tree (every leaf ``(W, ...)``) into one (W, N)
    buffer, columns in canonical order.  Returns ``(X, layout)`` with the
    per-worker layout."""
    layout = layout_of(tree, lead=1)
    items = leaf_items(tree)
    W = items[0][1].shape[0]
    X = torch.empty((W, layout.numel), dtype=dtype, device=device)
    for (_, leaf), o, s in zip(items, layout.offsets, layout.sizes):
        X[:, o:o + s] = _as_tensor(leaf, device, dtype).reshape(W, -1)
    return X, layout


def params_from_jax(np_tree, device="cpu"):
    """Port params from the JAX params dict with numpy leaves: the same
    nested structure, leaves are fp32 views of one flat vector."""
    return unflatten(*pack(np_tree, device))


def params_to_numpy(params):
    """The JAX-layout params dict with numpy leaves (inverse of
    :func:`params_from_jax`)."""
    return map_tree(lambda t: t.detach().cpu().numpy(), params)


@dataclass(frozen=True)
class TPLayout:
    """A rank's blocks of a tree split over ``parts`` ranks: ``dims[i]``
    is the dimension of leaf i (canonical order of ``full``) cut into
    ``parts`` equal blocks, ``None`` where the leaf is replicated; the
    rank holds block ``index`` of every cut leaf."""

    full: Layout
    dims: tuple
    parts: int
    index: int

    @property
    def is_split(self) -> bool:
        return any(d is not None for d in self.dims)

    def block(self, i: int, index: int | None = None) -> tuple:
        """Leaf i's block ``index`` (default: the rank's) as a tuple of
        slices of the whole leaf."""
        shape, d = self.full.shapes[i], self.dims[i]
        if d is None:
            return tuple(slice(None) for _ in shape)
        k = shape[d] // self.parts
        m = self.index if index is None else index
        return tuple(slice(m * k, (m + 1) * k) if j == d else slice(None)
                     for j in range(len(shape)))

    @property
    def local(self) -> Layout:
        """The layout of the rank's local tree."""
        shapes = tuple(
            s if d is None else s[:d] + (s[d] // self.parts,) + s[d + 1:]
            for s, d in zip(self.full.shapes, self.dims))
        return Layout(self.full.skeleton, self.full.paths, shapes)


def tp_slice(tree, tp: TPLayout, index: int | None = None):
    """Block ``index`` (default: ``tp.index``) of every leaf of the whole
    ``tree`` (tensors or numpy arrays; views where the leaf type allows),
    in ``tree``'s structure."""
    items = leaf_items(tree)
    if len(items) != len(tp.dims):
        raise ValueError(f"tp_slice: the tree has {len(items)} leaves, the "
                         f"layout {len(tp.dims)}")
    blocks = {id(leaf): leaf[tp.block(i, index)]
              for i, (_, leaf) in enumerate(items)}
    return map_tree(lambda leaf: blocks[id(leaf)], tree)


def tp_unslice(trees, tp: TPLayout):
    """The whole tree from the ranks' local ``trees`` (block m of every
    leaf from ``trees[m]``; a replicated leaf from ``trees[0]``), with
    numpy leaves."""
    if len(trees) != tp.parts:
        raise ValueError(f"tp_unslice: {len(trees)} trees for "
                         f"{tp.parts} parts")
    per = [[np.asarray(leaf.detach().cpu() if isinstance(leaf, torch.Tensor)
                       else leaf) for _, leaf in leaf_items(t)]
           for t in trees]
    whole = [per[0][i] if d is None else
             np.concatenate([p[i] for p in per], axis=d)
             for i, d in enumerate(tp.dims)]
    return map_tree(lambda i: whole[i], tp.full.skeleton)


def tp_take(flat: torch.Tensor, tp: TPLayout) -> torch.Tensor:
    """The rank's block of every leaf of the flat vector ``flat`` (layout
    ``tp.full``), packed in ``tp.local``'s layout: a new vector."""
    out = flat.new_empty(tp.local.numel)
    for i, (o, n, shape) in enumerate(zip(tp.full.offsets, tp.full.sizes,
                                          tp.full.shapes)):
        lo, ln = tp.local.offsets[i], tp.local.sizes[i]
        out[lo:lo + ln].view(tp.local.shapes[i]).copy_(
            flat[o:o + n].view(shape)[tp.block(i)])
    return out
