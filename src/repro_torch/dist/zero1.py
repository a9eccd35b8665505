"""The optimizer step sharded over the mesh's ``data`` axis (ZeRO-1; port
of the JAX dry run's ``--zero1`` layout, ``repro/launch/dryrun.py``'s
``zshard``).

Without it every rank holds its optimizer moments whole (its blocks of
them under tensor parallelism) and every rank of a ``data`` group runs
the same update on the same values.  With it each moment leaf is cut as
JAX's ``zshard`` cuts the SGD momentum's sharding: the first dimension
that the parameter layout leaves unsplit and whose whole size the
``data`` axis divides is split over ``data`` (never ``pod``: JAX's
``_axes_size(mesh, ("data",))``); a leaf with no such dimension stays
whole.  :func:`zero1_layout` says this with the tensor-parallel layout's
own machinery: a :class:`~repro_torch.weights.TPLayout` over the rank's
local tree (``tp.local``, or the whole tree where nothing is
tensor-parallel) whose ``parts`` are the ``data`` axis and whose
``index`` is the rank's data coordinate.  AdamW's ``count`` stays
whole.

:func:`update` is the step's optimizer on those blocks: the rank takes
its blocks of d and of the parameters (the uncut leaves whole), updates
them with its moment blocks (the optimizers are per coordinate, so the
values are those of the whole update, bit for bit) and writes the uncut
leaves back; :func:`all_gather_` then gathers the updated blocks of the
cut leaves over its ``data`` group (the ranks of its ``model`` index),
one leaf a call (kind ``zero1_all_gather`` in
``repro_torch.dist.sharded.comm_stats``): a gather of the whole vector
would hold it twice more (gloo gathers into a flat buffer and copies
out), more than the moment the cut saves.

A checkpoint holds the whole moments: a cut leaf is a
:class:`~repro_torch.dist.tensor_parallel.TPLeaf` over ``data`` (inside
the ``model`` one where the leaf is tensor-parallel), so a zero1 run's
files are those of a run without it and either run resumes from the
other's.
"""

from __future__ import annotations

import torch

from repro_torch.dist.sharded import all_gather_rows
from repro_torch.launch.mesh import Mesh, axis_group
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.weights import (Layout, TPLayout, leaf_items, tp_take,
                                 unflatten)

__all__ = ["zero1_layout", "update", "all_gather_"]


def zero1_layout(layout: Layout, split: tuple, mesh: Mesh,
                 rank: int) -> TPLayout:
    """The ZeRO-1 cut of the moments of the rank's local tree ``layout``
    whose leaf i the parameter layout splits at dimension ``split[i]``
    (``None``: not split): per leaf the first other dimension whose size
    ``mesh.shape["data"]`` divides, cut into that many blocks, the rank's
    block its ``data`` coordinate.  An unsplit dimension has its whole
    size in ``layout``, so the test is JAX's on the whole shape."""
    if "data" not in mesh.shape:
        raise ValueError(f"zero1 cuts over the data axis; mesh "
                         f"{mesh.shape} has none")
    parts = mesh.shape["data"]
    dims = tuple(next((j for j, n in enumerate(shape)
                       if j != d and n % parts == 0), None)
                 for shape, d in zip(layout.shapes, split))
    return TPLayout(layout, dims, parts, mesh.coords(rank)["data"])


def update(opt: Optimizer, z: TPLayout, flat: torch.Tensor,
           d_blocks: torch.Tensor, opt_state: dict, lr
           ) -> tuple[torch.Tensor, dict]:
    """One optimizer step of the rank's blocks: ``d_blocks`` is its
    ``z.local`` vector of d (:func:`~repro_torch.weights.tp_take`),
    ``opt_state`` its moment blocks.  The uncut leaves of ``flat``
    (layout ``z.full``) take their new values here; returns the rank's
    updated parameter blocks (for :func:`all_gather_`) and the new
    optimizer state."""
    p_blocks = tp_take(flat, z)
    updates, opt_state = opt.update(d_blocks, opt_state, p_blocks, lr)
    apply_updates(p_blocks, updates)
    del updates
    views, blocks = _leaves(flat, z.full), _leaves(p_blocks, z.local)
    for i, d in enumerate(z.dims):          # the uncut leaves, whole
        if d is None:
            views[i].copy_(blocks[i])
    return p_blocks, opt_state


def all_gather_(z: TPLayout, flat: torch.Tensor, p_blocks: torch.Tensor,
                mesh: Mesh) -> None:
    """Every rank's updated blocks of the cut leaves into ``flat``: one
    ``all_gather`` a cut leaf over this rank's ``data`` group (kind
    ``zero1_all_gather``), so that no temporary is larger than a leaf."""
    group = axis_group(mesh, "data")
    views, blocks = _leaves(flat, z.full), _leaves(p_blocks, z.local)
    for i, d in enumerate(z.dims):
        if d is None:
            continue
        got = all_gather_rows(blocks[i], "zero1_all_gather", group=group)
        for m in range(z.parts):
            views[i][z.block(i, m)].copy_(got[m])


def _leaves(flat: torch.Tensor, layout: Layout) -> list:
    return [v for _, v in leaf_items(unflatten(flat, layout))]
