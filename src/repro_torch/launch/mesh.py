"""Rank meshes (port of ``repro/launch/mesh.py``).

A :class:`Mesh` names the axes of a grid of ``torch.distributed`` ranks:
its axis names and its shape, rank r at the r-th position in row-major
order.  It holds no process group, so ``worker_count``,
``n_coord_shards`` and the logical rules of
:mod:`repro_torch.dist.sharding` work without one.  The sharded path runs
its collectives on the default group, which the mesh must span, and the
tensor-parallel collectives on the rank's ``model`` subgroup:
:func:`axis_group` makes every axis's subgroups once per world (the ranks
that differ only in that axis's index form one group).

Mesh shapes (those of the JAX package's TPU v5e meshes):

  single pod:  (data=16, model=16)            = 256 ranks
  multi-pod:   (pod=2, data=16, model=16)     = 512 ranks

The FA *worker* axis is (pod, data): 16 workers single-pod, 32 multi-pod.
``model`` carries Megatron-style tensor parallelism, as in the JAX
package: the model's weights split over it where the logical
rules resolve their axes to it (``repro_torch.dist.tensor_parallel``),
and every axis splits the gradient coordinates
(``repro_torch.dist.sharded``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["Mesh", "make_production_mesh", "make_debug_mesh",
           "make_host_mesh", "worker_count", "world_size", "axis_group"]


@dataclass(frozen=True)
class Mesh:
    """A named grid of the ranks ``0 .. size - 1`` in row-major order."""

    axis_sizes: tuple[int, ...]
    axis_names: tuple[str, ...]

    def __post_init__(self):
        if len(self.axis_sizes) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.axis_sizes} does not match "
                             f"axis names {self.axis_names}")

    @property
    def shape(self) -> dict[str, int]:
        """Axis name -> size, in axis order (JAX's ``Mesh.shape``)."""
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)

    def coords(self, rank: int) -> dict[str, int]:
        """Axis name -> index of ``rank`` on that axis."""
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} is not in a mesh of {self.size}")
        pos, out = rank, {}
        for name, n in zip(reversed(self.axis_names),
                           reversed(self.axis_sizes)):
            out[name] = pos % n
            pos //= n
        return {a: out[a] for a in self.axis_names}

    def flat_index(self, rank: int, axes) -> int:
        """Row-major index of ``rank`` over ``axes`` (in mesh order)."""
        c = self.coords(rank)
        idx = 0
        for a in self.axis_names:
            if a in axes:
                idx = idx * self.shape[a] + c[a]
        return idx


def world_size() -> int:
    """Ranks of the default process group (1 when there is none)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """(data 16, model 16), or (pod 2, data 16, model 16) with
    ``multi_pod``, over the whole world, which must have that many
    ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need, have = math.prod(shape), world_size()
    if have != need:
        raise ValueError(f"the {'multi-pod' if multi_pod else 'single-pod'} "
                         f"production mesh needs {need} ranks, the world "
                         f"has {have}")
    return Mesh(shape, axes)


def _model_factor(n: int) -> int:
    """Widest model axis (of 4/2/1) that divides ``n`` with data > 1."""
    return next((m for m in (4, 2) if n % m == 0 and n > m), 1)


def make_debug_mesh(n_ranks: int | None = None) -> Mesh:
    """Tiny (data, model) mesh over the ranks that exist (CPU tests)."""
    return make_host_mesh(n_ranks)


def make_host_mesh(n_ranks: int | None = None) -> Mesh:
    """(data, model) mesh over the FIRST ``n_ranks`` ranks of the world
    (default: all of them); ``model`` is :func:`_model_factor`."""
    have = world_size()
    n = n_ranks or have
    if n > have:
        raise ValueError(f"make_host_mesh: asked for {n} ranks but only "
                         f"{have} exist (start more, e.g. torchrun "
                         f"--nproc-per-node {n})")
    model = _model_factor(n)
    return Mesh((n // model, model), ("data", "model"))


def worker_count(mesh: Mesh) -> int:
    """FA workers of the mesh: the product of its pod and data axes."""
    n = 1
    for ax in ("pod", "data"):
        if ax in mesh.shape:
            n *= mesh.shape[ax]
    return n


# (mesh, default group) -> {axis: this rank's subgroup}; the default group
# is held so that a new world never matches an old world's entry
_GROUPS: dict = {}


def axis_group(mesh: Mesh, axis: str):
    """This rank's process group over ``axis``: the ranks whose mesh
    coordinates equal its own on every other axis, in ``axis`` order.
    The first call of a world makes the subgroups of every axis of the
    mesh (every rank of the world must make that call, as
    ``torch.distributed.new_group`` needs); later calls return them."""
    import torch.distributed as dist
    if axis not in mesh.shape:
        raise ValueError(f"mesh {mesh.shape} has no axis {axis!r}")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"the mesh {mesh.shape} must span the world's "
                         f"{dist.get_world_size()} ranks")
    world = dist.group.WORLD
    key = (mesh, id(world))
    entry = _GROUPS.get(key)
    if entry is None or entry[0] is not world:
        rank, mine = dist.get_rank(), {}
        for ax in mesh.axis_names:
            rest = [a for a in mesh.axis_names if a != ax]
            members: dict = {}
            for r in range(mesh.size):
                c = mesh.coords(r)
                members.setdefault(tuple(c[a] for a in rest), []).append(r)
            for ranks in members.values():     # the same order everywhere
                g = dist.new_group(ranks)
                if rank in ranks:
                    mine[ax] = g
        entry = _GROUPS[key] = (world, mine)
    return entry[1][axis]
