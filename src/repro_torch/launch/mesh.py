"""Rank meshes (port of ``repro/launch/mesh.py``).

A :class:`Mesh` names the axes of a grid of ``torch.distributed`` ranks:
its axis names and its shape, rank r at the r-th position in row-major
order.  It holds no process group, so ``worker_count``,
``n_coord_shards`` and the logical rules of
:mod:`repro_torch.dist.sharding` work without one; the sharded path runs
its collectives on the default group, which the mesh must span.

Mesh shapes (those of the JAX package's TPU v5e meshes):

  single pod:  (data=16, model=16)            = 256 ranks
  multi-pod:   (pod=2, data=16, model=16)     = 512 ranks

The FA *worker* axis is (pod, data): 16 workers single-pod, 32 multi-pod.
The JAX package runs Megatron-style tensor parallelism on ``model``; the
port replicates the model on every rank, and its ``model`` axis only
splits the gradient coordinates (``repro_torch.dist.sharded``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

__all__ = ["Mesh", "make_production_mesh", "make_debug_mesh",
           "make_host_mesh", "worker_count", "world_size"]


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
