"""Sharded aggregation over ``torch.distributed`` ranks (port of
``repro/dist/sharded.py``).

The key fact is Gram additivity over any coordinate partition:

    K = G G^T = sum_s  G[:, s] G[:, s]^T        (s = coordinate shards)

so aggregation decomposes into three stages with one small collective:

1. **partial Gram, shard-local** -- each rank holds a coordinate shard of
   every leaf (:class:`repro_torch.dist.sharding.CoordShards`: one
   contiguous ``(W, width)`` fp32 buffer) and forms its partial Gram with
   the tree-Gram kernel, sketched by ``sketch_stride`` over its local chunk
   stream; one ``all_reduce`` of the ``(W, W)`` result follows.
2. **weights, replicated** -- the rule's weight computation (the FA
   solve, Weiszfeld, Krum scores, Bulyan's selection) runs on every rank
   from the summed Gram.  The reduced Gram holds the same bits on every
   rank, and the solve is deterministic on one device type, so every rank
   gets the same weights.
3. **combine, shard-local** -- ``d = sum_w c_w g_w`` and the
   coordinate-wise rules (median / trimmed mean / MeaMed / Phocas,
   Bulyan's MeaMed stage) act per coordinate, so each rank computes its own
   columns with no communication.

No rank ever holds the ``(W, N)`` stack.  One ``all_gather`` then puts the
ranks' blocks of ``d`` back into the canonical flat ``(N,)`` vector
(padding dropped): the optimizer steps the rank's parameters, the whole
tree where the model is replicated, its tensor-parallel blocks of it
under tensor parallelism (``repro_torch.dist.tensor_parallel``).  There a
rank's gradient comes out of the backward pass as its blocks of the
partitioned leaves (and the replicated leaves whole), and
:class:`TPExchange` moves them into the coordinate shards with one
``all_to_all`` among the ``model`` group, without gathering a whole row.

Given the same weights the combine and the coordinate rules equal the
unsharded path bit for bit (the per-coordinate reduction over workers is
unchanged); the Gram differs by fp32 reassociation of the coordinate sum.

Collectives run on the default process group, which the mesh must span,
with the backend the launcher chose (``repro_torch.launch.train``): NCCL
where each rank has a card of its own, gloo where ranks share one card or
run on the CPU.  Nothing changes route on failure: a collective that
fails raises.  ``comm_stats`` counts, per kind of collective, the calls
and the bytes of each call's input on this rank (and, with
``comm_stats_timed(True)``, the seconds between device synchronisations
around each call).

Entry point: ``aggregate_tree(..., sharded=...)`` /
``compressed_aggregate(..., sharded=...)``: their one rule dispatch runs
with this module's two stages (:func:`sharded_stages`).  Under a codec
each rank encodes and decodes its own columns first
(``repro_torch.comm.error_feedback.ef_round``), the codec's cross-rank
step going through :func:`all_reduce_` under a kind of its own:
``sketch_all_reduce`` (CountSketch's (W, sum_i k_i) payload),
``signsgd_scale_all_reduce`` (signSGD's (W, rows) scales and cut rows'
partial sums, one a step) and ``topk_select`` (top-k's (W,) counts, one
a step of a leaf's bitwise threshold search: 33 a leaf, more where a tie
is cut).  The EF memory is the rank's (W, width) shard too; a checkpoint
gathers it to rank 0 one row of a leaf at a time (:class:`ShardLeaf`,
kind ``ef_gather``).
"""

from __future__ import annotations

import math
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import DeferredLeaf, copy_leaf
from repro_torch.dist.sharding import CoordShards
from repro_torch.launch.mesh import Mesh
from repro_torch.weights import TPLayout

__all__ = ["coord_axes", "n_coord_shards", "shard_index", "coord_shards",
           "sharded_tree_gram", "gather_flat", "sharded_stages",
           "all_reduce_", "all_gather_rows", "gather_to_rank0", "ShardLeaf",
           "TPExchange", "comm_stats", "reset_comm_stats",
           "comm_stats_timed"]

# kind -> {"calls", "bytes", "s"}: see the module docstring
comm_stats: dict[str, dict] = {}
_TIMED = {"on": False}


def reset_comm_stats() -> None:
    comm_stats.clear()


def comm_stats_timed(on: bool) -> None:
    """Time every collective between two device synchronisations."""
    _TIMED["on"] = bool(on)


def _run(kind: str, nbytes: int, ref: torch.Tensor, fn) -> None:
    rec = comm_stats.setdefault(kind, {"calls": 0, "bytes": 0, "s": 0.0})
    rec["calls"] += 1
    rec["bytes"] += int(nbytes)
    if not _TIMED["on"]:
        fn()
        return
    sync = ref.device.type == "cuda"
    if sync:
        torch.cuda.synchronize(ref.device)
    t0 = time.perf_counter()
    fn()
    if sync:
        torch.cuda.synchronize(ref.device)
    rec["s"] += time.perf_counter() - t0


def all_reduce_(t: torch.Tensor, kind: str, op=dist.ReduceOp.SUM,
                group=None) -> torch.Tensor:
    """In-place ``all_reduce`` of ``t`` over ``group`` (default: the
    default group)."""
    _run(kind, t.numel() * t.element_size(), t,
         lambda: dist.all_reduce(t, op=op, group=group))
    return t


def all_gather_rows(block: torch.Tensor, kind: str,
                    group=None) -> torch.Tensor:
    """``(ranks, *block.shape)``: every rank's ``block`` of ``group``
    (default: the default group), in rank order."""
    block = block.contiguous()
    out = torch.empty((dist.get_world_size(group),) + tuple(block.shape),
                      dtype=block.dtype, device=block.device)
    _run(kind, block.numel() * block.element_size(), block,
         lambda: dist.all_gather(list(out.unbind(0)), block, group=group))
    return out


def gather_to_rank0(block: torch.Tensor, kind: str) -> torch.Tensor | None:
    """``(world, *block.shape)`` on rank 0: every rank's ``block``, in rank
    order; ``None`` on the other ranks."""
    rank0 = dist.get_rank() == 0
    out = (torch.empty((dist.get_world_size(),) + tuple(block.shape),
                       dtype=block.dtype, device=block.device)
           if rank0 else None)
    _run(kind, block.numel() * block.element_size(), block,
         lambda: dist.gather(block.contiguous(),
                             list(out.unbind(0)) if rank0 else None, dst=0))
    return out


def all_to_all_(out: torch.Tensor, inp: torch.Tensor, out_splits,
                in_splits, kind: str, group=None) -> None:
    """``all_to_all_single`` over ``group`` (default: the default group;
    splits in rows of the first dimension's flattening, as
    ``torch.distributed`` takes them)."""
    _run(kind, inp.numel() * inp.element_size(), inp,
         lambda: dist.all_to_all_single(out, inp, out_splits, in_splits,
                                        group=group))


def coord_axes(mesh: Mesh) -> tuple[str, ...]:
    """Mesh axes the gradient coordinates shard over: all of them."""
    return tuple(mesh.axis_names)


def n_coord_shards(mesh: Mesh, axes: tuple[str, ...] | None = None) -> int:
    axes = coord_axes(mesh) if axes is None else axes
    return math.prod(mesh.shape[a] for a in axes)


def _check_world(mesh: Mesh) -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("sharded aggregation needs a torch.distributed "
                           "process group (repro_torch.launch.train makes "
                           "one under --sharded-agg)")
    if dist.get_world_size() != mesh.size:
        raise ValueError(f"sharded aggregation runs on the default group: "
                         f"the mesh {mesh.shape} must span its "
                         f"{dist.get_world_size()} ranks")


def shard_index(mesh: Mesh) -> int:
    """This rank's coordinate shard: its row-major position in the mesh."""
    _check_world(mesh)
    return mesh.flat_index(dist.get_rank(), coord_axes(mesh))


def coord_shards(leaf_sizes, mesh: Mesh) -> CoordShards:
    return CoordShards(tuple(int(n) for n in leaf_sizes),
                       n_coord_shards(mesh))


def sharded_tree_gram(Xs: torch.Tensor, mesh: Mesh, *,
                      sketch_stride: int = 1,
                      gram_dtype: str = "float32") -> torch.Tensor:
    """(W, W) fp32 Gram of the coordinate-sharded stack: the tree Gram of
    this rank's ``(W, width)`` buffer (one kernel launch on the card,
    sketched over the local chunk stream), then one ``all_reduce``."""
    from repro_torch.dist.aggregation import tree_gram
    _check_world(mesh)
    K = tree_gram(Xs, sketch_stride, gram_dtype=gram_dtype)
    return all_reduce_(K.contiguous(), "gram_all_reduce")


def gather_flat(d_local: torch.Tensor, shards: CoordShards,
                mesh: Mesh) -> torch.Tensor:
    """The canonical ``(N,)`` vector from every rank's ``(width,)`` block:
    one ``all_gather``, padding dropped."""
    _check_world(mesh)
    G = all_gather_rows(d_local, "d_all_gather")
    out = torch.empty(shards.numel, dtype=d_local.dtype,
                      device=d_local.device)
    return shards.gather(G, out)


def sharded_stages(Xs: torch.Tensor, leaf_sizes, mesh: Mesh):
    """The two stages by which ``aggregate_tree(..., sharded=mesh)``
    differs from the one-device path, for this rank's ``(W, width)``
    buffer ``Xs`` of the stack whose leaves have ``leaf_sizes``
    coordinates: ``(gram_of, finish)``.  ``gram_of(Xs, sketch_stride,
    gram_dtype=)`` is :func:`sharded_tree_gram`; ``finish(d_local)`` is
    :func:`gather_flat`, applied to the shard-local combine and coordinate
    rules' output.  The rule dispatch between them is the unsharded one."""
    shards = coord_shards(leaf_sizes, mesh)
    if Xs.dim() != 2 or Xs.shape[1] != shards.width:
        raise ValueError(f"aggregate_tree(sharded=...): expects this rank's "
                         f"(W, {shards.width}) coordinate-shard buffer, got "
                         f"{tuple(Xs.shape)}")

    def gram_of(X, sketch_stride, gram_dtype="float32"):
        return sharded_tree_gram(X, mesh, sketch_stride=sketch_stride,
                                 gram_dtype=gram_dtype)

    def finish(d_local):
        return gather_flat(d_local, shards, mesh)
    return gram_of, finish


class ShardLeaf(DeferredLeaf):
    """One leaf of a worker-major buffer held as coordinate shards: this
    rank's columns of leaf ``i`` in its (W, width) ``buf`` (layout
    ``shards``, shard ``s``), seen by a checkpoint as the whole ``(W,
    *shape)`` fp32 leaf.  :meth:`to_host` gathers it to rank 0 one worker
    row at a time (every rank takes part; device temporaries are one row
    of the leaf); :meth:`load_` takes this rank's columns of the whole
    leaf read from a file."""

    def __init__(self, buf: torch.Tensor, shards: CoordShards, s: int,
                 i: int, shape: tuple, mesh: Mesh):
        n, c = shards.sizes[i], shards.chunks[i]
        self.buf, self.n, self.chunk = buf, n, c
        self.off, self.lo, self.hi = (shards.offsets[i], min(s * c, n),
                                      min((s + 1) * c, n))
        self.shape = (buf.shape[0],) + tuple(shape)
        self.dtype = buf.dtype
        # the gather comes back in rank order; the leaf is in shard order
        self.order = [mesh.flat_index(r, coord_axes(mesh))
                      for r in range(mesh.size)]

    def to_host(self) -> np.ndarray | None:
        W, m = self.shape[0], self.hi - self.lo
        out = np.empty((W, self.n), np.float32) if dist.get_rank() == 0 \
            else None
        block = torch.zeros(self.chunk, dtype=self.dtype,
                            device=self.buf.device)
        for w in range(W):
            block[:m].copy_(self.buf[w, self.off:self.off + m])
            G = gather_to_rank0(block, "ef_gather")
            if G is not None:
                row = torch.empty_like(G)
                row[self.order] = G
                out[w] = row.view(-1)[:self.n].cpu().numpy()
        return None if out is None else out.reshape(self.shape)

    def load_(self, src: torch.Tensor) -> None:
        copy_leaf(self.buf[:, self.off:self.off + self.hi - self.lo],
                  src.reshape(self.shape[0], self.n)[:, self.lo:self.hi])


class TPExchange:
    """One worker's tensor-parallel gradient into coordinate shards.

    Each rank of a ``model`` group of ``tp.parts`` ranks holds the
    worker's gradient in its local layout (``tp.local``: its block of
    every partitioned leaf, the replicated leaves whole) in :attr:`row`,
    and the rank of model index r needs the canonical columns of the
    shards ``targets[r]`` (rows of the output, ``(len(targets[r]),
    width)``, the :class:`CoordShards` local layout, padding zero).  A
    partitioned leaf's coordinate comes from the rank that holds its
    block, a replicated leaf's from the receiving rank's own copy.
    :meth:`run` is one gather of the coordinates the other ranks need
    into a send buffer ordered by receiver, one ``all_to_all_single``
    among the group (kind ``tp_exchange``; nothing sent to this rank
    itself), and one gather of the output from the received values and
    :attr:`row`, which share one buffer: no rank holds a whole row.  The
    index maps (int32 where they fit) are built once, on ``device``, in
    blocks of at most ``BLOCK`` coordinates."""

    BLOCK = 1 << 24

    def __init__(self, tp: TPLayout, shards: CoordShards, targets,
                 group, device):
        self.tp, self.shards, self.group = tp, shards, group
        self.rows = len(targets[tp.index])
        M, me = tp.parts, tp.index
        n_out = self.rows * shards.width

        def counts(r):
            """Coordinates of ``targets[r]`` by owner, this rank's own
            left out."""
            out = torch.zeros(M, dtype=torch.long, device=device)
            for own, _, _ in self._cols(targets[r], r, device):
                out.index_add_(0, own, torch.ones_like(own))
            if r == me:
                out[me] = 0
            return out.tolist()
        self.in_splits = [0 if r == me else counts(r)[me] for r in range(M)]
        self.out_splits = counts(me)
        self.n_recv = n_recv = sum(self.out_splits)
        # [received values | a zero | this rank's local gradient]
        self.buf = torch.zeros(n_recv + 1 + tp.local.numel,
                               dtype=torch.float32, device=device)
        self.row = self.buf[n_recv + 1:]
        idt = (torch.int32 if max(self.buf.numel(), n_out) < 2 ** 31 - 1
               else torch.long)
        self.send_idx = torch.empty(sum(self.in_splits), dtype=idt,
                                    device=device)
        o = 0
        for r in range(M):
            if r == me:
                continue
            for own, pos, _ in self._cols(targets[r], r, device):
                pos = pos[own == me] + (n_recv + 1)
                self.send_idx[o:o + pos.numel()] = pos
                o += pos.numel()
        self.gather_idx = torch.full((n_out,), n_recv, dtype=idt,
                                     device=device)
        nxt = [sum(self.out_splits[:r]) for r in range(M)]
        for own, pos, t in self._cols(targets[me], me, device):
            mine = own == me
            self.gather_idx[t[mine]] = (pos[mine] + (n_recv + 1)).to(idt)
            for r in range(M):
                if r == me:
                    continue
                sel = (own == r).nonzero().squeeze(1)
                self.gather_idx[t[sel]] = (nxt[r] + torch.arange(
                    sel.numel(), device=device)).to(idt)
                nxt[r] += sel.numel()
        self.send = torch.empty(self.send_idx.numel(), dtype=torch.float32,
                                device=device)

    def _cols(self, rows, receiver, device):
        """Per block of the shard rows ``rows`` (a leaf's chunk of a row,
        at most ``BLOCK`` coordinates): the owner of each real
        coordinate, its position in the owner's local vector and its
        position in the receiver's output (row-major)."""
        tp, shards = self.tp, self.shards
        loffs = tp.local.offsets
        for q, s in enumerate(rows):
            for i, off, lo, hi in shards.cols(s):
                for a0 in range(lo, hi, self.BLOCK):
                    f = torch.arange(a0, min(a0 + self.BLOCK, hi),
                                     device=device)
                    t = q * shards.width + off - lo + f
                    d = tp.dims[i]
                    if d is None:
                        yield torch.full_like(f, receiver), loffs[i] + f, t
                        continue
                    shape = tp.full.shapes[i]
                    A = shape[d]
                    inner = math.prod(shape[d + 1:])
                    k = A // tp.parts
                    a = (f // inner) % A
                    yield (a // k, loffs[i] + (f // (A * inner)) * (k * inner)
                           + (a % k) * inner + f % inner, t)

    def run(self, out: torch.Tensor) -> None:
        """``out`` (rows, width), contiguous: this rank's shard rows of the
        worker whose local gradient is in :attr:`row`."""
        torch.index_select(self.buf, 0, self.send_idx, out=self.send)
        all_to_all_(self.buf[:self.n_recv], self.send, self.out_splits,
                    self.in_splits, "tp_exchange", group=self.group)
        torch.index_select(self.buf, 0, self.gather_idx, out=out.view(-1))
