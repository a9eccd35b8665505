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

No rank ever holds the ``(W, N)`` stack, and the aggregation returns the
rank's ``(width,)`` block of ``d``.  Where the model is replicated, one
``all_gather`` puts the ranks' blocks back into the canonical flat ``(N,)``
vector (padding dropped, :func:`gather_flat`) and the optimizer steps the
whole tree.  Under tensor parallelism (``repro_torch.dist.
tensor_parallel``) a rank's gradient comes out of the backward pass as its
blocks of the partitioned leaves (and the replicated leaves whole),
:class:`TPExchange` moves them into the coordinate shards with one
``all_to_all`` among the ``model`` group, without gathering a whole row,
and :class:`TPReturn` brings each rank just its blocks of ``d`` (and the
replicated leaves whole) from the shards with one ``all_to_all`` over the
world: no rank holds the whole ``d``.

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
with the Gram of :func:`sharded_gram_of` on the rank's shard.  Under a codec
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
           "sharded_tree_gram", "gather_flat", "sharded_gram_of",
           "all_reduce_", "all_gather_rows", "gather_to_rank0", "ShardLeaf",
           "TPExchange", "TPReturn", "comm_stats", "reset_comm_stats",
           "comm_stats_timed"]

# kind -> {"calls", "bytes", "s"}: see the module docstring
comm_stats: dict[str, dict] = {}
_TIMED = {"on": False}
# callables (kind, nbytes, ref, collective, op) told of every collective
# before it runs: repro_torch.analysis.trace records a call's collectives
_OBSERVERS: list = []


def reset_comm_stats() -> None:
    comm_stats.clear()


def comm_stats_timed(on: bool) -> None:
    """Time every collective between two device synchronisations."""
    _TIMED["on"] = bool(on)


def _run(kind: str, nbytes: int, ref: torch.Tensor, fn, *,
         collective: str = "", op=None) -> None:
    for observe in _OBSERVERS:
        observe(kind, int(nbytes), ref, collective, op)
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
         lambda: dist.all_reduce(t, op=op, group=group),
         collective="all_reduce", op=op)
    return t


def all_gather_rows(block: torch.Tensor, kind: str,
                    group=None) -> torch.Tensor:
    """``(ranks, *block.shape)``: every rank's ``block`` of ``group``
    (default: the default group), in rank order."""
    block = block.contiguous()
    out = torch.empty((dist.get_world_size(group),) + tuple(block.shape),
                      dtype=block.dtype, device=block.device)
    _run(kind, block.numel() * block.element_size(), block,
         lambda: dist.all_gather(list(out.unbind(0)), block, group=group),
         collective="all_gather")
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
                             list(out.unbind(0)) if rank0 else None, dst=0),
         collective="gather")
    return out


def all_to_all_(out: torch.Tensor, inp: torch.Tensor, out_splits,
                in_splits, kind: str, group=None) -> None:
    """``all_to_all_single`` over ``group`` (default: the default group;
    splits in rows of the first dimension's flattening, as
    ``torch.distributed`` takes them)."""
    _run(kind, inp.numel() * inp.element_size(), inp,
         lambda: dist.all_to_all_single(out, inp, out_splits, in_splits,
                                        group=group),
         collective="all_to_all")


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


def sharded_gram_of(Xs: torch.Tensor, leaf_sizes, mesh: Mesh):
    """The stage by which ``aggregate_tree(..., sharded=mesh)`` differs
    from the one-device path, for this rank's ``(W, width)`` buffer ``Xs``
    of the stack whose leaves have ``leaf_sizes`` coordinates:
    ``gram_of(Xs, sketch_stride, gram_dtype=)``, :func:`sharded_tree_gram`.
    The rule dispatch around it is the unsharded one; the combine and the
    coordinate rules give the rank's ``(width,)`` block of d."""
    shards = coord_shards(leaf_sizes, mesh)
    if Xs.dim() != 2 or Xs.shape[1] != shards.width:
        raise ValueError(f"aggregate_tree(sharded=...): expects this rank's "
                         f"(W, {shards.width}) coordinate-shard buffer, got "
                         f"{tuple(Xs.shape)}")

    def gram_of(X, sketch_stride, gram_dtype="float32"):
        return sharded_tree_gram(X, mesh, sketch_stride=sketch_stride,
                                 gram_dtype=gram_dtype)
    return gram_of


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


INDEX_BLOCK = 1 << 24       # coordinates of one step of an index map's build


def _index_maps(coords, counts, n: int, me: int, n_out: int,
                src_size: int, gap: int, device):
    """The index maps of a move in which each of ``n`` ranks sends the
    others what they need of its source vector, with one
    ``all_to_all_single``, and gathers its output from the values it
    received and its own source.  ``coords(r)`` yields, per block of at
    most ``INDEX_BLOCK`` coordinates of rank r's output, the rank that
    sends each coordinate, its position in that rank's source and its
    position in r's output; ``counts(r)`` is how many of r's coordinates
    each rank sends (closed form: no host read of a device value).  The
    gather reads one buffer: [received values, by sender | ``gap`` slots |
    this rank's source].  Returns ``(send_splits, recv_splits, send_idx,
    gather_idx)``: ``send_idx`` the buffer positions of the values sent,
    ordered by receiver; ``gather_idx`` each output position's, the first
    slot after the received values where no rank sends one (int32 where
    they fit).  On fake tensors (a trace, ``launch.dryrun``) the maps are
    allocated at their sizes and not filled: a trace reads their sizes,
    which the counts give, not their values."""
    from torch._subclasses.fake_tensor import is_fake
    mine = counts(me)
    recv = [0 if r == me else mine[r] for r in range(n)]
    send = [0 if r == me else counts(r)[me] for r in range(n)]
    n_recv = sum(recv)
    src = n_recv + gap
    idt = (torch.int32 if max(src + src_size, n_out) < 2 ** 31 - 1
           else torch.long)
    send_idx = torch.empty(sum(send), dtype=idt, device=device)
    if is_fake(send_idx):
        return send, recv, send_idx, torch.empty(n_out, dtype=idt,
                                                 device=device)
    o = 0
    for r in range(n):
        if r == me:
            continue
        for own, pos, _ in coords(r):
            pos = pos[own == me] + src
            send_idx[o:o + pos.numel()] = pos.to(idt)
            o += pos.numel()
    gather_idx = torch.full((n_out,), n_recv, dtype=idt, device=device)
    nxt = [sum(recv[:r]) for r in range(n)]
    for own, pos, t in coords(me):
        here = own == me
        gather_idx[t[here]] = (pos[here] + src).to(idt)
        for r in range(n):
            if r == me:
                continue
            sel = (own == r).nonzero().squeeze(1)
            gather_idx[t[sel]] = (nxt[r] + torch.arange(
                sel.numel(), device=device)).to(idt)
            nxt[r] += sel.numel()
    return send, recv, send_idx, gather_idx


def _covered(x, period: int, run: int, off: int):
    """How many of the positions ``[0, x)`` lie in ``[off, off + run)``
    modulo ``period`` (``x`` an int or a numpy array; ``off`` may be an
    array)."""
    return (x // period) * run + np.clip(x % period - off, 0, run)


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
    index maps are built once, on ``device`` (:func:`_index_maps`); the
    data buffers (:attr:`row` and the values sent and received) exist
    between :meth:`open` and :meth:`close`, the worker loop of a step, so
    the aggregation and the update that follow do not hold them."""

    def __init__(self, tp: TPLayout, shards: CoordShards, targets,
                 group, device):
        self.tp, self.shards, self.group = tp, shards, group
        self.rows = len(targets[tp.index])
        # buf: [received values | a zero | this rank's local gradient]
        self.in_splits, self.out_splits, self.send_idx, self.gather_idx = \
            _index_maps(lambda r: self._cols(targets[r], r, device),
                        lambda r: self._counts(targets[r], r),
                        tp.parts, tp.index, self.rows * shards.width,
                        tp.local.numel, 1, device)
        self.n_recv = sum(self.out_splits)
        self.size, self.device = self.n_recv + 1 + tp.local.numel, device
        self.buf = self.row = self.send = None

    def open(self) -> None:
        """Allocate the data buffers (:attr:`row` among them)."""
        f32 = torch.float32
        self.buf = torch.empty(self.size, dtype=f32, device=self.device)
        self.buf[self.n_recv].zero_()            # the padding's source
        self.row = self.buf[self.n_recv + 1:]
        self.send = torch.empty(self.send_idx.numel(), dtype=f32,
                                device=self.device)

    def close(self) -> None:
        """Release the data buffers; the index maps stay."""
        self.buf = self.row = self.send = None

    def _counts(self, rows, receiver) -> list[int]:
        """How many coordinates of the shard rows ``rows`` each model index
        holds (:meth:`_cols`' owners, counted in closed form)."""
        tp, out = self.tp, np.zeros(self.tp.parts, dtype=np.int64)
        owners = np.arange(tp.parts)
        for s in rows:
            for i, _, lo, hi in self.shards.cols(s):
                d = tp.dims[i]
                if d is None:
                    out[receiver] += hi - lo
                    continue
                shape = tp.full.shapes[i]
                inner = math.prod(shape[d + 1:])
                run = shape[d] // tp.parts * inner
                period, off = shape[d] * inner, owners * run
                out += (_covered(hi, period, run, off)
                        - _covered(lo, period, run, off))
        return out.tolist()

    def _cols(self, rows, receiver, device):
        """Per block of the shard rows ``rows`` (a leaf's chunk of a row,
        at most ``INDEX_BLOCK`` coordinates): the owner of each real
        coordinate, its position in the owner's local vector and its
        position in the receiver's output (row-major)."""
        tp, shards = self.tp, self.shards
        loffs = tp.local.offsets
        for q, s in enumerate(rows):
            for i, off, lo, hi in shards.cols(s):
                for a0 in range(lo, hi, INDEX_BLOCK):
                    f = torch.arange(a0, min(a0 + INDEX_BLOCK, hi),
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


class TPReturn:
    """d from the coordinate shards back into each rank's tensor-parallel
    local layout (``tp.local``: its block of every partitioned leaf, the
    replicated leaves whole), the inverse move of :class:`TPExchange`
    over the whole world.  The rank of shard s holds d's ``(width,)``
    block of shard s; a coordinate of a rank's local layout comes from
    the rank whose shard holds it (its own block where that is this
    rank).  :meth:`run` is one gather of what the other ranks need from
    this rank's block into a send buffer ordered by receiver, one
    ``all_to_all_single`` over the world (kind ``tp_return``; nothing sent
    to this rank itself) and one gather of the local vector from the
    received values and this rank's block.  The index maps are built
    once, on ``device`` (:func:`_index_maps`)."""

    def __init__(self, tp: TPLayout, shards: CoordShards, mesh: Mesh,
                 device):
        R = mesh.size
        axes = coord_axes(mesh)
        self.rank_np = np.empty(R, dtype=np.int64)
        for r in range(R):
            self.rank_np[mesh.flat_index(r, axes)] = r
        self.rank_of = torch.tensor(self.rank_np.tolist(), device=device)
        self.tp, self.shards, self.device = tp, shards, device
        model = [mesh.coords(r).get("model", 0) for r in range(R)]
        counts = {}

        def count(r):
            if model[r] not in counts:
                counts[model[r]] = self._counts(model[r])
            return counts[model[r]]
        self.send_splits, self.recv_splits, self.send_idx, self.gather_idx \
            = _index_maps(lambda r: self._coords(model[r]), count, R,
                          dist.get_rank(), tp.local.numel, shards.width, 0,
                          device)
        self.n_recv = sum(self.recv_splits)

    def _counts(self, m: int) -> list[int]:
        """How many coordinates of model index ``m``'s local layout each
        rank holds (:meth:`_coords`' holders, counted in closed form: a
        leaf's local coordinates map to increasing whole-leaf positions,
        so shard s holds those whose position lies in its chunk)."""
        tp, shards = self.tp, self.shards
        out = np.zeros(len(self.rank_np), dtype=np.int64)
        for i, (shape, d) in enumerate(zip(tp.full.shapes, tp.dims)):
            n, c = shards.sizes[i], shards.chunks[i]
            edges = np.minimum(np.arange(shards.shards + 1) * c, n)
            if d is None:
                below = edges
            else:
                run = shape[d] // tp.parts * math.prod(shape[d + 1:])
                below = _covered(edges, tp.parts * run, run, m * run)
            np.add.at(out, self.rank_np[:shards.shards], np.diff(below))
        return out.tolist()

    def _coords(self, m: int):
        """Per block of the local layout of model index ``m`` (at most
        ``INDEX_BLOCK`` coordinates): the rank that holds each coordinate,
        its position in that rank's ``(width,)`` block and its position in
        the local vector."""
        tp, shards = self.tp, self.shards
        for i, (shape, d) in enumerate(zip(tp.full.shapes, tp.dims)):
            n, c, off = shards.sizes[i], shards.chunks[i], shards.offsets[i]
            lo_i = tp.local.offsets[i]
            size = tp.local.sizes[i]
            for j0 in range(0, size, INDEX_BLOCK):
                j = torch.arange(j0, min(j0 + INDEX_BLOCK, size),
                                 device=self.device)
                if d is None:
                    f = j
                else:
                    run = shape[d] // tp.parts * math.prod(shape[d + 1:])
                    f = (j // run * tp.parts + m) * run + j % run
                yield self.rank_of[f // c], off + f % c, lo_i + j

    def run(self, d_block: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """``out`` (``tp.local.numel``,): this rank's local layout of d,
        from every rank's ``(width,)`` block ``d_block``."""
        buf = torch.empty(self.n_recv + self.shards.width,
                          dtype=d_block.dtype, device=d_block.device)
        buf[self.n_recv:].copy_(d_block)
        send = buf.index_select(0, self.send_idx)
        all_to_all_(buf[:self.n_recv], send, self.recv_splits,
                    self.send_splits, "tp_return")
        return torch.index_select(buf, 0, self.gather_idx, out=out)
