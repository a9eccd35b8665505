"""Megatron-style tensor parallelism over the mesh's ``model`` axis.

The JAX package gets tensor parallelism from GSPMD: its model code
annotates every weight with logical axes (``repro/dist/sharding.py``'s
``DEFAULT_RULES`` map ``vocab``, ``mlp``, ``qkv``, ``heads`` and
``kv_heads`` to ``model``) and the partitioner inserts the collectives.
The port partitions every configuration's weights by the same rules
(``repro_torch.dist.sharding.param_layout``; ``experts``,
``expert_mlp``, ``state`` and ``heads`` as well for the MoE and
recurrent blocks) and places the activations and collectives by hand, as
Megatron-LM does.  :class:`TensorParallel` is
a rank's handle on its ``model`` group (``parts`` ranks, this one at
``index``); the model code (``repro_torch.models``) takes it as ``tp``
and calls its four autograd Functions:

* :meth:`~TensorParallel.copy` -- forward the identity (a bf16 input
  that needs a gradient carried in fp32), backward an ``all_reduce`` of
  the gradient (fp32 partials, summed in fp32 and cast to the input's
  dtype once, after the sum): the input of column-parallel products
  (``wq`` / ``wk`` / ``wv``, ``up`` / ``gate``, the expert banks under
  ``expert_mlp``, the recurrent blocks' input projections, the
  vocab-parallel unembedding), whose rank-local products each give a
  part of its gradient;
* :meth:`~TensorParallel.reduce` -- forward an ``all_reduce``, backward
  the identity: the output of the row-parallel products (fp32 partials,
  ``models.layers.product_f32``, cast after the sum: ``wo``,
  ``down``, the banks' ``w_down``, the RG-LRU's fp32 gates, the mLSTM's
  gates), the vocab-parallel embedding's masked lookups and the loss's
  partial sums;
* :meth:`~TensorParallel.gather` -- forward an ``all_gather`` of the
  ranks' blocks, backward this rank's slice of the gradient: q / k / v
  where the heads do not divide over the ranks (smollm-360m's 15 heads on
  2 ranks: each rank's ``qkv`` block ends mid-head), gathered before RoPE
  and attention, which then run on every head on every rank; a value a
  replicated leaf acts on (the recurrent blocks' convs and norms,
  :meth:`~TensorParallel.gather_cat`); the experts' outputs under expert
  parallelism;
* :meth:`~TensorParallel.split` -- the inverse of ``gather``: forward the
  rank's block of a dimension, backward an ``all_gather``: the attention
  output back to the rank's ``qkv`` block before the row-parallel ``wo``,
  a whole value back to the rank's channels or heads
  (:meth:`~TensorParallel.split_groups` for the rank's block of each of
  several groups: the sLSTM's four gates), the rank's experts' cells of
  the dispatch buffer.

Every value outside the partitioned products (the residual stream, the
norms, the convs, the router, the loss) is replicated on the ranks of a
group, and so is its gradient: the ranks of a group run the same program
on the same bits, so a replicated leaf's gradient is the same bits on
every rank.
:meth:`~TensorParallel.vocab_nll` is the vocab-parallel log-softmax and
NLL: the logits' maximum, the sum of exponentials and the target's
logit each reduced over the group.

A checkpoint holds the whole leaves, as a one-device run writes them:
:class:`TPLeaf` gathers a partitioned parameter or optimizer leaf to rank
0 over its ``model`` group one leaf at a time (kind ``tp_ckpt_gather``),
and every rank loads its block of the leaf from the file.

Each collective is counted in ``repro_torch.dist.sharded.comm_stats``
(calls, bytes of this rank's input and, with ``comm_stats_timed(True)``,
seconds) under its kind: ``tp_copy``, ``tp_reduce``, ``tp_gather``,
``tp_split``, ``tp_loss``, ``tp_argmax`` (:meth:`~TensorParallel.
vocab_argmax`, serving's greedy token), the decode's
``tp_cache_scores`` and ``tp_cache_out`` (``models.attention.
attn_decode`` on a cache split by ``head_dim``), ``tp_exchange`` for the
gradient blocks' move into the coordinate shards (``repro_torch.dist.sharded.
TPExchange``) and ``tp_return`` for d's blocks back to their ranks
(``repro_torch.dist.sharded.TPReturn``).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.checkpoint import DeferredLeaf, copy_leaf
from repro_torch.dist.sharded import _run, all_gather_rows, all_reduce_
from repro_torch.weights import TPLayout

__all__ = ["TensorParallel", "for_mesh", "TPLeaf"]


class TensorParallel:
    """A rank's ``model`` group: ``parts`` ranks in ``group``, this rank
    at ``index`` (module docstring)."""

    def __init__(self, group, parts: int, index: int):
        self.group, self.parts, self.index = group, parts, index

    def all_reduce_(self, t: torch.Tensor, kind: str,
                    op=dist.ReduceOp.SUM) -> torch.Tensor:
        """In-place ``all_reduce`` of ``t`` over the group."""
        return all_reduce_(t, kind, op, group=self.group)

    def all_gather(self, t: torch.Tensor, kind: str) -> torch.Tensor:
        """``(parts, *t.shape)``: every rank's ``t``, in group order."""
        return all_gather_rows(t, kind, group=self.group)

    def copy(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` for column-parallel products.  A low-precision ``x`` that
        needs a gradient is carried in fp32: the products' gradients of it
        come back as fp32 partials (``models.layers.matmul_c``), the group
        sums them in fp32 and the cast to ``x``'s dtype follows the sum,
        as JAX's partitioned backward does."""
        if x.dtype in (torch.bfloat16, torch.float16) and x.requires_grad \
                and torch.is_grad_enabled():
            x = x.float()
        return _Copy.apply(x, self)

    def reduce(self, x: torch.Tensor, kind: str = "tp_reduce"
               ) -> torch.Tensor:
        return _Reduce.apply(x, self, kind)

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """``(parts, *x.shape)`` of every rank's ``x``."""
        return _Gather.apply(x, self)

    def split(self, x: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """This rank's block of dimension ``dim`` of the replicated
        ``x``."""
        return _Split.apply(x, self, dim)

    def gather_cat(self, x: torch.Tensor) -> torch.Tensor:
        """The whole last dimension from the ranks' blocks ``x``, in
        group order (:meth:`gather`, concatenated)."""
        return torch.cat(list(self.gather(x).unbind(0)), dim=-1)

    def split_groups(self, x: torch.Tensor, groups: int) -> torch.Tensor:
        """This rank's block of each of the ``groups`` equal groups of the
        replicated ``x``'s last dimension, concatenated (:meth:`split`
        of the last dimension reordered rank-major): the gates of the
        rank's heads out of ``(.., 4, H, dh)``, its channels of both
        halves of ``[xm | z]``."""
        *lead, n = x.shape
        k = n // groups // self.parts
        x = x.reshape(*lead, groups, self.parts, k).transpose(-3, -2)
        return self.split(x.reshape(*lead, n))

    def vocab_nll(self, logits: torch.Tensor,
                  labels: torch.Tensor) -> torch.Tensor:
        """Per-position NLL ``log sum_v exp(z_v) - z_label`` (``z`` the
        logits less their maximum over the vocabulary) from this rank's
        ``(..., V / parts)`` block of the vocabulary, vocabulary block
        ``index``: the maximum, the sum of exponentials and the target's
        logit each reduced over the group, in ``logits``' dtype."""
        Vl = logits.shape[-1]
        lo = self.index * Vl
        with torch.no_grad():
            gmax = self.all_reduce_(logits.amax(dim=-1).contiguous(),
                                    "tp_loss", op=dist.ReduceOp.MAX)
        z = logits - gmax[..., None]
        inside = (labels >= lo) & (labels < lo + Vl)
        zt = torch.gather(z, -1, torch.where(inside, labels - lo, 0)[
            ..., None])[..., 0]
        parts = self.reduce(torch.stack(
            [torch.exp(z).sum(dim=-1),
             torch.where(inside, zt, torch.zeros_like(zt))]), "tp_loss")
        return torch.log(parts[0]) - parts[1]

    def vocab_argmax(self, logits: torch.Tensor) -> torch.Tensor:
        """The greedy token ``(...,)`` int64 over the whole vocabulary
        from this rank's ``(..., V / parts)`` block (vocabulary block
        ``index``): each rank's maximum and its first index, gathered over
        the group (one ``all_gather``, kind ``tp_argmax``); the largest
        maximum wins, ties to the lowest global index (the lowest block,
        then the first index in it), as ``jnp.argmax`` picks.  Every rank
        returns the same tokens."""
        Vl = logits.shape[-1]
        val, idx = logits.max(dim=-1)
        both = self.all_gather(torch.stack(
            [val.double(), (idx + self.index * Vl).double()]), "tp_argmax")
        best = both[:, 0].argmax(dim=0, keepdim=True)    # first: lowest
        return both[:, 1].gather(0, best)[0].long()

def for_mesh(mesh, rank: int) -> TensorParallel:
    """The handle of ``rank``'s ``model`` group of ``mesh`` (the world's
    subgroups, ``repro_torch.launch.mesh.axis_group``)."""
    from repro_torch.launch.mesh import axis_group
    return TensorParallel(axis_group(mesh, "model"), mesh.shape["model"],
                          mesh.coords(rank)["model"])


class _Copy(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce_(g.contiguous().clone(), "tp_copy"), None


class _Reduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, kind):
        return tp.all_reduce_(x.contiguous().clone(), kind)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return tp.all_gather(x, "tp_gather")

    @staticmethod
    def backward(ctx, g):
        return g[ctx.tp.index].contiguous(), None


class _Split(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        k = x.shape[dim] // tp.parts
        return x.narrow(dim, tp.index * k, k).contiguous()

    @staticmethod
    def backward(ctx, g):
        parts = ctx.tp.all_gather(g, "tp_split")
        return torch.cat(list(parts.unbind(0)), dim=ctx.dim), None, None


class TPLeaf(DeferredLeaf):
    """Leaf ``i`` of a tensor-parallel tree: ``local``, this rank's block
    (layout ``tp`` on ``mesh``), seen by a checkpoint as the whole leaf.
    :meth:`to_host` gathers the blocks of the ranks of rank 0's ``model``
    group to rank 0 (the other groups hold the same values and send
    nothing); :meth:`load_` takes this rank's block of the whole leaf."""

    def __init__(self, local: torch.Tensor, tp: TPLayout, i: int, mesh):
        from repro_torch.launch.mesh import axis_group
        self.local, self.tp, self.i, self.mesh = local, tp, i, mesh
        self.group = axis_group(mesh, "model")   # made on every rank
        self.shape = tuple(tp.full.shapes[i])
        self.dtype = local.dtype

    def to_host(self) -> np.ndarray | None:
        rank = dist.get_rank()
        if any(c for a, c in self.mesh.coords(rank).items() if a != "model"):
            return None
        block = self.local.detach().contiguous()
        out = (torch.empty((self.tp.parts,) + tuple(block.shape),
                           dtype=block.dtype, device=block.device)
               if rank == 0 else None)
        _run("tp_ckpt_gather", block.numel() * block.element_size(), block,
             lambda: dist.gather(block, list(out.unbind(0)) if rank == 0
                                 else None, dst=0, group=self.group),
             collective="gather")
        if out is None:
            return None
        return np.concatenate(list(out.cpu().numpy()),
                              axis=self.tp.dims[self.i])

    def load_(self, src: torch.Tensor) -> None:
        copy_leaf(self.local, src[self.tp.block(self.i)])
