"""The train step: per-worker grads -> attack -> aggregate -> update.

Port of ``repro/dist/train_step.py`` for one card.  Where the JAX step
``vmap``s ``value_and_grad`` over the workers and later packs the leaves
into a (W, N) stack (a full copy), this step keeps **one worker-major
(W, N) gradient buffer** for the whole run:

  1. **Per-worker gradients** -- a Python loop over workers; before each
     worker's backward pass every parameter's ``.grad`` is pointed at its
     slice of row ``w`` (columns in the canonical order of
     :mod:`repro_torch.weights`), so autograd accumulates straight into
     the buffer.  ``microbatch_splits > 1`` accumulates over sequential
     micro-batches and scales by 1/k, as the JAX scan does.
  2. **Attack injection** -- :mod:`repro_torch.core.attacks` rewrites the
     first ``attack_f`` rows in place.
  3. **Compression and aggregation** --
     :func:`repro_torch.dist.aggregation.compressed_aggregate`: the
     optional :mod:`repro_torch.comm` codec (the CountSketch payload feeds
     the Gram rules' weights directly; every other codec decodes the
     buffer in place, through error feedback when the codec wants it),
     then any rule of ``RULES``: its kernels (Gram, Krum scores, Bulyan
     selection, coordinate statistics, combine) read the buffer in place
     and the update d comes out as one (N,) vector.
  4. **Update** -- the optimizer runs on the flat parameter vector, which
     every parameter leaf is a view of (under ``tc.zero1`` on the rank's
     blocks of it, below).

With a non-trivial ``tc.faults`` schedule (:mod:`repro_torch.dist.
membership`) the round's active mask is computed on the host from the
step index and sent to the device: every rule runs on the active subset,
absent workers ship no bits and keep their EF memory frozen.  All W
backward passes still run, as the JAX step's ``vmap`` does.  The EF
memory, one (W, N) fp32 buffer (under sharded aggregation the rank's
(W, width) shard of it), lives in :class:`TrainState` (set by
:func:`init_train_state` when ``comm.wants_ef``).

**Sharded aggregation** (``tc.sharded_agg`` under an active
:func:`repro_torch.dist.sharding.use_sharding` mesh whose ranks form the
default process group): no rank holds the (W, N) buffer.  Each rank keeps
its coordinate shard of every worker's gradient, one contiguous (W,
width) buffer (:class:`repro_torch.dist.sharding.CoordShards`).  The
model is tensor-parallel over the mesh's ``model`` axis where the rules
split its weights (every configuration on a mesh with ``model`` > 1,
``TrainState.tp``: ``init_train_state(..., sharded=)`` holds the rank's
blocks of the partitioned parameters and of their AdamW moments), else
replicated.  The ranks of a ``model`` group compute the same workers
together, each its part of the tensor-parallel forward and backward
(``repro_torch.dist.tensor_parallel``).  Which ranks compute which worker
follows the JAX package's layout rule for the ``worker`` axis:

* **split** -- where ``worker`` resolves to mesh axes (their product D
  divides W), data group g computes workers ``[g W/D, (g+1) W/D)``.  A
  worker's gradient lands in a one-row buffer (the leaves' ``.grad``
  views point there), and one ``all_to_all`` per worker index of the
  block sends every other group's rank its columns: each rank takes
  worker ``g' W/D + j``'s columns from the rank of group g' with its own
  ``model`` index, and copies its own group's in place;
* **replicated** -- otherwise (rule 4: the worker axis stays
  unconstrained) every data group computes all W workers one row at a
  time and each rank keeps its own columns.

Under tensor parallelism the one-row buffer is the rank's local layout,
and one ``all_to_all`` among the ``model`` group
(``repro_torch.dist.sharded.TPExchange``) first turns the group's blocks
into the columns of the shards its ranks keep and send.

Then, in order: the attack on the shard (the slice of the unsharded
values), the mask, ``compressed_aggregate(..., sharded=)`` (the (W, W)
Gram ``all_reduce``, replicated weights, shard-local combine: the
rank's block of d), d from the ranks' blocks (all-gathered where the
model is replicated; under tensor parallelism each rank's blocks of d,
``repro_torch.dist.sharded.TPReturn``, and |d| from the shards' squared
norms), and the optimizer, identical on every rank (on
the rank's blocks of d and of the parameters under tensor parallelism).  The
metrics
are every rank's: per-worker losses gathered, ``worker_norms`` from the
ranks' sums of squares, ``grad_global_norm`` of the gathered d.  Every
codec runs on the shard, with and without error feedback: the rank
encodes and decodes its own columns, the codec's cross-rank step is a
collective, and the EF memory is the rank's (W, width) shard
(``init_train_state(..., sharded=)``), checkpointed as the whole
(W, *shape) leaves (:func:`train_state_tree`).

**ZeRO-1** (``tc.zero1``, sharded aggregation only; ``init_train_state(
..., zero1=True)``): the optimizer moments are cut over the mesh's
``data`` axis as the JAX dry run's ``--zero1`` cuts them
(:mod:`repro_torch.dist.zero1`): each rank updates its blocks of the
parameters with its moment blocks and all-gathers them over its ``data``
group; the parameters and moments equal those of the step without it,
bit for bit.

Metrics (device tensors): ``loss`` and ``ppl_proxy`` (mean over the
active workers, pre-attack), ``lr``, ``grad_global_norm`` (of d),
``fa_weights`` (the (W,) combination weights c), ``worker_influence``
(|c_i| ||g_i|| normalized to sum 1, the norms of the attacked gradients
before the codec), ``comm_bits`` and ``comm_ratio``; under a fault
schedule also ``active_workers`` and ``worker_staleness`` (host tensors:
the schedule is evaluated on the host).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.analysis.trace import allowed
from repro_torch.comm.compressors import CommConfig, get_codec
from repro_torch.comm.error_feedback import init_ef
from repro_torch.core import attacks
from repro_torch.dist.aggregation import (AggregatorConfig, check_rule,
                                          compressed_aggregate)
from repro_torch.dist.membership import FaultSchedule, membership_at
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.weights import (Layout, TPLayout, leaf_items, map_tree,
                                 pack, tp_slice, tp_take, unflatten)

__all__ = ["TrainConfig", "TrainState", "init_train_state",
           "train_state_tree", "build_train_step", "global_norm",
           "check_train_config"]


@dataclass(frozen=True)
class TrainConfig:
    """Step settings orthogonal to the model config."""

    aggregator: AggregatorConfig = AggregatorConfig()
    attack: str = "none"              # repro_torch.core.attacks name
    attack_f: int = 0                 # Byzantine worker count (first f)
    microbatch_splits: int = 1        # grad-accumulation splits per worker
    comm: CommConfig = CommConfig()   # worker->server codec (comm/)
    faults: FaultSchedule = FaultSchedule()  # worker churn (membership)
    sharded_agg: bool = False         # coordinate-sharded aggregation
                                      # over the active mesh (dist.sharded)
    zero1: bool = False               # optimizer moments cut over data
                                      # (dist.zero1); needs sharded_agg

    def __post_init__(self):
        if self.zero1 and not self.sharded_agg:
            raise ValueError("TrainConfig(zero1=True) cuts the optimizer "
                             "moments over the mesh's data axis: it needs "
                             "sharded_agg=True")


@dataclass
class TrainState:
    """One model replica's training state.  ``params`` is the JAX-layout
    tree whose leaves are autograd leaves sharing storage with ``flat``;
    the optimizer updates ``flat`` (and its own state) in place, so the
    leaves always hold the current weights.  ``ef`` is the (W, N) error
    feedback memory when the codec wants one, else ``None``; under sharded
    aggregation it is the rank's (W, width) coordinate shard, and
    ``ef_shard`` is ``(mesh, CoordShards, shard index)``.  Under tensor
    parallelism ``tp`` is the rank's layout and ``mesh`` its mesh:
    ``flat``, ``layout``, ``params`` and the moments are the rank's blocks
    (``tp.local``), and :attr:`full_layout` is the whole tree's.  Under
    ZeRO-1 ``zero1`` is the cut of the moments over ``data`` (a layout
    over ``layout``, ``repro_torch.dist.zero1.zero1_layout``): the flat
    moments are the rank's blocks (``zero1.local``)."""

    flat: torch.Tensor
    layout: Layout
    params: dict
    opt_state: dict
    ef: torch.Tensor | None = None
    ef_shard: tuple | None = None
    tp: TPLayout | None = None
    mesh: object = None
    zero1: TPLayout | None = None

    @property
    def full_layout(self) -> Layout:
        """The layout of the model's whole tree (of the gradient stack)."""
        return self.layout if self.tp is None else self.tp.full


def init_train_state(cfg: ModelConfig, opt: Optimizer, *, seed: int = 0,
                     device="cpu", params=None,
                     comm: CommConfig = CommConfig(),
                     workers: int = 0, sharded=None,
                     zero1: bool = False) -> TrainState:
    """Fresh state from ``seed``, or from given ``params`` (any tree of
    tensors or numpy arrays in the JAX layout, copied); with a codec that
    wants error feedback, zero EF memory for ``workers`` workers: (W, N),
    or with ``sharded`` (a ``repro_torch.launch.mesh.Mesh``, or ``True``
    for the active ``use_sharding`` mesh, as ``TrainConfig(sharded_agg=
    True)`` runs under) this rank's (W, width) coordinate shard.  With
    ``sharded``, where the mesh's rules (the active ones on that mesh,
    else its defaults) split the model's weights over ``model``
    (:func:`repro_torch.models.transformer.tp_layout`), the state holds
    this rank's blocks: drawn as the blocks of the whole tree's draws, or
    cut from the given whole ``params``.  With ``zero1`` (needs
    ``sharded``) the moments are the rank's ZeRO-1 blocks, zero like the
    whole ones."""
    tp = mesh = z = None
    if zero1 and not sharded:
        raise ValueError("init_train_state(zero1=True) cuts the moments "
                         "over the mesh's data axis: it needs sharded=")
    if sharded:
        tp, mesh = _tp_of(cfg, sharded)
    if params is None:
        params = transformer.init_params(cfg, seed=seed, device=device,
                                         layout=tp)
    elif tp is not None:
        params = tp_slice(params, tp)
    flat, layout = pack(params, device)
    leaves = map_tree(lambda t: t.detach().requires_grad_(True),
                      unflatten(flat, layout))
    ef = ef_shard = None
    if comm.wants_ef:
        if workers < 1:
            raise ValueError(f"codec {comm.codec!r} carries error feedback: "
                             "init_train_state needs workers >= 1")
        width = None
        if sharded:
            from repro_torch.dist.sharded import coord_shards, shard_index
            full = layout if tp is None else tp.full
            shards = coord_shards(full.sizes, mesh)
            ef_shard, width = (mesh, shards, shard_index(mesh)), shards.width
        ef = init_ef(flat, workers, width)
    if zero1:
        z = _zero1_of(layout, tp, mesh)
    return TrainState(flat, layout, leaves, opt.init(
        flat if z is None else flat.new_empty(z.local.numel)), ef, ef_shard,
        tp, mesh if tp is not None or z is not None else None, z)


def _zero1_of(layout: Layout, tp: TPLayout | None, mesh) -> TPLayout:
    """This rank's ZeRO-1 cut of the moments of its local tree
    ``layout``."""
    import torch.distributed as dist

    from repro_torch.dist.zero1 import zero1_layout
    rank = dist.get_rank() if dist.is_initialized() else 0
    return zero1_layout(layout, tp.dims if tp is not None else
                        (None,) * len(layout.shapes), mesh, rank)


def _tp_of(cfg: ModelConfig, sharded):
    """``(layout or None, mesh)``: this rank's tensor-parallel layout of
    ``cfg`` on the mesh of ``sharded`` under its rules (the active ones
    when that mesh is active, else the mesh's defaults), ``None`` where
    it splits nothing."""
    import torch.distributed as dist

    from repro_torch.dist.aggregation import _sharded_mesh
    from repro_torch.dist.sharding import (current_mesh, current_rules,
                                           resolve_rules)
    mesh = _sharded_mesh(sharded)
    rules = (current_rules() if current_mesh() == mesh
             else resolve_rules(mesh))
    rank = dist.get_rank() if dist.is_initialized() else 0
    tp = transformer.tp_layout(cfg, mesh, rules, rank)
    return (tp if tp.is_split else None), mesh


def train_state_tree(state: TrainState):
    """The state as the JAX package's checkpoint tree: ``(params,
    opt_state)``, or ``(params, opt_state, ef)`` with error feedback, with
    the JAX layout's leaves (``opt_state`` as ``repro.optim`` builds it:
    AdamW's ``{"count", "mu", "nu"}``, SGD's ``{"mu"}`` or ``{}``; EF
    leaves shaped ``(W, *leaf.shape)``).

    Every leaf is a view of the state's own storage (``flat``, the flat
    moments, ``ef``; ``count`` is the tensor itself), so saving reads the
    live state and loading into the tree (``repro_torch.checkpoint.
    load_checkpoint``) restores it in place: the parameter leaves, which
    share storage with ``flat``, see the restored weights.  A sharded EF
    memory's leaves are ``repro_torch.dist.sharded.ShardLeaf``: saved as
    the whole leaves (gathered to rank 0), loaded as the rank's
    columns.  Under tensor parallelism a partitioned parameter or moment
    leaf is a ``repro_torch.dist.tensor_parallel.TPLeaf``: saved as the
    whole leaf (gathered to rank 0), loaded as the rank's block.  Under
    ZeRO-1 a cut moment leaf is a ``TPLeaf`` over ``data`` (inside the
    ``model`` one where the leaf is partitioned), saved and loaded so too:
    the files are those of a run without it."""
    layout = state.layout

    def tree(flat, z=None):
        t = unflatten(flat, layout if z is None else z.local)
        if state.tp is None and z is None:
            return t
        from repro_torch.dist.tensor_parallel import TPLeaf
        none = (None,) * len(layout.shapes)
        views = []
        for i, ((_, v), d, zd) in enumerate(zip(
                leaf_items(t), none if state.tp is None else state.tp.dims,
                none if z is None else z.dims)):
            if zd is not None:
                v = TPLeaf(v, z, i, state.mesh, axis="data")
            views.append(v if d is None else
                         TPLeaf(v, state.tp, i, state.mesh))
        return map_tree(lambda i: views[i], layout.skeleton)
    params = tree(state.flat)
    opt_state = {k: tree(v, state.zero1) if v.dim() == 1 else v
                 for k, v in state.opt_state.items()}
    if state.ef is None:
        return params, opt_state
    W = state.ef.shape[0]
    if state.ef_shard is not None:
        from repro_torch.dist.sharded import ShardLeaf
        mesh, shards, s = state.ef_shard
        views = [ShardLeaf(state.ef, shards, s, i, shape, mesh)
                 for i, shape in enumerate(state.full_layout.shapes)]
    else:
        views = [state.ef[:, o:o + n].view((W,) + shape) for o, n, shape in
                 zip(layout.offsets, layout.sizes, layout.shapes)]
    return params, opt_state, map_tree(lambda i: views[i], layout.skeleton)


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every leaf of a tree of tensors, in fp32."""
    sq = sum(torch.sum(torch.square(t.float())) for _, t in leaf_items(tree))
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def check_train_config(tc: TrainConfig) -> None:
    """Raise ``KeyError`` for a rule or a codec the port does not know
    (before any weight is drawn); every known pair runs, sharded or not."""
    check_rule(tc.aggregator.name)
    get_codec(tc.comm)


def _stack_metrics(per_worker: dict, W: int, device) -> tuple:
    """(names, (W, n_metrics) tensor) of per-worker metric dicts keyed by
    worker index (rows of absent workers 0)."""
    names = list(next(iter(per_worker.values())))
    vals = torch.zeros((W, len(names)), dtype=torch.float32, device=device)
    for w, m in per_worker.items():
        vals[w] = torch.stack([m[n].float() for n in names])
    return names, vals


def build_train_step(cfg: ModelConfig, tc: TrainConfig, opt: Optimizer,
                     sched):
    """Build the train step.

    Returns ``step(state, batch, step_idx) -> metrics``: ``batch`` is the
    worker-major ``{tokens (W, B, S), labels (W, B, S)}`` on the state's
    device, plus ``prefix_embeds`` (W, B, P, d_frontend) for a config
    with a frontend (every key is sliced by worker and micro-batch);
    ``state`` is updated in place.  The step allocates its gradient
    buffers at its first call and reuses them: the (W, N) buffer, or with
    ``tc.sharded_agg`` the rank's (W, width) shard, a one-row buffer and
    the exchange buffers (under tensor parallelism the exchange's index
    maps; its data buffers live through a step's worker loop only).
    """
    check_train_config(tc)
    codec = get_codec(tc.comm)     # one instance: CountSketch keeps its maps
    buf: dict = {}

    def buffer(name, shape, device):
        t = buf.get(name)
        if t is None or t.shape != shape or t.device != device:
            buf.pop(name, None)
            t = buf[name] = torch.empty(shape, dtype=torch.float32,
                                        device=device)
        return t

    def worker_grad(state: TrainState, leaves, row: torch.Tensor, views,
                    wb, tp=None):
        """ONE worker's gradient, accumulated into ``row`` through the
        leaves' ``.grad`` ``views`` of it (with ``tp``, this rank's part
        of the tensor-parallel forward and backward); -> metrics."""
        row.zero_()
        for t, g in zip(leaves, views):
            t.grad = g
        k = tc.microbatch_splits
        B = wb["tokens"].shape[0]
        if k > 1 and B % k != 0:
            raise ValueError(
                f"microbatch_splits={k} must divide the per-worker batch "
                f"size B={B}")
        metrics = None
        for mb in range(max(k, 1)):
            part = {n: v[mb * B // k:(mb + 1) * B // k] if k > 1 else v
                    for n, v in wb.items()}
            loss, m = transformer.forward(state.params, part, cfg, tp)
            loss.backward()
            m = {n: v.detach() for n, v in m.items()}
            metrics = m if metrics is None else {
                n: metrics[n] + m[n] for n in m}
        if k > 1:
            row.mul_(1.0 / k)
            metrics = {n: v * (1.0 / k) for n, v in metrics.items()}
        return metrics

    def finish(state, X, per_worker_vals, names, worker_norms, step_idx,
               mem, mask, sharded, shards=None):
        """Aggregate, update and report (both paths)."""
        d, agg_aux, state.ef = compressed_aggregate(
            X, tc.aggregator, tc.comm, state.ef, layout=state.full_layout,
            mask=mask, codec=codec, sharded=sharded)
        lr = sched(step_idx)
        if sharded:             # d is this rank's (width,) block
            d, d_norm = from_shards(state, d, sharded, shards)
        else:
            d_norm = torch.linalg.vector_norm(d.float())
        if state.zero1 is None:
            updates, state.opt_state = opt.update(d, state.opt_state,
                                                  state.flat, lr)
            apply_updates(state.flat, updates)
            del updates
        else:                   # the rank's blocks, then all-gathered
            from repro_torch.dist import zero1
            d_blocks = tp_take(d, state.zero1)
            del d                   # each temporary freed before the next
            p_blocks, state.opt_state = zero1.update(
                opt, state.zero1, state.flat, d_blocks, state.opt_state, lr)
            del d_blocks
            zero1.all_gather_(state.zero1, state.flat, p_blocks, sharded)
            del p_blocks

        c = agg_aux["weights"].float()
        influence = c.abs() * worker_norms
        influence = influence / torch.clamp(influence.sum(), min=1e-20)
        if mask is None:
            metrics = {n: per_worker_vals[n].mean() for n in names}
        else:
            # absent workers' losses are not telemetry of the round
            wa = max(float(mem.active.sum()), 1.0)
            metrics = {n: (per_worker_vals[n] * mask).sum() / wa
                       for n in names}
        metrics["lr"] = lr
        metrics["grad_global_norm"] = d_norm
        metrics["fa_weights"] = c
        metrics["worker_influence"] = influence
        metrics["comm_bits"] = agg_aux["comm_bits"]
        metrics["comm_ratio"] = agg_aux["comm_ratio"]
        if mem is not None:
            metrics["active_workers"] = torch.tensor(int(mem.active.sum()))
            metrics["worker_staleness"] = torch.from_numpy(mem.staleness)
        return metrics

    def from_shards(state, d_block, mesh, shards):
        """(d as the update takes it, |d|) from this rank's ``(width,)``
        block of the shards: the whole d gathered where the model is
        replicated; under tensor parallelism the rank's blocks of d
        (:class:`~repro_torch.dist.sharded.TPReturn`, built at its first
        use and kept) and |d| from the shards' squared norms."""
        from repro_torch.dist.sharded import (TPReturn, all_reduce_,
                                              gather_flat)
        if state.tp is None:
            d = gather_flat(d_block, shards, mesh)
            return d, torch.linalg.vector_norm(d.float())
        d_norm = torch.sqrt(all_reduce_(
            torch.linalg.vector_norm(d_block.float()).square().reshape(1),
            "d_norm_all_reduce"))[0]
        key = (state.tp, mesh)
        ret = buf.get("return")
        if ret is None or ret[0] != key:
            ret = buf["return"] = (key, TPReturn(state.tp, shards, mesh,
                                                 d_block.device))
        return ret[1].run(d_block, buffer(
            "d_local", (state.layout.numel,), d_block.device)), d_norm

    def membership(step_idx, W, device):
        if tc.faults.is_trivial:
            return None, None
        mem = membership_at(tc.faults, step_idx, W)
        with allowed("transfer", "the round's mask is built on the host and "
                     "uploaded each step (JAX computes it inside the "
                     "step): ROADMAP perf item 1"):
            return mem, torch.from_numpy(mem.active.astype(np.float32)).to(
                device)

    def step(state: TrainState, batch, step_idx: int):
        if tc.sharded_agg:
            return sharded_step(state, batch, step_idx)
        if state.tp is not None or state.zero1 is not None:
            raise ValueError("a tensor-parallel or zero1 state trains only "
                             "under TrainConfig(sharded_agg=True)")
        W = batch["tokens"].shape[0]
        N = state.layout.numel
        X = buffer("X", (W, N), state.flat.device)
        leaves = [t for _, t in leaf_items(state.params)]
        per_worker = []
        for w in range(W):
            wb = {n: v[w] for n, v in batch.items()}
            views = [X[w, o:o + n].view(t.shape) for t, o, n in zip(
                leaves, state.layout.offsets, state.layout.sizes)]
            per_worker.append(worker_grad(state, leaves, X[w], views, wb))
        for t in leaves:
            t.grad = None

        with torch.no_grad():
            if tc.attack != "none" and tc.attack_f > 0:
                attacks.apply_attack(tc.attack, X, tc.attack_f,
                                     leaf_sizes=state.layout.sizes,
                                     seed=step_idx)
            mem, mask = membership(step_idx, W, X.device)
            # the attacked gradients' norms, before the codec rewrites X
            worker_norms = torch.linalg.vector_norm(X, dim=1)
            names = list(per_worker[0])
            vals = {n: torch.stack([m[n] for m in per_worker])
                    for n in names}
            return finish(state, X, vals, names, worker_norms, step_idx,
                          mem, mask, None)

    def sharded_step(state: TrainState, batch, step_idx: int):
        import torch.distributed as dist

        from repro_torch.dist.sharded import (all_to_all_, coord_shards,
                                              shard_index)
        from repro_torch.dist.sharding import (current_mesh, current_rules,
                                               logical_spec)
        mesh = current_mesh()
        if mesh is None:
            raise ValueError(
                "TrainConfig(sharded_agg=True) needs an active mesh: wrap "
                "the step in repro_torch.dist.sharding.use_sharding(...)")
        W = batch["tokens"].shape[0]
        dev = state.flat.device
        shards = coord_shards(state.full_layout.sizes, mesh)
        s, R, rank = shard_index(mesh), mesh.size, dist.get_rank()
        _check_tp(state, cfg, tc, mesh, rank)
        Xs = buffer("Xs", (W, shards.width), dev)
        leaves = [t for _, t in leaf_items(state.params)]
        spec = logical_spec((W,), ("worker",), mesh, current_rules())[0]
        per_worker = {}
        if state.tp is not None:
            return tp_step(state, batch, step_idx, mesh, shards, Xs, leaves,
                           spec)
        row = buffer("row", (shards.padded_numel,), dev)
        views = shards.padded_views(row, state.layout.shapes)
        if spec is None:                      # replicated: all W here
            for w in range(W):
                wb = {n: v[w] for n, v in batch.items()}
                per_worker[w] = worker_grad(state, leaves, row, views, wb)
                shards.take(row, slice(s, s + 1), Xs[w:w + 1])
        else:                                 # split over the worker axes
            waxes = (spec,) if isinstance(spec, str) else tuple(spec)
            rest = tuple(a for a in mesh.axis_names if a not in waxes)
            if mesh.axis_names != tuple(a for a in mesh.axis_names
                                        if a in waxes) + rest:
                raise ValueError(f"the worker axes {waxes} must lead the "
                                 f"mesh axes {mesh.axis_names}")
            D = math.prod(mesh.shape[a] for a in waxes)
            M, per = R // D, W // D
            g, m = mesh.flat_index(rank, waxes), mesh.flat_index(rank, rest)
            # one row to and from each other group's rank of model index
            # m; this rank's own columns are copied in place
            splits = [int(r % M == m and r != rank) for r in range(R)]
            send = buffer("send", (D - 1, shards.width), dev)
            recv = buffer("recv", (D - 1, shards.width), dev)
            blocks = Xs.view(D, per, shards.width)
            for j in range(per):
                w = g * per + j
                wb = {n: v[w] for n, v in batch.items()}
                metrics = worker_grad(state, leaves, row, views, wb)
                per_worker[w] = metrics if m == 0 else {
                    n: torch.zeros_like(v) for n, v in metrics.items()}
                with torch.no_grad():
                    shards.take(row, slice(s, s + 1), Xs[w:w + 1])
                    shards.take(row, slice(m, g * M, M), send[:g])
                    shards.take(row, slice((g + 1) * M + m, None, M),
                                send[g:])
                    all_to_all_(recv, send, splits, splits, "all_to_all")
                    blocks[:g, j].copy_(recv[:g])
                    blocks[g + 1:, j].copy_(recv[g:])
        for t in leaves:
            t.grad = None
        return sharded_finish(state, Xs, per_worker, spec, step_idx, mesh,
                              shards)

    def sharded_finish(state, Xs, per_worker, spec, step_idx, mesh, shards):
        """Attack, mask, norms and metrics on the shards, then
        :func:`finish` (both sharded paths)."""
        from repro_torch.dist.sharded import all_reduce_, shard_index
        W, dev = Xs.shape[0], Xs.device
        with torch.no_grad():
            if tc.attack != "none" and tc.attack_f > 0:
                attacks.apply_attack(tc.attack, Xs, tc.attack_f,
                                     seed=step_idx, shards=shards,
                                     shard=shard_index(mesh))
            mem, mask = membership(step_idx, W, dev)
            worker_norms = torch.sqrt(all_reduce_(
                torch.linalg.vector_norm(Xs, dim=1) ** 2, "norms_all_reduce"))
            names, vals = _stack_metrics(per_worker, W, dev)
            if spec is not None:      # each worker's metrics from one rank
                all_reduce_(vals, "metrics_all_reduce")
            vals = {n: vals[:, i].contiguous() for i, n in enumerate(names)}
            return finish(state, Xs, vals, names, worker_norms, step_idx,
                          mem, mask, mesh, shards)

    def tp_step(state, batch, step_idx, mesh, shards, Xs, leaves, spec):
        """The sharded step of a tensor-parallel state: each worker's
        gradient in the rank's local layout, moved into the shard rows of
        the group's ranks by :class:`~repro_torch.dist.sharded.
        TPExchange`, then the split path's data-group exchange."""
        import torch.distributed as dist

        from repro_torch.dist import tensor_parallel
        from repro_torch.dist.sharded import TPExchange, all_to_all_
        W, dev, rank = Xs.shape[0], Xs.device, dist.get_rank()
        tp = tensor_parallel.for_mesh(mesh, rank)
        M, m = tp.parts, tp.index
        if spec is None:
            D, g, per = 1, 0, W
            targets = [[rank - m + r] for r in range(M)]
        else:
            waxes = (spec,) if isinstance(spec, str) else tuple(spec)
            D = math.prod(mesh.shape[a] for a in waxes)
            if mesh.axis_names[-1] != "model" or D * M != mesh.size:
                raise ValueError(f"tensor parallelism with split workers "
                                 f"needs a mesh of the worker axes {waxes} "
                                 f"then model, got {mesh.axis_names}")
            g, per = mesh.flat_index(rank, waxes), W // D
            targets = [[h * M + r for h in range(D)] for r in range(M)]
        key = (state.tp, targets[m])
        ex = buf.get("exchange")
        if ex is None or ex[0] != key:
            ex = buf["exchange"] = (key, TPExchange(
                state.tp, shards, targets, tp.group, dev))
        ex = ex[1]
        ex.open()
        row = ex.row                      # the worker's local gradient
        views = [row[o:o + n].view(shape) for o, n, shape in zip(
            state.layout.offsets, state.layout.sizes, state.layout.shapes)]
        if spec is not None:
            T = buffer("tp_rows", (D, shards.width), dev)
            splits = [int(r % M == m and r // M != g)
                      for r in range(mesh.size)]
            send = buffer("send", (D - 1, shards.width), dev)
            recv = buffer("recv", (D - 1, shards.width), dev)
            blocks = Xs.view(D, per, shards.width)
        per_worker = {}
        for j in range(per):
            w = g * per + j
            wb = {n: v[w] for n, v in batch.items()}
            metrics = worker_grad(state, leaves, row, views, wb, tp)
            per_worker[w] = metrics if spec is None or m == 0 else {
                n: torch.zeros_like(v) for n, v in metrics.items()}
            with torch.no_grad():
                if spec is None:
                    ex.run(Xs[w:w + 1])
                    continue
                ex.run(T)
                Xs[w].copy_(T[g])
                send[:g].copy_(T[:g])
                send[g:].copy_(T[g + 1:])
                all_to_all_(recv, send, splits, splits, "all_to_all")
                blocks[:g, j].copy_(recv[:g])
                blocks[g + 1:, j].copy_(recv[g:])
        for t in leaves:
            t.grad = None
        del row, views
        ex.close()
        return sharded_finish(state, Xs, per_worker, spec, step_idx, mesh,
                              shards)

    step.membership = membership   # the round's mask (analysis)
    return step


def _check_tp(state: TrainState, cfg: ModelConfig, tc: TrainConfig, mesh,
              rank: int) -> None:
    """The state's tensor-parallel layout must be the one the active
    rules give on ``mesh``, and its moments cut over ``data`` exactly
    where ``tc.zero1`` asks, as the mesh cuts them (no silent mix of
    layouts)."""
    from repro_torch.dist.sharding import current_rules
    want = transformer.tp_layout(cfg, mesh, current_rules(), rank)
    want = want.dims if want.is_split else None
    have = state.tp.dims if state.tp is not None else None
    if want != have:
        raise ValueError(
            f"the state's parameter split {have} is not the one the active "
            f"rules give on mesh {mesh.shape} ({want}; None: replicated): "
            "build the state with init_train_state(..., sharded=mesh) "
            "under the same rules")
    z = _zero1_of(state.layout, state.tp, mesh) if tc.zero1 else None
    if state.zero1 != z:
        raise ValueError(
            f"TrainConfig(zero1={tc.zero1}) on mesh {mesh.shape} cuts the "
            f"moments as {None if z is None else z.dims}, the state holds "
            f"{None if state.zero1 is None else state.zero1.dims}: build "
            f"the state with init_train_state(..., zero1={tc.zero1})")
