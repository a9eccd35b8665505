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
     every parameter leaf is a view of.

With a non-trivial ``tc.faults`` schedule (:mod:`repro_torch.dist.
membership`) the round's active mask is computed on the host from the
step index and sent to the device: every rule runs on the active subset,
absent workers ship no bits and keep their EF memory frozen.  All W
backward passes still run, as the JAX step's ``vmap`` does.  The EF
memory, one (W, N) fp32 buffer, lives in :class:`TrainState` (set by
:func:`init_train_state` when ``comm.wants_ef``).  Sharded aggregation
comes with a later slice; the step raises if a config asks for it.

Metrics (device tensors): ``loss`` and ``ppl_proxy`` (mean over the
active workers, pre-attack), ``lr``, ``grad_global_norm`` (of d),
``fa_weights`` (the (W,) combination weights c), ``worker_influence``
(|c_i| ||g_i|| normalized to sum 1, the norms of the attacked gradients
before the codec), ``comm_bits`` and ``comm_ratio``; under a fault
schedule also ``active_workers`` and ``worker_staleness`` (host tensors:
the schedule is evaluated on the host).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.comm.compressors import CommConfig, get_codec
from repro_torch.comm.error_feedback import init_ef
from repro_torch.core import attacks
from repro_torch.dist.aggregation import (AggregatorConfig, check_rule,
                                          compressed_aggregate)
from repro_torch.dist.membership import FaultSchedule, membership_at
from repro_torch.models import transformer
from repro_torch.models.config import ModelConfig
from repro_torch.optim import Optimizer, apply_updates
from repro_torch.weights import Layout, leaf_items, map_tree, pack, unflatten

__all__ = ["TrainConfig", "TrainState", "init_train_state",
           "train_state_tree", "build_train_step", "global_norm"]


@dataclass(frozen=True)
class TrainConfig:
    """Step settings orthogonal to the model config."""

    aggregator: AggregatorConfig = AggregatorConfig()
    attack: str = "none"              # repro_torch.core.attacks name
    attack_f: int = 0                 # Byzantine worker count (first f)
    microbatch_splits: int = 1        # grad-accumulation splits per worker
    comm: CommConfig = CommConfig()   # worker->server codec (comm/)
    faults: FaultSchedule = FaultSchedule()  # worker churn (membership)
    sharded_agg: bool = False         # later slice


@dataclass
class TrainState:
    """One model replica's training state.  ``params`` is the JAX-layout
    tree whose leaves are autograd leaves sharing storage with ``flat``;
    the optimizer updates ``flat`` (and its own state) in place, so the
    leaves always hold the current weights.  ``ef`` is the (W, N) error
    feedback memory when the codec wants one, else ``None``."""

    flat: torch.Tensor
    layout: Layout
    params: dict
    opt_state: dict
    ef: torch.Tensor | None = None


def init_train_state(cfg: ModelConfig, opt: Optimizer, *, seed: int = 0,
                     device="cpu", params=None,
                     comm: CommConfig = CommConfig(),
                     workers: int = 0) -> TrainState:
    """Fresh state from ``seed``, or from given ``params`` (any tree of
    tensors or numpy arrays in the JAX layout, copied); with a codec that
    wants error feedback, zero EF memory for ``workers`` workers."""
    if params is None:
        params = transformer.init_params(cfg, seed=seed, device=device)
    flat, layout = pack(params, device)
    leaves = map_tree(lambda t: t.detach().requires_grad_(True),
                      unflatten(flat, layout))
    ef = None
    if comm.wants_ef:
        if workers < 1:
            raise ValueError(f"codec {comm.codec!r} carries error feedback: "
                             "init_train_state needs workers >= 1")
        ef = init_ef(flat, workers)
    return TrainState(flat, layout, leaves, opt.init(flat), ef)


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
    share storage with ``flat``, see the restored weights."""
    layout = state.layout
    params = unflatten(state.flat, layout)
    opt_state = {k: unflatten(v, layout) if v.dim() == 1 else v
                 for k, v in state.opt_state.items()}
    if state.ef is None:
        return params, opt_state
    W = state.ef.shape[0]
    views = [state.ef[:, o:o + n].view((W,) + shape) for o, n, shape in
             zip(layout.offsets, layout.sizes, layout.shapes)]
    return params, opt_state, map_tree(lambda i: views[i], layout.skeleton)


def global_norm(tree) -> torch.Tensor:
    """L2 norm over every leaf of a tree of tensors, in fp32."""
    sq = sum(torch.sum(torch.square(t.float())) for _, t in leaf_items(tree))
    return torch.sqrt(torch.as_tensor(sq, dtype=torch.float32))


def _check_supported(tc: TrainConfig) -> None:
    check_rule(tc.aggregator.name)
    if tc.sharded_agg:
        raise NotImplementedError(
            "TrainConfig(sharded_agg=True): sharded aggregation comes with "
            "a later slice of the port")


def build_train_step(cfg: ModelConfig, tc: TrainConfig, opt: Optimizer,
                     sched):
    """Build the train step.

    Returns ``step(state, batch, step_idx) -> metrics``: ``batch`` is the
    worker-major ``{tokens (W, B, S), labels (W, B, S)}`` on the state's
    device, plus ``prefix_embeds`` (W, B, P, d_frontend) for a config
    with a frontend (every key is sliced by worker and micro-batch);
    ``state`` is updated in place.  The step allocates its (W, N)
    gradient buffer at its first call and reuses it.
    """
    _check_supported(tc)
    codec = get_codec(tc.comm)     # one instance: CountSketch keeps its maps
    buf: dict = {}

    def worker_grad(state: TrainState, leaves, row: torch.Tensor, wb):
        """ONE worker's gradient, accumulated into ``row``; -> metrics."""
        row.zero_()
        for t, o, n in zip(leaves, state.layout.offsets, state.layout.sizes):
            t.grad = row[o:o + n].view(t.shape)
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
            loss, m = transformer.forward(state.params, part, cfg)
            loss.backward()
            m = {n: v.detach() for n, v in m.items()}
            metrics = m if metrics is None else {
                n: metrics[n] + m[n] for n in m}
        if k > 1:
            row.mul_(1.0 / k)
            metrics = {n: v * (1.0 / k) for n, v in metrics.items()}
        return metrics

    def step(state: TrainState, batch, step_idx: int):
        W = batch["tokens"].shape[0]
        N = state.layout.numel
        X = buf.get("X")
        if X is None or X.shape != (W, N) or X.device != state.flat.device:
            X = buf["X"] = torch.empty((W, N), dtype=torch.float32,
                                       device=state.flat.device)
        leaves = [t for _, t in leaf_items(state.params)]
        per_worker = []
        for w in range(W):
            wb = {n: v[w] for n, v in batch.items()}
            per_worker.append(worker_grad(state, leaves, X[w], wb))
        for t in leaves:
            t.grad = None

        with torch.no_grad():
            if tc.attack != "none" and tc.attack_f > 0:
                attacks.apply_attack(tc.attack, X, tc.attack_f,
                                     leaf_sizes=state.layout.sizes,
                                     seed=step_idx)
            mem = mask = None
            if not tc.faults.is_trivial:
                mem = membership_at(tc.faults, step_idx, W)
                mask = torch.from_numpy(mem.active.astype(np.float32)).to(
                    X.device)
            # the attacked gradients' norms, before the codec rewrites X
            worker_norms = torch.linalg.vector_norm(X, dim=1)
            d, agg_aux, state.ef = compressed_aggregate(
                X, tc.aggregator, tc.comm, state.ef, layout=state.layout,
                mask=mask, codec=codec)
            lr = sched(step_idx)
            updates, state.opt_state = opt.update(d, state.opt_state,
                                                  state.flat, lr)
            apply_updates(state.flat, updates)

            c = agg_aux["weights"].float()
            influence = c.abs() * worker_norms
            influence = influence / torch.clamp(influence.sum(), min=1e-20)
            if mask is None:
                metrics = {n: torch.stack([m[n] for m in per_worker]).mean()
                           for n in per_worker[0]}
            else:
                # absent workers' losses are not telemetry of the round
                wa = max(float(mem.active.sum()), 1.0)
                metrics = {n: (torch.stack([m[n] for m in per_worker])
                               * mask).sum() / wa for n in per_worker[0]}
            metrics["lr"] = lr
            metrics["grad_global_norm"] = torch.linalg.vector_norm(d.float())
            metrics["fa_weights"] = c
            metrics["worker_influence"] = influence
            metrics["comm_bits"] = agg_aux["comm_bits"]
            metrics["comm_ratio"] = agg_aux["comm_ratio"]
            if mem is not None:
                metrics["active_workers"] = torch.tensor(
                    int(mem.active.sum()))
                metrics["worker_staleness"] = torch.from_numpy(mem.staleness)
        return metrics

    return step
