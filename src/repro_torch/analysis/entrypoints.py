"""The public-entry-point sweep: what ``python -m repro_torch.launch.lint``
checks (port of ``repro/analysis/entrypoints.py``).

One place defines which calls are linted and against which rules; the
CLI and ``tests/test_torch_lint.py`` consume :func:`run_sweep`.  Entries
mirror JAX's at the same sizes and seeds:

* ``fa_weights_from_gram`` (rank-p solver, p = 32) -- SHAPE ``max_dim =
  p`` with ``require_dims = {p}``, PRECISION, TRANSFER.
* ``aggregate_tree`` for **all 11 rules** x {plain, masked, sketch} at W =
  8 -- PRECISION + TRANSFER; MASK on the masked variant.
* ``compressed_aggregate`` (CountSketch gram-feed; signSGD + EF) --
  PRECISION + TRANSFER, MASK on the gram-feed.
* serving (prefill + one decode step) on smollm-360m's smoke config at
  **bf16 compute** -- PRECISION + TRANSFER.
* the train step (churn faults, the Flag Aggregator) -- PRECISION +
  TRANSFER.
* RECOMPILE -- the step's membership mask, the masked solver and the
  serve step must keep one trace signature over value sweeps.
* **kernel entries** -- every hand-written kernel's launch on fake CUDA
  tensors, its site count pinned (``ksites``); KSENTINEL over the
  masked-selection sources; on the card KBUDGET over the real build.
* sharded entries (``sharded='force'``, or ``'auto'`` with >= 8 CUDA
  devices): ``aggregate_tree(..., sharded=)`` for all 11 rules as rank 0
  of a fake world of 8 ranks (``launch.dryrun.fake_world``) -- SHAPE
  no-full-width, COLLECTIVES (JAX's budget, ``4 n 2 + 4 W^2 64`` bytes),
  PRECISION, TRANSFER -- and the kernel sites of the sharded path.
* two entries JAX lacks, as rank 0 of a fake world of (data 1, model 2):
  ``tp/prefill/bf16`` and ``tp/train_step/bf16`` on smollm-360m's smoke
  config -- PRECISION and COLLECTIVES, which keep the row-parallel sums in
  fp32.

``device="cuda"`` runs every real-tensor entry on the card, under CUDA's
sync-debug mode (a synchronisation is a TRANSFER finding unless an
``analysis.allowed`` scope names it).  The fake-tensor entries run on
fake tensors either way.
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.analysis import trace as _trace
from repro_torch.analysis.findings import Report
from repro_torch.analysis.kernel_rules import (check_kernel_budget,
                                               check_kernel_sentinel,
                                               check_kernel_sites,
                                               parse_ptxas)
from repro_torch.analysis.recompile import check_recompile
from repro_torch.analysis.rules import (check_collectives, check_mask,
                                        check_precision, check_shape,
                                        check_transfer, full_width_dims)
from repro_torch.analysis.trace import capture
from repro_torch.launch.dryrun import fake_world

__all__ = ["SWEEP_RULES", "Entry", "sweep_entries", "run_sweep"]

W = 8          # worker count for the aggregation entries
SWEEP_RULES = ("mean", "flag", "pca", "median", "trimmed_mean", "meamed",
               "phocas", "krum", "multi_krum", "bulyan", "geomed")
TP_WORLD = 2   # the TP entries' fake world: mesh (data 1, model 2)


@dataclass(frozen=True)
class Entry:
    name: str
    run: object                       # (device) -> list[Finding]
    cuda_only: bool = False


def _tree(seed: int = 0, device="cpu"):
    """JAX's tree -- 1024 + 512 coordinates, clean powers of two so the
    sharded variants divide 8 ways -- as the worker-major (W, 1536)
    stack and its per-worker layout."""
    from repro_torch.weights import layout_of
    rng = np.random.default_rng(seed)
    a = rng.normal(size=(W, 1024))
    c = rng.normal(size=(W, 256, 2))
    X = torch.as_tensor(np.concatenate([a, c.reshape(W, -1)], axis=1),
                        dtype=torch.float32).to(device)
    layout = layout_of({"a": torch.empty(1024),
                        "b": {"c": torch.empty(256, 2)}})
    return X, layout


def _mask(device="cpu"):
    return torch.tensor([1, 0, 1, 1, 0, 1, 1, 1], dtype=torch.float32,
                        device=device)


def _agg_cfg(name: str, **kw):
    from repro_torch.core.flag import FlagConfig
    from repro_torch.dist.aggregation import AggregatorConfig
    return AggregatorConfig(name=name, f=1,
                            flag=FlagConfig(lam=2.0, m=2, tol=0.0), **kw)


def _graph_rules(trace):
    return check_precision(trace) + check_transfer(trace)


# ---------------------------------------------------------------------------
# entry builders (lazy -- nothing runs until Entry.run is called)
# ---------------------------------------------------------------------------

def _gram_solver_entry():
    def run(device):
        from repro_torch.core.flag import FlagConfig
        from repro_torch.core.gram import fa_weights_from_gram, gram_matrix
        p = 32
        rng = np.random.default_rng(23)
        K = gram_matrix(torch.as_tensor(rng.normal(size=(4 * p, p)),
                                        dtype=torch.float32).to(device))
        trace = capture(fa_weights_from_gram, K, FlagConfig(lam=float(p)),
                        name="fa_weights_from_gram")
        return (check_shape(trace, max_dim=p, require_dims={p})
                + _graph_rules(trace))
    return Entry("gram_solver/rank_p(p=32)", run)


def _aggregate_entries():
    from repro_torch.dist.aggregation import GRAM_RULES, aggregate_tree
    entries = []
    for name in SWEEP_RULES:
        variants = ["plain", "masked"]
        if name in GRAM_RULES or name == "bulyan":
            variants.append("sketch")
        for variant in variants:
            def run(device, name=name, variant=variant):
                X, _ = _tree(device=device)
                cfg = _agg_cfg(name, sketch_stride=4 if variant == "sketch"
                               else 1)
                label = f"aggregate_tree[{name}]"
                if variant == "masked":
                    m = _mask(device)
                    trace = capture(aggregate_tree, X, cfg, mask=m,
                                    name=label, taint=m)
                    return (check_mask(None, m, name=label, trace=trace)
                            + _graph_rules(trace))
                return _graph_rules(capture(aggregate_tree, X, cfg,
                                            name=label))
            entries.append(Entry(f"aggregate_tree/{name}/{variant}", run))
    return entries


def _compressed_entries():
    from repro_torch.comm import CommConfig, init_ef
    from repro_torch.dist.aggregation import compressed_aggregate

    def run_sketch(device):
        X, layout = _tree(1, device)
        comm = CommConfig(codec="countsketch", sketch_ratio=0.25)
        m = _mask(device)
        label = "compressed_aggregate[countsketch]"
        masked = capture(compressed_aggregate, X.clone(), _agg_cfg("flag"),
                         comm, layout=layout, mask=m, name=label, taint=m)
        plain = capture(compressed_aggregate, X.clone(), _agg_cfg("flag"),
                        comm, layout=layout, name=label)
        return (check_mask(None, m, name=label, trace=masked)
                + _graph_rules(plain))

    def run_ef(device):
        X, layout = _tree(2, device)
        ef = init_ef(torch.zeros(layout.numel, device=device), W)
        trace = capture(compressed_aggregate, X, _agg_cfg("mean"),
                        CommConfig(codec="signsgd"), ef, layout=layout,
                        name="compressed_aggregate[signsgd+ef]")
        return _graph_rules(trace)

    return [Entry("compressed_aggregate/countsketch/gram-feed", run_sketch),
            Entry("compressed_aggregate/signsgd/ef", run_ef)]


def _smoke_cfg(dtype: str = "bfloat16", **kw):
    from repro_torch.configs import get_config, reduce_for_smoke
    return reduce_for_smoke(get_config("smollm-360m")).replace(
        frontend=None, num_prefix_embeds=0, compute_dtype=dtype, **kw)


def _serve_entries():
    def run_prefill(device):
        from repro_torch.dist.serve_step import build_prefill_step
        from repro_torch.models import transformer
        cfg = _smoke_cfg()
        params = transformer.init_params(cfg, seed=0, device=device)
        batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32,
                                       device=device)}
        return _graph_rules(capture(build_prefill_step(cfg), params, batch,
                                    name="prefill_step[bf16]"))

    def run_decode(device):
        from repro_torch.dist.serve_step import build_serve_step
        from repro_torch.models import transformer
        cfg = _smoke_cfg()
        params = transformer.init_params(cfg, seed=0, device=device)
        caches = transformer.init_caches(cfg, 2, 32, torch.float32,
                                         device=device)
        tok = torch.zeros((2, 1), dtype=torch.int32, device=device)
        return _graph_rules(capture(build_serve_step(cfg, max_len=32),
                                    params, caches, tok, 0,
                                    name="serve_step[bf16]"))

    return [Entry("serve/prefill/bf16", run_prefill),
            Entry("serve/decode/bf16", run_decode)]


def _train_config(Wt: int = 4):
    from repro_torch.core.flag import FlagConfig
    from repro_torch.dist.aggregation import AggregatorConfig
    from repro_torch.dist.membership import get_fault_schedule
    from repro_torch.dist.train_step import TrainConfig
    tc = TrainConfig(
        aggregator=AggregatorConfig(
            name="flag", flag=FlagConfig(lam=0.0, regularizer="none")),
        faults=get_fault_schedule("churn", Wt, period=2, horizon=16))
    return tc


def _train_entry():
    def run(device):
        from repro_torch.dist.train_step import (build_train_step,
                                                 init_train_state)
        from repro_torch.optim import constant, sgd
        cfg = _smoke_cfg("float32")
        Wt = 4
        tc = _train_config(Wt)
        opt = sgd(momentum=0.9)
        state = init_train_state(cfg, opt, device=device)
        step = build_train_step(cfg, tc, opt, constant(1e-3))
        rng = np.random.default_rng(7)
        batch = {k: torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                                 (Wt, 2, 16)),
                                    dtype=torch.int32).to(device)
                 for k in ("tokens", "labels")}
        return _graph_rules(capture(step, state, batch, 0,
                                    name="train_step[flag+churn]"))
    return Entry("train_step/flag/churn", run)


def _recompile_entries():
    def run_membership(device):
        from repro_torch.dist.train_step import build_train_step
        from repro_torch.optim import constant, sgd
        tc = _train_config()
        step = build_train_step(_smoke_cfg("float32"), tc, sgd(),
                                constant(1e-3))
        return check_recompile(
            lambda t: step.membership(t, 4, device)[1],
            [(t,) for t in range(6)], name="membership_at")

    def run_masked_solver(device):
        from repro_torch.core.flag import FlagConfig
        from repro_torch.core.gram import fa_weights_from_gram, gram_matrix
        rng = np.random.default_rng(3)
        K = gram_matrix(torch.as_tensor(rng.normal(size=(32, W)),
                                        dtype=torch.float32).to(device))
        cfg = FlagConfig(lam=2.0, m=2, tol=0.0)
        masks = [np.ones(W), np.r_[np.zeros(2), np.ones(W - 2)],
                 np.r_[np.ones(W - 3), np.zeros(3)]]
        return check_recompile(
            lambda k, m: fa_weights_from_gram(k, cfg, mask=m),
            [(K, torch.as_tensor(m, dtype=torch.float32).to(device))
             for m in masks], name="fa_weights_from_gram[masked]")

    def run_serve(device):
        from repro_torch.dist.serve_step import build_serve_step
        from repro_torch.models import transformer
        cfg = _smoke_cfg("float32")
        params = transformer.init_params(cfg, seed=0, device=device)
        caches = transformer.init_caches(cfg, 1, 16, torch.float32,
                                         device=device)
        serve = build_serve_step(cfg, max_len=16)
        tok = torch.zeros((1, 1), dtype=torch.int32, device=device)
        return check_recompile(serve, [(params, caches, tok, t)
                                       for t in range(3)],
                               name="serve_step")

    return [Entry("recompile/membership_at", run_membership),
            Entry("recompile/fa_weights_masked", run_masked_solver),
            Entry("recompile/serve_step", run_serve)]


def _kernel_entries():
    """Every kernel's launch on fake CUDA tensors (each custom operator's
    fake implementation), its site count pinned, and the source rules."""

    def sites(fn, *shapes, n_sites, name, dtypes=None):
        args = [torch.empty(s) if isinstance(s, tuple) else s
                for s in shapes]
        if dtypes:
            args = [a.to(d) if d else a for a, d in zip(args, dtypes)]
        trace = capture(fn, *args, name=name, fake=True, fake_device="cuda")
        return check_kernel_sites(trace, expect_sites=n_sites)

    def run_gram(device):
        from repro_torch.kernels.gram.kernel import gram_cuda
        return sites(gram_cuda, (4096, 15), n_sites=1, name="gram")

    def run_tree_gram(device, stride=1):
        from repro_torch.kernels.gram.kernel import tree_gram_cuda
        return sites(lambda x: tree_gram_cuda(x, sketch_stride=stride),
                     (W, 5000), n_sites=1,
                     name=f"tree_gram[stride={stride}]")

    def run_coord(device, op, masked=False):
        from repro_torch.kernels.coord_stats.kernel import coord_stats_cuda
        if masked:
            mask = torch.tensor(np.r_[np.ones(12), np.zeros(3)],
                                dtype=torch.float32)
            return sites(lambda x, m: coord_stats_cuda(x, op, 3, mask=m),
                         (15, 5000), mask, n_sites=1,
                         name=f"coord_stats[{op},masked]")
        return sites(lambda x: coord_stats_cuda(x, op, 3), (15, 5000),
                     n_sites=1, name=f"coord_stats[{op}]")

    def run_krum(device):
        from repro_torch.kernels.coord_stats.kernel import krum_scores_cuda
        return sites(lambda d: krum_scores_cuda(d, 3), (15, 15), n_sites=1,
                     name="krum_scores")

    def run_bulyan(device):
        from repro_torch.kernels.coord_stats.kernel import \
            bulyan_select_cuda
        return sites(lambda d: bulyan_select_cuda(d, 3), (15, 15),
                     n_sites=1, name="bulyan_select")

    def run_flash(device, decode=False):
        from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda
        sq, sk = (1, 512) if decode else (256, 384)
        bf = torch.bfloat16
        return sites(lambda q, k, v: flash_attn_cuda(
            q, k, v, causal=not decode), (2, 2, sq, 64), (2, 2, sk, 64),
            (2, 2, sk, 64), dtypes=(bf, bf, bf), n_sites=1,
            name=f"flash_attn[{'decode' if decode else 'prefill'},bf16]")

    def run_wsum(device):
        from repro_torch.kernels.weighted_sum.kernel import weighted_sum_cuda
        return sites(weighted_sum_cuda, (W, 5000), (W,), n_sites=1,
                     name="weighted_sum")

    def run_act(device, form):
        from repro_torch.kernels.activations import kernel as act_k
        from repro_torch.models import activations
        bf = torch.bfloat16
        fn, n = {
            # the public entries: an eager call under a trace goes
            # through the operator
            "act": (lambda x: activations.gelu(x), 1),
            "act_gated": (lambda u, x: activations.gated("silu", u, x), 2),
            "act_grad": (lambda g, x: act_k.act_grad_op(g, x, None, "silu"),
                         2),
            "act_gated_grad": (lambda g, u, x: act_k.act_gated_grad_op(
                g, u, x, "silu"), 3)}[form]
        return sites(fn, *[(4, 64)] * n, dtypes=(bf,) * n, n_sites=1,
                     name=f"activations[{form},bf16]")

    def run_aggregate(device):
        from repro_torch.dist.aggregation import aggregate_tree
        X, _ = _tree(8, device)
        trace = capture(aggregate_tree, X, _agg_cfg("flag"),
                        name="aggregate_tree[flag,cuda]")
        # the fused tree Gram and one weighted combine over the stack
        return check_kernel_sites(trace, expect_sites=2)

    def run_sentinel(device):
        return check_kernel_sentinel()

    def run_budget(device):
        from repro_torch.kernels import _build
        built = _build.build_all(("gram", "weighted_sum", "coord_stats",
                                  "krum_select", "flash_attn",
                                  "activations"))
        lines = [ln for b in built.values() for ln in b.ptxas]
        return check_kernel_budget(parse_ptxas(lines))

    return [
        Entry("kernels/gram/plain", run_gram),
        Entry("kernels/gram/tree", lambda d: run_tree_gram(d, 1)),
        Entry("kernels/gram/tree_sketch", lambda d: run_tree_gram(d, 4)),
        Entry("kernels/coord_stats/median", lambda d: run_coord(d, "median")),
        Entry("kernels/coord_stats/meamed", lambda d: run_coord(d, "meamed")),
        Entry("kernels/coord_stats/masked",
              lambda d: run_coord(d, "median", masked=True)),
        Entry("kernels/coord_stats/krum", run_krum),
        Entry("kernels/coord_stats/bulyan", run_bulyan),
        Entry("kernels/flash_attn/prefill_bf16", lambda d: run_flash(d)),
        Entry("kernels/flash_attn/decode_bf16",
              lambda d: run_flash(d, True)),
        Entry("kernels/weighted_sum/plain", run_wsum),
        *[Entry(f"kernels/activations/{form}",
                lambda d, form=form: run_act(d, form))
          for form in ("act", "act_gated", "act_grad", "act_gated_grad")],
        # a whole aggregation on fake CUDA tensors needs a CUDA build of
        # PyTorch: on the card it runs on real tensors
        Entry("kernels/aggregate/flag_cuda", run_aggregate, cuda_only=True),
        Entry("kernels/ksentinel", run_sentinel),
        Entry("kernels/kbudget", run_budget, cuda_only=True),
    ]


def _sharded_entries():
    from repro_torch.dist.aggregation import aggregate_tree

    def sharded_call(name, fake_device):
        from repro_torch.dist.sharded import coord_shards, n_coord_shards
        from repro_torch.launch.mesh import make_host_mesh
        X, layout = _tree()
        mesh = make_host_mesh(8)
        shards = coord_shards(layout.sizes, mesh)
        Xs = shards.local(X, 0)
        cfg = _agg_cfg(name)
        trace = capture(lambda x: aggregate_tree(
            x, cfg, sharded=mesh, leaf_sizes=layout.sizes), Xs,
            name=f"aggregate_tree[{name},sharded]", fake=True,
            fake_device=fake_device)
        full = [torch.empty((W, n), device="meta") for n in layout.sizes]
        return trace, full, n_coord_shards(mesh), shards.width

    entries = []
    for name in SWEEP_RULES:
        def run(device, name=name):
            with fake_world(8):
                trace, full, n, width = sharded_call(name, None)
            forbidden, required = full_width_dims(full, n)
            n_flat = sum(t.shape[1] for t in full)
            # the wire story is O(n + W^2) per device: one (W, W) sum for
            # the Gram plus at most one n-sized redistribution of d; a
            # naive W * n gradient exchange busts it (JAX's formula)
            budget = 4.0 * n_flat * 2 + 4.0 * W * W * 64
            return (check_shape(trace, forbidden_dims=forbidden,
                                require_dims=set(required) | {width})
                    + check_collectives(trace, max_bytes_per_device=budget)
                    + _graph_rules(trace))
        entries.append(Entry(f"aggregate_tree/{name}/sharded", run))

    def run_sites(device):
        with fake_world(8):
            trace, *_ = sharded_call("flag", "cuda")
        # the shard-local fused Gram and one weighted combine
        return check_kernel_sites(trace, expect_sites=2)

    entries.append(Entry("kernels/aggregate/sharded_cuda", run_sites,
                         cuda_only=True))
    return entries


def _tp_entries():
    """Rank 0 of a fake world of (data 1, model 2), smollm-360m's smoke
    config at bf16 compute with 3 heads and 1 KV head (each rank's qkv
    block ends mid-head, the path smollm-360m's 15 heads take on 2
    ranks), on fake CPU tensors."""

    @contextmanager
    def world(serving: bool):
        from torch._subclasses.fake_tensor import FakeTensorMode

        from repro_torch.dist.sharding import use_sharding
        from repro_torch.launch.dryrun import rules_for
        from repro_torch.launch.mesh import Mesh
        cfg = _smoke_cfg(num_heads=3, num_kv_heads=1)
        mesh = Mesh((1, TP_WORLD), ("data", "model"))
        with fake_world(TP_WORLD), FakeTensorMode(), use_sharding(
                mesh, rules_for(cfg, mesh, serving=serving)):
            yield cfg, mesh

    def budget(cfg, tokens: int, grads: int = 0) -> float:
        # per layer two fp32 row-parallel sums and the mid-head path's
        # all-gather of q / k / v and split of the attention output, each
        # at most 4 B x tokens x max(d, 3 heads x head_dim); the
        # embedding's sum; the loss's per-token sums; the gradient blocks'
        # exchange (4 B a coordinate, twice)
        width = max(cfg.d_model, 3 * cfg.num_heads * cfg.head_dim)
        per_layer = 8 * 4 * tokens * width
        return (cfg.num_layers * per_layer * (2 if grads else 1)
                + 4 * 4 * tokens * width + 8.0 * grads)

    def run_prefill(device):
        import torch.distributed as dist

        from repro_torch.dist import tensor_parallel
        from repro_torch.dist.serve_step import build_prefill_step
        from repro_torch.dist.sharding import current_rules
        from repro_torch.models import transformer
        with world(serving=True) as (cfg, mesh):
            rank = dist.get_rank()
            lay = transformer.tp_layout(cfg, mesh, current_rules(), rank)
            params = transformer.init_params(cfg, device="cpu", layout=lay)
            tp = tensor_parallel.for_mesh(mesh, rank)
            batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32)}
            trace = capture(build_prefill_step(cfg, tp=tp), params, batch,
                            name="prefill_step[tp,bf16]")
        return (check_precision(trace)
                + check_collectives(trace,
                                    max_bytes_per_device=budget(cfg, 32)))

    def run_train(device):
        from repro_torch.core.flag import FlagConfig
        from repro_torch.dist.aggregation import AggregatorConfig
        from repro_torch.dist.train_step import (TrainConfig,
                                                 build_train_step,
                                                 init_train_state)
        from repro_torch.optim import constant, sgd
        Wt = 2
        with world(serving=False) as (cfg, mesh):
            tc = TrainConfig(aggregator=AggregatorConfig(
                name="flag", f=0, flag=FlagConfig(lam=float(Wt))),
                sharded_agg=True)
            opt = sgd(momentum=0.9)
            state = init_train_state(cfg, opt, device="cpu", sharded=True)
            batch = {k: torch.zeros((Wt, 2, 16), dtype=torch.int32)
                     for k in ("tokens", "labels")}
            step = build_train_step(cfg, tc, opt, constant(1e-3))
            trace = capture(step, state, batch, 0,
                            name="train_step[tp,bf16]")
        n = state.full_layout.numel
        return (check_precision(trace)
                + check_collectives(trace, max_bytes_per_device=budget(
                    cfg, Wt * 32, grads=Wt * n) + 4.0 * Wt * Wt * 64))

    return [Entry("tp/prefill/bf16", run_prefill),
            Entry("tp/train_step/bf16", run_train)]


def sweep_entries(*, sharded: str = "auto",
                  device: str = "cpu") -> list[Entry]:
    """Every lintable entry point.

    ``sharded``: ``'auto'`` includes the fake-world entries (sharded
    aggregation, TP) iff >= 8 CUDA devices are visible, ``'force'``
    includes them unconditionally, ``'skip'`` leaves them out.  Entries
    that need the card's build (KBUDGET) are listed on ``cuda`` only.
    """
    entries = ([_gram_solver_entry()] + _aggregate_entries()
               + _compressed_entries() + _serve_entries() + [_train_entry()]
               + _recompile_entries() + _kernel_entries())
    want = sharded == "force" or (
        sharded == "auto" and torch.cuda.is_available()
        and torch.cuda.device_count() >= 8)
    if want:
        entries += _sharded_entries() + _tp_entries()
    return [e for e in entries if device == "cuda" or not e.cuda_only]


def run_sweep(*, sharded: str = "auto", names=None, device: str = "cpu",
              progress=None) -> Report:
    """Run the sweep; returns a :class:`Report` (``.clean`` gates the CLI)
    whose ``allowed`` maps each entry to the ``analysis.allowed`` sites its
    run passed (``{(rule, reason, site): count}``)."""
    report = Report()
    for entry in sweep_entries(sharded=sharded, device=device):
        if names and not any(s in entry.name for s in names):
            continue
        if progress:
            progress(entry.name)
        prev, _trace._Checks.hits = _trace._Checks.hits, {}
        try:
            report.add(entry.name, entry.run(device))
        finally:
            report.allowed[entry.name] = dict(_trace._Checks.hits)
            _trace._Checks.hits = prev
    return report

