"""Multi-pod dry-run: trace every (arch x shape x mesh) on fake tensors
(port of ``repro/launch/dryrun.py``).

The JAX package lowers and compiles each combination ahead of time on a
512-device host mesh.  The port cannot compile ahead of time; it traces
one step as rank 0 of the production mesh would run it, without
allocating:

  1. a fake world of 256 (single pod) or 512 (multi-pod) ranks in this
     process (``torch.distributed``'s ``fake`` backend: every collective
     returns at once and moves nothing), and the production mesh over it
     (:func:`repro_torch.launch.mesh.make_production_mesh`);
  2. the per-arch rules (:func:`rules_for`: KV-head against head-dim
     cache sharding, expert against expert-MLP parallelism, ...) and
     :func:`variant_for`'s SWA-4096 variant for ``long_500k``;
  3. rank 0's parameters, optimizer state, batch and caches as fake
     tensors (``torch._subclasses.fake_tensor.FakeTensorMode``) of the
     blocks its layout gives it (``dist.sharding.param_layout``,
     ``init_caches`` under the rules); made with ``torch.empty``, since a
     random draw has no fake implementation;
  4. one step of the port's own code on them: train -- the sharded
     tensor-parallel step (``TrainConfig(sharded_agg=True)``) with the
     Flag Aggregator (f = 2, lambda = W), SGD momentum 0.9, a constant
     1e-3 and JAX's micro-batch rule; with ``--zero1`` the momentum cut
     over ``data`` and the step's all-gather of the parameter blocks
     (``TrainConfig(zero1=True)``, ``repro_torch.dist.zero1``);
     prefill -- ``build_prefill_step``;
     decode -- one ``build_serve_step`` against a full-length or ring
     cache;
  5. the trace's counts (:class:`TraceStats`): FLOPs from
     ``torch.utils.flop_counter.FlopCounterMode`` (the matrix products and
     the hand-written kernels' custom operators, each with its formula);
     bytes accessed -- every operator's input and output bytes, a proxy
     for the device traffic, since an eager trace sees no fusion; the
     largest sum of live storages (the peak); and each collective's
     calls and bytes from ``repro_torch.dist.sharded.comm_stats``, the
     counters the real ranks keep;
  6. one JSON per combination under ``--out``, with the JAX harness's
     keys.  An eager trace counts every trip of every loop, so the
     ``_corrected_`` keys equal the counted ones.

``--device cuda`` (the default) traces the card's route: fake CUDA
tensors, every kernel reached through its custom operator's fake
implementation.  It needs a PyTorch built with CUDA; without one it
raises and names ``--device cpu``, which traces the plain routes on fake
CPU tensors: its numbers are the plain routes', not the card's.  Each
combination runs in a child process of its own (the fake process group
becomes the process's default group).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
      --shape all --mesh both --device cpu --out results/dryrun_torch
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
import weakref
from contextlib import contextmanager

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch.models.config import ModelConfig

__all__ = ["rules_for", "variant_for", "microbatch_for", "fake_world",
           "TraceStats", "trace", "tensors_of", "argument_bytes",
           "trace_train", "trace_prefill", "trace_decode", "lower_one",
           "main"]

# the matrix products FlopCounterMode counts (flops_dots_raw_per_device)
DOT_OPS = ("mm", "bmm", "addmm", "baddbmm", "_scaled_mm")


def rules_for(cfg: ModelConfig, mesh, *, serving: bool) -> dict:
    """Per-arch logical->mesh overrides (see ``dist.sharding.
    DEFAULT_RULES``), entry for entry as the JAX package's: heads on
    ``model`` where they divide, else replicated; the KV cache split by
    its KV heads, else by ``head_dim``, else replicated; an MoE
    expert-parallel where the experts divide ``model``, else over
    ``expert_mlp``; serving splits the batch (``sub_batch``) over the data
    axes.  ``mesh`` needs only a ``shape`` dict."""
    model = mesh.shape["model"]
    dp = ("pod", "data") if "pod" in mesh.shape else ("data",)
    rules: dict = {"worker": dp, "batch": dp}
    if serving:
        rules["sub_batch"] = dp          # serve batch = global batch
    rules["heads"] = "model" if cfg.num_heads % model == 0 else None
    if cfg.num_kv_heads % model == 0:
        rules["kv_heads"], rules["head_dim"] = "model", None
    elif cfg.head_dim % model == 0:
        # contraction-sharded KV cache (GQA kv < model axis): head_dim
        rules["kv_heads"], rules["head_dim"] = None, "model"
    else:
        rules["kv_heads"], rules["head_dim"] = None, None
    if cfg.moe is not None:
        if cfg.moe.num_experts % model == 0:
            rules["experts"], rules["expert_mlp"] = "model", None   # EP
        else:
            rules["experts"], rules["expert_mlp"] = None, "model"   # TP
    return rules


def variant_for(cfg: ModelConfig, shape_name: str):
    """long_500k on full-attention archs -> the sliding-window-4096
    variant; -> ``(cfg, tag)``."""
    if shape_name == "long_500k" and cfg.window is None \
            and cfg.arch_type not in ("ssm", "hybrid"):
        return cfg.replace(window=4096), "swa4096"
    return cfg, ""


def microbatch_for(cfg: ModelConfig, global_batch: int, workers: int,
                   microbatch: int = 0) -> int:
    """Gradient-accumulation splits a worker: ``microbatch`` where given,
    else the JAX harness's rule (keep a micro-batch's tokens ~<= 16k at
    4k sequence): a quarter of the per-worker batch for d_model >= 4096,
    else 1, lowered until it divides the per-worker batch."""
    if microbatch:
        return microbatch
    per_worker = global_batch // max(workers, 1)
    microbatch = max(1, per_worker // 4) if cfg.d_model >= 4096 else 1
    while per_worker % microbatch:
        microbatch -= 1
    return microbatch


@contextmanager
def fake_world(size: int, rank: int = 0):
    """A ``torch.distributed`` default group of ``size`` ranks in this
    process, this one ``rank``, on the ``fake`` backend (every collective
    returns at once and moves nothing), destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("fake_world: this process already has a "
                           "default process group")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def tensors_of(*objs) -> list[torch.Tensor]:
    """The tensors in nested dicts / lists / tuples and dataclass objects
    (a ``TrainState``'s fields)."""
    out = []
    stack = list(objs)
    while stack:
        o = stack.pop()
        if isinstance(o, torch.Tensor):
            out.append(o)
        elif isinstance(o, dict):
            stack.extend(o.values())
        elif isinstance(o, (list, tuple)):
            stack.extend(o)
        elif hasattr(o, "__dataclass_fields__"):
            stack.extend(getattr(o, f) for f in o.__dataclass_fields__)
    return out


def argument_bytes(*objs) -> int:
    """Bytes of the storages the tensors of ``objs`` hold, each storage
    once (a step's inputs: its parameters' flat vector, optimizer state,
    batch, caches)."""
    seen = {}
    for t in tensors_of(*objs):
        st = t.untyped_storage()
        seen[id(st)] = (st, st.nbytes())
    return sum(n for _, n in seen.values())


def _nbytes(t) -> int:
    return t.numel() * t.element_size() if isinstance(t, torch.Tensor) \
        else 0


class TraceStats(TorchDispatchMode):
    """Counts of one traced call, kept as its operators run:
    ``bytes_accessed`` -- each operator's input and output bytes (views
    move nothing and are not counted; a proxy for the device traffic:
    an eager trace sees no fusion); ``peak`` -- the largest sum of the
    storages alive at once, the ``resident`` tensors' (the call's
    arguments) from the start, each storage counted from the operator
    that made it until it is freed."""

    def __init__(self, resident=()):
        super().__init__()
        self.bytes_accessed = 0
        self.live = self.peak = 0
        self._sizes: dict = {}
        for t in resident:
            self._track(t)

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._sizes:
            return
        n = st.nbytes()
        self._sizes[key] = n
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key) -> None:
        self.live -= self._sizes.pop(key, 0)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        outs = [t for t in tree_flatten(out)[0]
                if isinstance(t, torch.Tensor)]
        if not func.is_view:
            self.bytes_accessed += sum(
                _nbytes(t) for t in tree_flatten((args, kwargs))[0]) + \
                sum(_nbytes(t) for t in outs)
        for t in outs:
            self._track(t)
        return out


def trace(fn, args=(), writes=()) -> dict:
    """Run ``fn()`` once (on fake tensors: the caller's
    ``FakeTensorMode``) and count it: FLOPs (``FlopCounterMode``: the
    matrix products and the kernels' custom operators), the matrix
    products' alone, bytes accessed and the peak (:class:`TraceStats`),
    the collectives (``dist.sharded.comm_stats``); ``args`` are its
    inputs (their bytes, live from the start), ``writes`` the inputs it
    writes in place, counted as outputs beside what it returns."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.dist.sharded import comm_stats, reset_comm_stats
    arg_bytes = argument_bytes(*args)
    reset_comm_stats()
    with FlopCounterMode(display=False) as fc, \
            TraceStats(tensors_of(*args)) as ts:
        out = fn()
    counts = fc.get_flop_counts().get("Global", {})
    dots = sum(v for op, v in counts.items()
               if getattr(op, "__name__", str(op)).split(".")[-1]
               in DOT_OPS)
    flops = fc.get_total_flops()
    coll = {k: dict(v) for k, v in sorted(comm_stats.items())}
    return {
        "flops_per_device": flops,
        "bytes_accessed_per_device": ts.bytes_accessed,
        "flops_corrected_per_device": flops,
        "hbm_bytes_corrected_per_device": ts.bytes_accessed,
        "flops_dots_raw_per_device": dots,
        "memory": {"argument_bytes": arg_bytes,
                   "output_bytes": argument_bytes(out, *writes),
                   "temp_bytes": ts.peak - arg_bytes,
                   "peak_bytes": ts.peak},
        "collectives": {
            "total_moved_bytes_per_device": sum(v["bytes"]
                                                for v in coll.values()),
            "per_kind_bytes": {k: v["bytes"] for k, v in coll.items()},
            "per_kind_count": {k: v["calls"] for k, v in coll.items()}},
    }


def trace_train(cfg: ModelConfig, tc, opt, sched, batch_shapes: dict, *,
                device) -> dict:
    """One sharded train step of rank 0 under the active mesh and rules:
    the state (``init_train_state(..., sharded=True, zero1=tc.zero1)``:
    the rank's blocks), the worker-major batch of ``batch_shapes`` ({name:
    (shape, dtype)}) and the step, all on fake tensors (the caller's
    ``FakeTensorMode``)."""
    from repro_torch.dist.train_step import build_train_step, \
        init_train_state
    state = init_train_state(cfg, opt, device=device, comm=tc.comm,
                             workers=batch_shapes["tokens"][0][0],
                             sharded=True, zero1=tc.zero1)
    batch = {k: torch.empty(sh, dtype=dt, device=device)
             for k, (sh, dt) in batch_shapes.items()}
    step = build_train_step(cfg, tc, opt, sched)
    return trace(lambda: step(state, batch, 0), (state, batch), (state,))


def _tp_and_params(cfg: ModelConfig, device):
    """Rank 0's serving group and parameter blocks under the active mesh
    and rules (whole parameters and no group where nothing splits)."""
    import torch.distributed as dist

    from repro_torch.dist import tensor_parallel
    from repro_torch.dist.sharding import current_mesh, current_rules
    from repro_torch.models import transformer
    mesh, rank = current_mesh(), dist.get_rank()
    lay = transformer.tp_layout(cfg, mesh, current_rules(), rank)
    if not lay.is_split:
        return None, transformer.init_params(cfg, device=device)
    return (tensor_parallel.for_mesh(mesh, rank),
            transformer.init_params(cfg, device=device, layout=lay))


def trace_prefill(cfg: ModelConfig, batch_shapes: dict, *, device) -> dict:
    """One prefill of rank 0's rows (``sub_batch``) of the request batch
    ``batch_shapes`` ({name: (whole shape, dtype)}) under the active mesh
    and rules, on fake tensors."""
    from repro_torch.dist.serve_step import build_prefill_step
    from repro_torch.dist.sharding import local_shape
    tp, params = _tp_and_params(cfg, device)
    batch = {k: torch.empty(local_shape(sh, ("sub_batch",) + (None,) * (
        len(sh) - 1)), dtype=dt, device=device)
        for k, (sh, dt) in batch_shapes.items()}
    step = build_prefill_step(cfg, tp=tp)
    return trace(lambda: step(params, batch), (params, batch))


def trace_decode(cfg: ModelConfig, batch: int, max_len: int, step: int, *,
                 device, cache_dtype=torch.bfloat16) -> dict:
    """One serve step of rank 0 (its rows, its blocks of the caches) at
    position ``step`` against ``max_len`` caches (a ring buffer where the
    window is shorter) under the active mesh and rules, on fake
    tensors."""
    from repro_torch.dist.serve_step import build_serve_step
    from repro_torch.dist.sharding import local_shape
    from repro_torch.models import transformer
    tp, params = _tp_and_params(cfg, device)
    caches = transformer.init_caches(cfg, batch, max_len, cache_dtype,
                                     device=device)
    tokens = torch.empty(local_shape((batch, 1), ("sub_batch", None)),
                         dtype=torch.int32, device=device)
    serve = build_serve_step(cfg, max_len=max_len, tp=tp)
    return trace(lambda: serve(params, caches, tokens, step),
                 (params, caches, tokens), (caches,))


def _check_device(device: str) -> None:
    if device == "cuda" and not torch.backends.cuda.is_built():
        raise ValueError("dryrun --device cuda traces the card's route on "
                         "fake CUDA tensors, which needs a PyTorch built "
                         "with CUDA; this one has none: run with --device "
                         "cpu (the plain routes)")
    if device not in ("cuda", "cpu"):
        raise ValueError(f"dryrun: --device cuda or cpu, got {device!r}")


def lower_one(arch: str, shape_name: str, *, multi_pod: bool,
              scan_layers: bool = True, agg: str = "flag",
              sketch_stride: int = 1, zero1: bool = False,
              gram_dtype: str = "float32", microbatch: int = 0,
              extra_rules: dict | None = None,
              device: str = "cuda") -> dict:
    """Trace one combination in this process (its fake world made and
    destroyed here); -> the result dict.  ``scan_layers`` is recorded as
    JAX's: the port's stack is a Python loop over the periods either
    way."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.configs import get_config
    from repro_torch.configs.shapes import SHAPES, input_specs
    from repro_torch.core.flag import FlagConfig
    from repro_torch.dist.aggregation import AggregatorConfig
    from repro_torch.dist.sharding import use_sharding
    from repro_torch.dist.train_step import TrainConfig
    from repro_torch.launch.mesh import make_production_mesh, worker_count
    from repro_torch.optim import constant, sgd
    _check_device(device)
    t0 = time.time()
    shape = SHAPES[shape_name]
    cfg, variant = variant_for(get_config(arch), shape_name)
    serving = shape.kind != "train"
    result = {"arch": arch, "shape": shape_name,
              "mesh": "pod2x16x16" if multi_pod else "16x16",
              "variant": variant, "kind": shape.kind,
              "scan_layers": scan_layers,
              "aggregator": agg if not serving else "",
              "sketch_stride": sketch_stride, "zero1": zero1,
              "device": device}
    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        W = worker_count(mesh)
        result["workers"] = W
        rules = rules_for(cfg, mesh, serving=serving)
        if extra_rules:
            rules.update(extra_rules)
        with FakeTensorMode(), use_sharding(mesh, rules):
            if shape.kind == "train":
                mb = microbatch_for(cfg, shape.global_batch, W, microbatch)
                result["microbatch_splits"] = mb
                tc = TrainConfig(
                    aggregator=AggregatorConfig(
                        name=agg, f=2, flag=FlagConfig(lam=float(W)),
                        sketch_stride=sketch_stride, gram_dtype=gram_dtype),
                    attack="none", microbatch_splits=mb, sharded_agg=True,
                    zero1=zero1)
                specs = input_specs(cfg, shape, workers=W)
                stats = trace_train(
                    cfg, tc, sgd(momentum=0.9), constant(1e-3),
                    {k: (tuple(v.shape), v.dtype) for k, v in specs.items()},
                    device=device)
            elif shape.kind == "prefill":
                specs = input_specs(cfg, shape)
                stats = trace_prefill(
                    cfg, {k: (tuple(v.shape), v.dtype)
                          for k, v in specs.items()}, device=device)
            else:
                stats = trace_decode(cfg, shape.global_batch, shape.seq_len,
                                     shape.seq_len - 1, device=device)
    result.update(ok=True, elapsed_s=round(time.time() - t0, 1), **stats,
                  param_count=cfg.param_count(),
                  active_param_count=cfg.active_param_count())
    return result


def _child(kw: dict) -> dict:
    """One combination in a child process: the result, or the failure."""
    torch.set_num_threads(1)
    try:
        return lower_one(**kw)
    except Exception as e:      # reported in the JSON and as [FAIL]
        return {"arch": kw["arch"], "shape": kw["shape_name"],
                "mesh": "multi" if kw["multi_pod"] else "single",
                "ok": False, "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-3000:]}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="all",
                    help="arch id or 'all' (comma-separated ok)")
    ap.add_argument("--shape", default="all",
                    help="shape name or 'all' (comma-separated ok)")
    ap.add_argument("--mesh", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--unroll", action="store_true",
                    help="recorded as JAX's flag; the port's stack is a "
                         "Python loop over the periods either way")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="grad-accumulation splits per worker (0 = auto)")
    ap.add_argument("--agg", default="flag")
    ap.add_argument("--sketch-stride", type=int, default=1)
    ap.add_argument("--zero1", action="store_true",
                    help="cut the SGD momentum over the data axis and "
                         "all-gather the updated parameter blocks (ZeRO-1)")
    ap.add_argument("--gram-dtype", default="float32")
    ap.add_argument("--tag", default="")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card's route on fake CUDA tensors "
                         "(needs a PyTorch built with CUDA); cpu: the "
                         "plain routes on fake CPU tensors")
    ap.add_argument("--jobs", type=int, default=1,
                    help="combinations traced at once, one child process "
                         "each")
    return ap


def main(argv=None) -> int:
    import multiprocessing as mp

    from repro_torch.configs import ARCHS
    from repro_torch.configs.shapes import SHAPES
    args = _parser().parse_args(argv)
    _check_device(args.device)
    archs = sorted(ARCHS) if args.arch == "all" else args.arch.split(",")
    shapes = list(SHAPES) if args.shape == "all" else args.shape.split(",")
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    os.makedirs(args.out, exist_ok=True)
    todo = []
    for arch in archs:
        for shape_name in shapes:
            for multi_pod in meshes:
                name = f"{arch}_{shape_name}_{'multi' if multi_pod else 'single'}"
                if args.tag:
                    name += f"_{args.tag}"
                out_path = os.path.join(args.out, name + ".json")
                if os.path.exists(out_path):
                    print(f"[skip] {name} (exists)")
                    continue
                todo.append((name, out_path, dict(
                    arch=arch, shape_name=shape_name, multi_pod=multi_pod,
                    scan_layers=not args.unroll, agg=args.agg,
                    sketch_stride=args.sketch_stride, zero1=args.zero1,
                    gram_dtype=args.gram_dtype, microbatch=args.microbatch,
                    device=args.device)))
    failures = []
    ctx = mp.get_context("spawn")
    with ctx.Pool(max(1, args.jobs), maxtasksperchild=1) as pool:
        pending = []
        for name, out_path, kw in todo:
            print(f"[lower] {name} ...", flush=True)
            pending.append((name, out_path, pool.apply_async(_child, (kw,))))
        for name, out_path, job in pending:
            res = job.get()
            if res["ok"]:
                print(f"[ok]    {name}: "
                      f"flops/dev={res['flops_per_device']:.3e} "
                      f"coll/dev={res['collectives']['total_moved_bytes_per_device'] / 1e6:.1f}MB "
                      f"peak={res['memory']['peak_bytes'] / 1e9:.2f}GB "
                      f"({res['elapsed_s']}s)", flush=True)
            else:
                failures.append(name)
                print(f"[FAIL]  {name}: {res['error'][:300]}", flush=True)
            with open(out_path, "w") as f:
                json.dump(res, f, indent=1, default=float)
    print(f"\ndone. {len(failures)} failures: {failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
