"""Port parity: ``repro_torch.launch.dryrun`` -- the per-arch rules, the
caches' layout a rank, traces on fake tensors against real ranks, the
kernels' custom operators under a trace, and the CLI on the production
mesh.

* ``rules_for`` / ``variant_for`` equal JAX's for all ten archs x {single
  pod, multi-pod} x {serving, train}.  JAX's are called in a subprocess
  through a duck-typed mesh (a ``.shape`` dict): importing
  ``repro.launch.dryrun`` sets ``XLA_FLAGS`` to 512 host devices for the
  whole process.
* Each annotated cache leaf's bytes a rank (the attention K / V cache,
  the mLSTM's C and n) equal those of JAX's ``logical_spec`` of the
  shapes and axes JAX's ``init_caches`` annotates under ``jax.eval_shape``,
  at model 2, 4 and 16 (decode_32k's batch and length).
* A ``--device cpu`` trace of a smoke tensor-parallel train step,
  prefill and decode in a fake world of 4 ranks (mesh (2, 2); 3 heads on
  2 ranks: the mid-head path and a cache split by ``head_dim``): its
  collectives (calls and bytes a kind) and argument bytes equal rank 0's
  of a real gloo world of 4 on the same configuration exactly.
* The flash operator's FLOP formula against a brute-force count of
  ``ref.attention_mask``'s pairs (and smollm-360m's prefill layer, the
  count behind the kernel's bound), and every custom operator's fake
  output (shape, dtype) against its plain version's on a small sweep:
  fake CUDA tensors in a subprocess.
* One CLI run a shape kind (train_4k, prefill_32k, decode_32k) for
  smollm-360m on the single-pod mesh, its JSON keys those of the JAX
  harness; ``--zero1`` and ``--device cuda`` without CUDA raise.

Every trace runs in a subprocess: the fake process group becomes the
process's default group, and a fake CUDA backward aborts a CPU-only
process.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config, reduce_for_smoke
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch.dryrun import lower_one, rules_for, variant_for
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.ranks import spawn

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src"),
       "JAX_PLATFORMS": "cpu"}
MESHES = {"single": {"data": 16, "model": 16},
          "multi": {"pod": 2, "data": 16, "model": 16}}
# the fake-against-real configuration: smollm's smoke config with 3 heads
# and 1 KV head on the mesh (2, 2)
W, BW, SW = 4, 2, 16
SERVE_B, SERVE_S, MAX_LEN, STEP = 4, 8, 16, 5
SMOKE_KW = {"num_heads": 3, "num_kv_heads": 1}
KEYS = ("flops_per_device", "bytes_accessed_per_device",
        "flops_corrected_per_device", "hbm_bytes_corrected_per_device",
        "flops_dots_raw_per_device", "memory", "collectives",
        "param_count", "active_param_count", "device")


def _smoke():
    return reduce_for_smoke(get_config("smollm-360m")).replace(**SMOKE_KW)


def _python(code: str) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-c", textwrap.dedent(code)],
                            env=ENV, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


def _result(proc: subprocess.Popen, timeout: float = 300):
    out, err = proc.communicate(timeout=timeout)
    assert proc.returncode == 0, err[-3000:]
    return json.loads(out.strip().splitlines()[-1])


JAX_RULES = """
    import json
    from repro.configs import ARCHS, get_config
    from repro.launch.dryrun import rules_for, variant_for

    class M:
        def __init__(self, shape):
            self.shape = shape
    meshes = %r
    out = {}
    for arch in sorted(ARCHS):
        cfg = get_config(arch)
        for m, shape in meshes.items():
            for serving in (True, False):
                out[f"{arch}|{m}|{serving}"] = {
                    k: list(v) if isinstance(v, tuple) else v
                    for k, v in rules_for(cfg, M(shape),
                                          serving=serving).items()}
        for s in %r:
            v, tag = variant_for(cfg, s)
            out[f"{arch}|{s}"] = [v.window, tag]
    print(json.dumps(out))
"""

FAKE_TRACES = """
    import json
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.core.flag import FlagConfig
    from repro_torch.dist.aggregation import AggregatorConfig
    from repro_torch.dist.sharding import use_sharding
    from repro_torch.dist.train_step import TrainConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.optim import constant, sgd
    cfg = reduce_for_smoke(get_config("smollm-360m")).replace(**%r)
    W, BW, SW, B, S, L, STEP = %r
    mesh = Mesh((2, 2), ("data", "model"))
    out = {}
    with dryrun.fake_world(4), FakeTensorMode():
        with use_sharding(mesh, dryrun.rules_for(cfg, mesh, serving=False)):
            tc = TrainConfig(aggregator=AggregatorConfig(
                name="flag", f=1, flag=FlagConfig(lam=float(W))),
                sharded_agg=True)
            out["train"] = dryrun.trace_train(
                cfg, tc, sgd(momentum=0.9), constant(1e-3),
                {"tokens": ((W, BW, SW), torch.int32),
                 "labels": ((W, BW, SW), torch.int32)}, device="cpu")
        with use_sharding(mesh, dryrun.rules_for(cfg, mesh, serving=True)):
            out["prefill"] = dryrun.trace_prefill(
                cfg, {"tokens": ((B, S), torch.int32)}, device="cpu")
            out["decode"] = dryrun.trace_decode(cfg, B, L, STEP,
                                                device="cpu")
    print(json.dumps(out))
"""

OP_CHECKS = """
    import json
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.coord_stats import ops as cs
    from repro_torch.kernels.coord_stats.kernel import (
        bulyan_select_cuda, coord_stats_cuda, krum_scores_cuda)
    from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda
    from repro_torch.kernels.flash_attn.ref import (attention_mask,
                                                    flash_attn_plain)
    from repro_torch.kernels.gram import ops as gr
    from repro_torch.kernels.gram.kernel import gram_cuda, tree_gram_cuda
    from repro_torch.kernels.weighted_sum import ops as ws
    from repro_torch.kernels.weighted_sum.kernel import weighted_sum_cuda

    def meta(t):
        return [list(t.shape), str(t.dtype)]
    out = {"flash": [], "ops": []}
    bands = [(16, 16, True, None), (16, 16, True, 5), (8, 24, True, None),
             (8, 24, True, 3), (12, 12, False, None), (12, 12, False, 4),
             (1, 40, True, 16), (2048, 2048, True, None)]
    for sq, sk, causal, window in bands:
        brute = int(attention_mask(sq, sk, causal=causal,
                                   window=window).sum())
        for b, H, KV, d, dt in ((2, 4, 2, 64, torch.bfloat16),
                                (1, 3, 3, 128, torch.float32)):
            with FakeTensorMode():
                q = torch.empty(b, H, sq, d, dtype=dt, device="cuda")
                k = torch.empty(b, KV, sk, d, dtype=dt, device="cuda")
                with FlopCounterMode(display=False) as fc:
                    o = flash_attn_cuda(q, k, k, causal=causal,
                                        window=window)
                got = [fc.get_total_flops(), meta(o)]
            want = [4 * d * b * H * brute, meta(flash_attn_plain(
                torch.zeros(b, H, sq, d, dtype=dt),
                torch.zeros(b, KV, sk, d, dtype=dt),
                torch.zeros(b, KV, sk, d, dtype=dt), causal=causal,
                window=window))]
            out["flash"].append([got, want])
    with FakeTensorMode():
        q = torch.empty(4, 15, 2048, 64, dtype=torch.bfloat16,
                        device="cuda")
        k = torch.empty(4, 5, 2048, 64, dtype=torch.bfloat16, device="cuda")
        with FlopCounterMode(display=False) as fc:
            flash_attn_cuda(q, k, k, causal=True)
        out["smollm_layer"] = fc.get_total_flops()

    def pair(fake_fn, plain_fn, *shapes):
        real = [torch.rand(*sh) if isinstance(sh, tuple) else sh
                for sh in shapes]
        with FakeTensorMode():
            fk = [torch.empty(*sh, device="cuda") if isinstance(sh, tuple)
                  else sh for sh in shapes]
            got = meta(fake_fn(*fk))
        out["ops"].append([got, meta(plain_fn(*real))])
    for Wn, N in ((3, 50), (15, 2000), (33, 700)):
        pair(lambda X: tree_gram_cuda(X), lambda X: gr.tree_gram_fused(X),
             (Wn, N))
        pair(lambda X: tree_gram_cuda(X, sketch_stride=2, block_n=64),
             lambda X: gr.tree_gram_fused(X, sketch_stride=2, block_n=64),
             (Wn, N))
        pair(lambda G: gram_cuda(G), lambda G: gr.gram(G), (N, Wn))
        pair(lambda X, c: weighted_sum_cuda(X, c),
             lambda X, c: ws.weighted_sum(X, c), (Wn, N), (Wn,))
        for op in ("median", "trimmed_mean", "meamed", "phocas"):
            pair(lambda X, op=op: coord_stats_cuda(X, op, 1),
                 lambda X, op=op: cs.coord_stat(X, op, 1), (Wn, N))
        D2 = (Wn, Wn)
        pair(lambda D: krum_scores_cuda(D, 1),
             lambda D: cs.krum_scores(D, 1), D2)
        pair(lambda D: bulyan_select_cuda(D, 1),
             lambda D: cs.bulyan_select(D, 1), D2)
    print(json.dumps(out))
"""


def _real_rank(rank):
    """Rank ``rank`` of a gloo world of 4: the smoke configuration's train
    step, prefill and decode on real tensors, each with its collectives
    and argument bytes (rank 0's are compared)."""
    from repro_torch.core.flag import FlagConfig
    from repro_torch.dist.aggregation import AggregatorConfig
    from repro_torch.dist.serve_step import (build_prefill_step,
                                             build_serve_step)
    from repro_torch.dist.sharded import comm_stats, reset_comm_stats
    from repro_torch.dist.sharding import local_shape, use_sharding
    from repro_torch.dist.train_step import (TrainConfig, build_train_step,
                                             init_train_state)
    from repro_torch.launch import dryrun
    from repro_torch.models import transformer
    from repro_torch.optim import constant, sgd
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    cfg, mesh = _smoke(), Mesh((2, 2), ("data", "model"))
    gen = torch.Generator().manual_seed(3)
    out = {}

    def record(name, fn, *args):
        reset_comm_stats()
        fn()
        out[name] = {"argument_bytes": dryrun.argument_bytes(*args),
                     "comm": {k: dict(v) for k, v in comm_stats.items()}}
    try:
        with use_sharding(mesh, rules_for(cfg, mesh, serving=False)):
            opt = sgd(momentum=0.9)
            tc = TrainConfig(aggregator=AggregatorConfig(
                name="flag", f=1, flag=FlagConfig(lam=float(W))),
                sharded_agg=True)
            state = init_train_state(cfg, opt, sharded=True)
            batch = {k: torch.randint(0, cfg.vocab_size, (W, BW, SW),
                                      generator=gen, dtype=torch.int32)
                     for k in ("tokens", "labels")}
            step = build_train_step(cfg, tc, opt, constant(1e-3))
            record("train", lambda: step(state, batch, 0), state, batch)
        with use_sharding(mesh, rules_for(cfg, mesh, serving=True)):
            tp, params = dryrun._tp_and_params(cfg, "cpu")
            rows = local_shape((SERVE_B, SERVE_S), ("sub_batch", None))
            toks = {"tokens": torch.randint(0, cfg.vocab_size, rows,
                                            generator=gen,
                                            dtype=torch.int32)}
            prefill = build_prefill_step(cfg, tp=tp)
            record("prefill", lambda: prefill(params, toks), params, toks)
            caches = transformer.init_caches(cfg, SERVE_B, MAX_LEN)
            tok = toks["tokens"][:, :1].clone()
            serve = build_serve_step(cfg, max_len=MAX_LEN, tp=tp)
            record("decode", lambda: serve(params, caches, tok, STEP),
                   params, caches, tok)
    finally:
        dist.destroy_process_group()
    return out


@pytest.fixture(scope="module")
def procs():
    """The module's subprocesses, started together."""
    shapes = list(SHAPES)
    return {
        "rules": _python(JAX_RULES % (MESHES, shapes)),
        "fake": _python(FAKE_TRACES % (SMOKE_KW, (W, BW, SW, SERVE_B,
                                                  SERVE_S, MAX_LEN, STEP))),
        "ops": _python(OP_CHECKS),
    }


@pytest.fixture(scope="module")
def cli(tmp_path_factory, procs):
    out = tmp_path_factory.mktemp("dryrun")
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "smollm-360m", "--shape", "train_4k,prefill_32k,decode_32k",
         "--mesh", "single", "--device", "cpu", "--out", str(out),
         "--jobs", "3"], env=ENV, cwd=ROOT, capture_output=True, text=True,
        timeout=600)
    return proc, out


@pytest.fixture(scope="module")
def real(procs):
    return spawn(_real_rank, 4, timeout=300)[0]


@pytest.fixture(scope="module")
def jax_rules(procs):
    return _result(procs["rules"])


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_rules_and_variants_equal_jax(arch, jax_rules):
    want = jax_rules
    cfg = get_config(arch)
    for m, shape in MESHES.items():
        mesh = Mesh(tuple(shape.values()), tuple(shape))
        for serving in (True, False):
            got = {k: list(v) if isinstance(v, tuple) else v
                   for k, v in rules_for(cfg, mesh, serving=serving).items()}
            assert got == want[f"{arch}|{m}|{serving}"], (m, serving)
    for s in SHAPES:
        v, tag = variant_for(cfg, s)
        assert [v.window, tag] == want[f"{arch}|{s}"]


def _jax_block_annotations(jcfg, kind, batch, max_len):
    """(shape, axes, leaves) of every ``shard`` call of JAX's
    ``block_cache_init`` for ``kind`` (under ``jax.eval_shape``): the
    attention cache's one call gives both K and V."""
    import jax
    import jax.numpy as jnp
    from repro.models import attention as jattn, ssm as jssm
    from repro.models import transformer as jt
    seen = []

    def record(x, axes):
        seen.append((tuple(x.shape), tuple(axes), 2 if kind == "attn"
                     else 1))
        return x
    saved = jattn.shard, jssm.shard
    jattn.shard = jssm.shard = record
    try:
        jax.eval_shape(lambda: jt.block_cache_init(jcfg, kind, batch,
                                                   max_len, jnp.bfloat16))
    finally:
        jattn.shard, jssm.shard = saved
    return seen


def _annotated(kind, cache):
    """The port's leaves that carry JAX's annotations: the attention
    cache's K and V, the mLSTM's C and n."""
    if kind == "attn":
        return [cache["k"], cache["v"]]
    if kind == "mlstm":
        return list(cache[0][:2])
    return []


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_bytes_a_rank_equal_jax_logical_spec(arch):
    from jax.sharding import AbstractMesh
    from repro.configs import get_config as jget
    from repro.dist.sharding import (current_rules, logical_spec as jspec,
                                     use_sharding as juse)

    from repro_torch.dist.sharding import use_sharding
    from repro_torch.models import transformer
    shape = SHAPES["decode_32k"]
    cfg, jcfg = get_config(arch), jget(arch)
    B, L = shape.global_batch, shape.seq_len
    kinds = sorted(set(cfg.layer_kinds()) & {"attn", "mlstm"})
    seen = {k: _jax_block_annotations(jcfg, k, B, L) for k in kinds}
    for model in (2, 4, 16):
        mesh = Mesh((16, model), ("data", "model"))
        jm = AbstractMesh((16, model), ("data", "model"))
        rules = rules_for(cfg, mesh, serving=True)
        with juse(jm, rules):
            jrules = dict(current_rules())
        for kind in kinds:
            want = []
            for sh, axes, leaves in seen[kind]:
                spec = jspec(sh, axes, jm, jrules)
                parts = [int(np.prod([jm.shape[a] for a in (
                    (e,) if isinstance(e, str) else e)])) if e else 1
                    for e in spec]
                size = 2 if kind == "attn" else 4     # bf16 K / V, fp32
                want += [int(np.prod([d // p for d, p in zip(sh, parts)]))
                         * size] * leaves
            with use_sharding(mesh, rules):
                cache = transformer.block_cache_init(
                    cfg, kind, B, L, torch.bfloat16, device="meta")
            got = [t.numel() * t.element_size()
                   for t in _annotated(kind, cache)]
            assert sorted(got) == sorted(want), (model, kind, got, want)


def test_fake_traces_equal_real_world_counts(procs, real):
    fake = _result(procs["fake"])
    for kind in ("train", "prefill", "decode"):
        f, r = fake[kind], real[kind]
        assert f["memory"]["argument_bytes"] == r["argument_bytes"], kind
        coll = f["collectives"]
        assert coll["per_kind_bytes"] == {k: v["bytes"]
                                          for k, v in r["comm"].items()}
        assert coll["per_kind_count"] == {k: v["calls"]
                                          for k, v in r["comm"].items()}
        assert f["memory"]["peak_bytes"] >= f["memory"]["argument_bytes"]
        assert f["flops_per_device"] >= f["flops_dots_raw_per_device"] > 0
    assert {"tp_cache_scores", "tp_cache_out", "tp_argmax"} <= set(
        fake["decode"]["collectives"]["per_kind_count"])
    assert {"tp_exchange", "tp_return", "tp_gather", "tp_split"} <= set(
        fake["train"]["collectives"]["per_kind_count"])


def test_flash_flop_formula_is_the_band_count(procs):
    res = _result(procs["ops"])
    for got, want in res["flash"]:
        assert got == want
    assert res["smollm_layer"] == 4 * 4 * 15 * 64 * 2_098_176 \
        == 32_227_983_360


def test_custom_operators_fake_outputs_match_plain(procs):
    res = _result(procs["ops"])
    assert len(res["ops"]) == 3 * 10
    for got, want in res["ops"]:
        assert got == want


def test_cli_traces_each_shape_kind_on_the_production_mesh(cli):
    proc, out = cli
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    assert proc.stdout.count("[ok]") == 3 and "0 failures" in proc.stdout
    kinds = set()
    for shape in ("train_4k", "prefill_32k", "decode_32k"):
        res = json.loads((out / f"smollm-360m_{shape}_single.json")
                         .read_text())
        assert res["ok"] and res["mesh"] == "16x16" and res["device"] == "cpu"
        assert all(k in res for k in KEYS)
        assert res["flops_per_device"] > 0
        assert res["collectives"]["total_moved_bytes_per_device"] > 0
        assert res["memory"]["peak_bytes"] > res["memory"]["argument_bytes"]
        kinds.add(res["kind"])
    assert kinds == {"train", "prefill", "decode"}


def test_zero1_and_missing_cuda_raise():
    with pytest.raises(ValueError, match="ROADMAP"):
        lower_one("smollm-360m", "train_4k", multi_pod=False, zero1=True,
                  device="cpu")
    if not torch.backends.cuda.is_built():
        with pytest.raises(ValueError, match="--device cpu"):
            lower_one("smollm-360m", "decode_32k", multi_pod=False,
                      device="cuda")
