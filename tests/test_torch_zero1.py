"""Port parity: the optimizer step sharded over the mesh's ``data`` axis
(ZeRO-1, ``TrainConfig(zero1=True)``, ``repro_torch.dist.zero1``).

* **The cut is JAX's ``zshard``.**  JAX's dry run cuts the SGD momentum's
  sharding at the first dimension its parameter sharding leaves unsplit
  and whose whole size the ``data`` axis divides
  (``src/repro/launch/dryrun.py:153-163``; restated as :func:`_zshard`).
  Applied to the port's tensor-parallel layout (held equal to JAX's
  ``logical_spec`` of JAX's annotations by ``tests/
  test_torch_tensor_parallel.py::
  test_layout_is_jax_logical_spec_of_jax_annotations``), each leaf's
  moment block a rank holds has the bytes that rule gives, for all ten
  configurations on the single-pod (16, 16) and multi-pod (2, 16, 16)
  production meshes (where xlstm-1.3b's mLSTM ``wif`` and ``wq`` / ``wk``
  / ``wv`` stay whole) and on the
  host meshes (2, 1) and (2, 2) of the worlds below.
* **The step.**  Gloo worlds of 2 CPU ranks (mesh (data 2, model 1)) and
  of 4 (mesh (2, 2): tensor parallelism over ``model`` too), reduced
  smollm-360m (dense) and deepseek-moe-16b (MoE), SGD momentum 0.9 and
  AdamW, W = 4, 3 steps: after every step the parameters equal those of
  the same world's run without ZeRO-1 bit for bit, the rank's moment
  blocks are the same bits as its blocks of that run's moments, and its
  moment bytes are the rule's; one ``zero1_all_gather`` a cut leaf a
  step, of the rank's parameter blocks.
* **Checkpoints.**  Both runs save after step 3: every entry of the two
  files is the same bytes (the zip's own timestamps aside).  Both save
  after step 2, and each file resumes into the other kind of state: its
  third step equals the uninterrupted run's, bit for bit.
* ``zero1=True`` without ``sharded_agg`` raises, and so does a state
  whose moments are cut otherwise than the step asks.
"""

from __future__ import annotations

import os
import zipfile

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import ARCHS, get_config, reduce_for_smoke
from repro_torch.core.flag import FlagConfig
from repro_torch.dist.aggregation import AggregatorConfig
from repro_torch.dist.sharding import resolve_rules, use_sharding
from repro_torch.dist.train_step import (TrainConfig, build_train_step,
                                         init_train_state)
from repro_torch.dist.zero1 import zero1_layout
from repro_torch.launch.mesh import Mesh
from repro_torch.launch.ranks import spawn
from repro_torch.models import transformer
from repro_torch.optim import adamw, constant, sgd

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

WORLDS = {"2x1": Mesh((2, 1), ("data", "model")),
          "2x2": Mesh((2, 2), ("data", "model"))}
PRODUCTION = {"single": Mesh((16, 16), ("data", "model")),
              "multi": Mesh((2, 16, 16), ("pod", "data", "model"))}
STEP_ARCHS = ("smollm-360m", "deepseek-moe-16b")
OPTS = ("sgd", "adamw")
W, STEPS = 4, 3
SPAWN_TIMEOUT = 400


def _cfg(arch):
    return reduce_for_smoke(get_config(arch)).replace(frontend=None,
                                                      num_prefix_embeds=0)


def _opt(name):
    return sgd(momentum=0.9) if name == "sgd" else adamw()


def _zshard(shape, spec, data):
    """``src/repro/launch/dryrun.py:153-163``: the first dimension whose
    entry is ``None`` and whose size ``data`` divides gets ``"data"``."""
    pspec = list(spec) + [None] * (len(shape) - len(spec))
    for i, (dim, cur) in enumerate(zip(shape, pspec)):
        if cur is None and dim % data == 0:
            pspec[i] = "data"
            break
    return pspec


def _rule_bytes(tp, mesh) -> list[int]:
    """Each leaf's fp32 moment bytes a rank holds under the rule, from the
    tensor-parallel layout ``tp`` (its whole leaves and split dims)."""
    out = []
    for shape, d in zip(tp.full.shapes, tp.dims):
        spec = ["model" if j == d else None for j in range(len(shape))]
        parts = {None: 1, "model": mesh.shape["model"],
                 "data": mesh.shape["data"]}
        n = 1
        for dim, e in zip(shape, _zshard(shape, spec, mesh.shape["data"])):
            n *= dim // parts[e]
        out.append(4 * n)
    return out


def _port_bytes(cfg, mesh, rank=0) -> tuple:
    """(each leaf's fp32 moment bytes on ``rank``, its tensor-parallel
    layout, its ZeRO-1 layout)."""
    tp = transformer.tp_layout(cfg, mesh, resolve_rules(mesh), rank)
    z = zero1_layout(tp.local, tp.dims, mesh, rank)
    return [4 * n for n in z.local.sizes], tp, z


@pytest.mark.parametrize("mesh", sorted(PRODUCTION) + sorted(WORLDS))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_moment_blocks_follow_jax_zshard(arch, mesh):
    m = {**PRODUCTION, **WORLDS}[mesh]
    cfg = get_config(arch) if mesh in PRODUCTION else _cfg(arch)
    got, tp, z = _port_bytes(cfg, m)
    assert got == _rule_bytes(tp, m)
    # a later rank holds blocks of the same bytes
    assert _port_bytes(cfg, m, m.size - 1)[0] == got


def test_leaves_stay_whole_on_the_production_mesh():
    """xlstm-1.3b's mLSTM ``wif`` (6, 4096, 8) and block-diagonal ``wq``
    / ``wk`` / ``wv`` (6, 1024, 4, 4), stacked over the 6 periods:
    ``state`` splits the second dimension over model 16, and data 16
    divides none of 6, 8 and 4."""
    for mesh in PRODUCTION.values():
        _, tp, z = _port_bytes(get_config("xlstm-1.3b"), mesh)
        whole = {p[-2] for p, d in zip(tp.full.paths, z.dims) if d is None}
        assert whole == {"wif", "wq", "wk", "wv"}, whole


def test_zero1_needs_sharded_aggregation():
    with pytest.raises(ValueError, match="sharded_agg"):
        TrainConfig(zero1=True)
    with pytest.raises(ValueError, match="sharded="):
        init_train_state(_cfg("smollm-360m"), sgd(), zero1=True)


def _batches(cfg):
    rng = np.random.default_rng(29)
    return [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                              (W, 2, 16)).astype(np.int32))
             for k in ("tokens", "labels")} for _ in range(STEPS)]


def _tc(zero1):
    return TrainConfig(aggregator=AggregatorConfig(
        name="flag", flag=FlagConfig(lam=0.0, regularizer="none", tol=0.0)),
        sharded_agg=True, zero1=zero1)


def _moments(state) -> dict:
    return {k: v.clone() for k, v in state.opt_state.items() if v.dim()}


def _case(rank, mesh, arch, oname, root):
    """Both runs of one case on this rank (module docstring)."""
    from repro_torch.checkpoint import load_checkpoint, save_checkpoint
    from repro_torch.dist.sharded import comm_stats, reset_comm_stats
    from repro_torch.dist.train_step import train_state_tree
    from repro_torch.weights import tp_take
    cfg, batches, w0 = _cfg(arch), _batches(_cfg(arch)), rank == 0
    dirs = {k: os.path.join(root, f"{arch}_{oname}_{k}")
            for k in ("plain", "zero1")}
    runs, out = {}, {"flat_equal": [], "moments_equal": []}
    for zero1 in (False, True):
        opt = _opt(oname)
        state = init_train_state(cfg, opt, seed=5, sharded=mesh,
                                 zero1=zero1)
        step = build_train_step(cfg, _tc(zero1), opt, constant(1e-3))
        reset_comm_stats()
        hist = []
        for t in range(STEPS):
            step(state, batches[t], t)
            hist.append((state.flat.clone(), _moments(state)))
            if t + 1 in (2, STEPS):
                save_checkpoint(dirs["zero1" if zero1 else "plain"], t + 1,
                                train_state_tree(state), write=w0)
        runs[zero1] = (hist, state)
        if zero1:
            out["comm"] = {k: dict(v) for k, v in comm_stats.items()}
            out["moment_bytes"] = sum(v.numel() * v.element_size()
                                      for v in state.opt_state.values()
                                      if v.dim())
            out["block_bytes"] = 4 * state.zero1.local.numel
            out["n_moments"] = sum(v.dim() == 1
                                   for v in state.opt_state.values())
            cut = [n for n, d in zip(state.zero1.local.sizes,
                                     state.zero1.dims) if d is not None]
            out["cut_bytes"], out["n_cut"] = 4 * sum(cut), len(cut)
    z = runs[True][1].zero1
    for (fa, ma), (fb, mb) in zip(runs[False][0], runs[True][0]):
        out["flat_equal"].append(torch.equal(fa, fb))
        out["moments_equal"].append(all(
            torch.equal(tp_take(ma[k], z), mb[k]) for k in ma))
    # each step-2 file into the other kind of state, then its third step
    out["resumed_equal"] = {}
    for src, zero1 in (("plain", True), ("zero1", False)):
        opt = _opt(oname)
        state = init_train_state(cfg, opt, seed=11, sharded=mesh,
                                 zero1=zero1)
        load_checkpoint(dirs[src], train_state_tree(state), step=2)
        build_train_step(cfg, _tc(zero1), opt, constant(1e-3))(
            state, batches[2], 2)
        out["resumed_equal"][src] = torch.equal(state.flat,
                                                runs[zero1][1].flat)
    # a whole-moment state under a zero1 step, and the reverse, raise
    out["mismatch_raises"] = []
    for zero1 in (False, True):
        opt = _opt(oname)
        try:
            build_train_step(cfg, _tc(not zero1), opt, constant(1e-3))(
                runs[zero1][1], batches[0], 0)
            out["mismatch_raises"].append(False)
        except ValueError as e:
            out["mismatch_raises"].append("zero1" in str(e))
    out["dirs"] = dirs
    return out


def _world(rank, mesh, root):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    try:
        with use_sharding(mesh):
            return {(a, o): _case(rank, mesh, a, o, root)
                    for a in STEP_ARCHS for o in OPTS}
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module", params=sorted(WORLDS))
def world(request, tmp_path_factory):
    mesh = WORLDS[request.param]
    root = str(tmp_path_factory.mktemp(f"zero1_{request.param}"))
    return mesh, spawn(_world, mesh.size, mesh, root,
                       timeout=SPAWN_TIMEOUT)


CASES = [(a, o) for a in STEP_ARCHS for o in OPTS]
IDS = [f"{a}-{o}" for a, o in CASES]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_zero1_step_equals_the_whole_update(world, case):
    _, ranks = world
    for r, res in enumerate(ranks):
        got = res[case]
        assert got["flat_equal"] == [True] * STEPS, (r, got["flat_equal"])
        assert got["moments_equal"] == [True] * STEPS, r


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_zero1_moment_bytes_and_all_gather(world, case):
    mesh, ranks = world
    arch, _ = case
    for r, res in enumerate(ranks):
        got = res[case]
        want, tp, _ = _port_bytes(_cfg(arch), mesh, r)
        assert want == _rule_bytes(tp, mesh)
        assert got["moment_bytes"] == got["n_moments"] * sum(want)
        assert got["block_bytes"] == sum(want)
        ag = got["comm"]["zero1_all_gather"]
        assert ag["calls"] == STEPS * got["n_cut"] > 0
        assert ag["bytes"] == STEPS * got["cut_bytes"]


def _entries(path) -> dict:
    with zipfile.ZipFile(path) as zf:
        return {n: zf.read(n) for n in zf.namelist()}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_zero1_checkpoint_is_the_whole_runs_bytes(world, case):
    _, ranks = world
    dirs = ranks[0][case]["dirs"]
    for step in (2, STEPS):
        a, b = (_entries(os.path.join(dirs[k], f"step_{step:08d}",
                                      "state_0.npz"))
                for k in ("plain", "zero1"))
        assert a.keys() == b.keys() and len(a) > 0
        assert all(a[k] == b[k] for k in a), [k for k in a if a[k] != b[k]]


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_zero1_state_and_step_must_agree(world, case):
    _, ranks = world
    for r, res in enumerate(ranks):
        assert res[case]["mismatch_raises"] == [True, True], r


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_zero1_checkpoint_resumes_both_ways(world, case):
    _, ranks = world
    for r, res in enumerate(ranks):
        assert res[case]["resumed_equal"] == {"plain": True,
                                              "zero1": True}, r
