"""Port parity: the sharded train step with tensor parallelism over the
mesh's ``model`` axis, on a gloo world of 4 CPU ranks (the host mesh
(data 2, model 2)), against the JAX package's unsharded step.

The world is started once for the module (``repro_torch.launch.ranks.
spawn``); its ranks import only ``repro_torch``.  JAX's parameters (its
init, seeded) are carried across: ``init_train_state(..., params=,
sharded=mesh)`` cuts each rank's blocks out of them (``weights.
tp_slice``), and the ranks' blocks go back together with ``tp_unslice``.
Held, in the setting of JAX's ``test_train_step_sharded_matches_single``
(reduced smollm-360m, SGD momentum 0.9, flag lambda 0, tol 0, constant
1e-3, seeded tokens), at that test's tolerances: the loss rtol 1e-6, the
FA weights and parameters rtol 1e-4 / atol 1e-5:

* W = 4 (the split path: each data group computes 2 workers, its two
  ranks each their half of the model) and W = 3 (3 does not divide over
  data 2: the replicated path), with the heads split over the ranks (4
  heads, 2 KV heads) and with ``qkv`` split mid-head (3 heads, 1 KV
  head, head_dim 64, as smollm-360m's 15 / 5: q / k / v gathered), under
  flag (W = 3 mid-head under signSGD below); bulyan (W = 4, f = 1, heads split: its picks exactly and each
  parameter within the largest change JAX made, the midpoint tie of
  ``tests/test_torch_train.py``) and signSGD with error feedback (W = 3,
  mid-head; the EF memory within 5 % of JAX's in norm, as
  ``tests/test_torch_sharded_train.py`` holds a biased codec's);
* every rank's metrics are the same bits, the ranks of a data group the
  same parameter bits;
* each rank holds its ``logical_spec`` block of every partitioned
  parameter and AdamW moment leaf (half of it), the replicated leaves
  whole, and no full copy of the model;
* the launcher with ``--sharded-agg --codec signsgd --ckpt-dir``
  (``tp=model:2``), for smollm-360m and for deepseek-moe-16b (its banks
  split over ``expert_mlp``: a body bank's split dimension sits behind
  the period axis): a run killed after step 2 and resumed equals the
  uninterrupted run bit for bit (steps, the ranks' parameter and moment
  blocks, the step-4 files), and the file (the one-device format: whole
  leaves) loads into the port's unsharded state and into ``repro.
  checkpoint.load_checkpoint``'s JAX template with the bits of the ranks'
  blocks put together;
* the deepseek run says ``tp=model:2`` and its ranks' losses are the
  same bits; a whole-model state stepped under rules that split the
  model raises ``ValueError`` (no silent mix).
"""

from __future__ import annotations

import contextlib
import io
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.comm import CommConfig
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.flag import FlagConfig
from repro_torch.dist.aggregation import AggregatorConfig
from repro_torch.dist.sharding import resolve_rules, use_sharding
from repro_torch.dist.train_step import (TrainConfig, build_train_step,
                                         init_train_state)
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import Mesh, make_host_mesh
from repro_torch.launch.ranks import spawn
from repro_torch.models import transformer
from repro_torch.optim import adamw, constant, sgd
from repro_torch.weights import pack, tp_unslice, unflatten

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

MESH = Mesh((2, 2), ("data", "model"))
# (config, W, rule, codec)
CASES = (("heads_split", 4, "flag", "none"),
         ("heads_split", 3, "flag", "none"),
         ("mid_head", 4, "flag", "none"),
         ("heads_split", 4, "bulyan", "none"),
         ("mid_head", 3, "flag", "signsgd"))
CKPT_W = 4
CKPT_ARGV = ["--debug", "--device", "cpu", "--sharded-agg", "--workers",
             str(CKPT_W), "--codec", "signsgd", "--steps", "4", "--seq",
             "16", "--per-worker-batch", "2", "--ckpt-every", "2",
             "--log-every", "100"]
CKPT_ARCHS = ("smollm-360m", "deepseek-moe-16b")
SPAWN_TIMEOUT = 300


def _cfg(name):
    cfg = reduce_for_smoke(get_config("smollm-360m"))
    return cfg if name == "heads_split" else cfg.replace(
        num_heads=3, num_kv_heads=1, head_dim=64)


def _jcfg(name):
    from repro.configs import get_config as jget, reduce_for_smoke as jred
    cfg = jred(jget("smollm-360m")).replace(frontend=None,
                                            num_prefix_embeds=0)
    return cfg if name == "heads_split" else cfg.replace(
        num_heads=3, num_kv_heads=1, head_dim=64)


def _batch(W, seed=23):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, 512, (W, 2, 16)).astype(np.int32)
            for k in ("tokens", "labels")}


def _agg(rule):
    return AggregatorConfig(name=rule, flag=FlagConfig(
        lam=0.0, regularizer="none", tol=0.0))


def _layouts(name):
    """Each rank's tensor-parallel layout of ``name``'s tree."""
    cfg = _cfg(name)
    return [transformer.tp_layout(cfg, MESH, resolve_rules(MESH), r)
            for r in range(MESH.size)]


def _step_case(np_params, case, mesh):
    name, W, rule, codec = case
    cfg, opt = _cfg(name), sgd(momentum=0.9)
    tc = TrainConfig(aggregator=_agg(rule), comm=CommConfig(codec=codec),
                     sharded_agg=True)
    state = init_train_state(cfg, opt, params=np_params[name],
                             comm=tc.comm, workers=W, sharded=mesh)
    step = build_train_step(cfg, tc, opt, constant(1e-3))
    m = step(state, {k: torch.from_numpy(v) for k, v in _batch(W).items()},
             0)
    return {"loss": float(m["loss"]), "c": m["fa_weights"].numpy().copy(),
            "d_norm": float(m["grad_global_norm"]),
            "flat": state.flat.numpy().copy(),
            "mu": state.opt_state["mu"].numpy().copy(),
            "shapes": state.layout.shapes,
            "ef": None if state.ef is None else state.ef.numpy().copy()}


class _Kill(Exception):
    """Ends a launcher run from its step hook, as a crash would."""


def _ckpt_cfg(arch):
    """The launcher's ``--debug`` configuration of ``arch``."""
    return reduce_for_smoke(get_config(arch)).replace(frontend=None,
                                                      num_prefix_embeds=0)


def _ckpt_jcfg(arch):
    from repro.configs import get_config as jget, reduce_for_smoke as jred
    return jred(jget(arch)).replace(frontend=None, num_prefix_embeds=0)


def _ckpt_runs(root, arch):
    last = {}
    argv = CKPT_ARGV + ["--arch", arch]
    root = f"{root}/{arch}"

    def keep(name):
        def hook(t, state, m):
            if t == 3:
                last[name + "_state"] = (
                    state.flat.numpy().copy(),
                    state.opt_state["mu"].numpy().copy(),
                    state.opt_state["nu"].numpy().copy(),
                    state.ef.numpy().copy())
        return hook

    def kill(t, state, m):
        if t == 2:
            raise _Kill
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        full = tlaunch.main(argv + ["--ckpt-dir", f"{root}/full"],
                            on_step=keep("full"))
        try:
            tlaunch.main(argv + ["--ckpt-dir", f"{root}/killed"],
                         on_step=kill)
        except _Kill:
            pass
        dist.barrier()
        resumed = tlaunch.main(argv + ["--ckpt-dir", f"{root}/killed"],
                               on_step=keep("resumed"))
    return {"full": full, "resumed": resumed, "stdout": out.getvalue(),
            **last}


def _rank(rank, np_params, root):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    try:
        mesh = make_host_mesh()
        assert mesh == MESH
        out = {"ckpt": {arch: _ckpt_runs(root, arch)
                        for arch in CKPT_ARCHS}}
        with use_sharding(mesh):
            for case in CASES:
                out[case] = _step_case(np_params, case, mesh)
            # a whole-model state under rules that split the model
            cfg, opt = _cfg("heads_split"), sgd(momentum=0.9)
            state = init_train_state(cfg, opt, params=np_params[
                "heads_split"])
            step = build_train_step(cfg, TrainConfig(
                aggregator=_agg("flag"), sharded_agg=True), opt,
                constant(1e-3))
            try:
                step(state, {k: torch.from_numpy(v)
                             for k, v in _batch(4).items()}, 0)
                out["mixed"] = None
            except ValueError as e:
                out["mixed"] = str(e)
        return out
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def np_params():
    import jax
    from repro.models import transformer as jtransformer
    return {name: jax.tree.map(np.asarray, jtransformer.init_params(
        jax.random.PRNGKey(0), _jcfg(name)))
        for name in ("heads_split", "mid_head")}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("tp_ckpt"))


@pytest.fixture(scope="module")
def world_and_jax(np_params, root):
    """The world's results and JAX's steps, the JAX steps compiled here
    while the ranks run."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(1) as pool:
        fut = pool.submit(spawn, _rank, MESH.size, np_params, root,
                          timeout=SPAWN_TIMEOUT)
        steps = _jax_steps(np_params)
        return fut.result(), steps


@pytest.fixture(scope="module")
def world(world_and_jax):
    return world_and_jax[0]


@pytest.fixture(scope="module")
def jax_steps(world_and_jax):
    return world_and_jax[1]


def _jax_steps(np_params):
    """JAX's unsharded step for every case: loss, FA weights, the new
    parameters (flat, canonical order) and, with a codec, the new EF
    memory as (W, N)."""
    import jax
    import jax.numpy as jnp
    from repro.comm import compressors as jcomp
    from repro.comm import init_ef as jinit_ef
    from repro.core.flag import FlagConfig as JFlag
    from repro.dist.aggregation import AggregatorConfig as JAgg
    from repro.dist.train_step import (TrainConfig as JTrainConfig,
                                       build_train_step as jbuild)
    from repro.optim import constant as jconstant, sgd as jsgd
    opt = jsgd(momentum=0.9)
    out = {}
    for case in CASES:
        name, W, rule, codec = case
        params = jax.tree.map(jnp.asarray, np_params[name])
        tc = JTrainConfig(aggregator=JAgg(name=rule, flag=JFlag(
            lam=0.0, regularizer="none", tol=0.0)),
            comm=jcomp.CommConfig(codec=codec))
        step = jax.jit(jbuild(_jcfg(name), tc, opt, jconstant(1e-3)))
        args = (params, opt.init(params),
                jax.tree.map(jnp.asarray, _batch(W)),
                jax.random.PRNGKey(1), jnp.zeros((), jnp.int32))
        res = step(*args, jinit_ef(params, W)) if codec != "none" \
            else step(*args)
        p, m = res[0], res[2]
        out[case] = {"loss": float(m["loss"]),
                     "c": np.asarray(m["fa_weights"]),
                     "flat": np.concatenate([np.asarray(x).reshape(-1)
                                             for x in jax.tree.leaves(p)]),
                     "ef": None if codec == "none" else np.concatenate(
                         [np.asarray(x).reshape(W, -1)
                          for x in jax.tree.leaves(res[3])], 1)}
    return out


def _leaves(tree):
    """The leaves of a nested dict / list tree in canonical order."""
    from repro_torch.weights import leaf_items
    return [leaf for _, leaf in leaf_items(tree)]


def _whole(res, name, key, layouts):
    """The whole flat vector of ``key`` from the blocks of ranks 0 and 1
    (data group 0's ``model`` group)."""
    trees = [unflatten(torch.from_numpy(res[r][key]), layouts[r].local)
             for r in range(2)]
    return pack(tp_unslice(trees, layouts[0]))[0].numpy()


def _whole_ef(res, layouts):
    from repro_torch.dist.sharding import CoordShards
    shards = CoordShards(layouts[0].full.sizes, MESH.size)
    W = res[0].shape[0]
    return np.stack([shards.gather(torch.from_numpy(np.stack(
        [r[w] for r in res])), torch.empty(shards.numel)).numpy()
        for w in range(W)])


@pytest.mark.parametrize("case", CASES, ids=["-".join(map(str, c))
                                             for c in CASES])
def test_tp_step_matches_jax_unsharded(case, world, jax_steps, np_params):
    name = case[0]
    lays = _layouts(name)
    got, want = [r[case] for r in world], jax_steps[case]
    for r in got[1:]:
        assert r["loss"] == got[0]["loss"]
        assert r["d_norm"] == got[0]["d_norm"]
        np.testing.assert_array_equal(r["c"], got[0]["c"])
    for r in (0, 1):                      # data groups hold the same bits
        np.testing.assert_array_equal(got[r]["flat"], got[r + 2]["flat"])
    assert np.isfinite(got[0]["loss"])
    np.testing.assert_allclose(got[0]["loss"], want["loss"], rtol=1e-6)
    flat = _whole(got, name, "flat", lays)
    if case[2] == "bulyan":
        # beta = max(theta - 2f, 1) = 1 of theta = 2 picks a coordinate:
        # the midpoint tie of tests/test_torch_train.py (fp32 rounding of
        # (a + b) / 2 decides it): the picks exactly, each parameter within
        # the largest change JAX made
        np.testing.assert_array_equal(got[0]["c"], want["c"])
        start = np.concatenate([np.asarray(x).reshape(-1) for x in
                                _leaves(np_params[name])])
        moved = np.abs(want["flat"] - start).max()
        np.testing.assert_allclose(flat, want["flat"], rtol=0, atol=moved)
        return
    np.testing.assert_allclose(got[0]["c"], want["c"], rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(flat, want["flat"], rtol=1e-4, atol=1e-5)
    if want["ef"] is not None:
        ef = _whole_ef([r[case]["ef"] for r in world], lays)
        assert np.linalg.norm(ef - want["ef"]) < 5e-2 * np.linalg.norm(
            want["ef"])


@pytest.mark.parametrize("name", ["heads_split", "mid_head"])
def test_each_rank_holds_its_blocks_and_no_full_copy(name, world):
    lays = _layouts(name)
    full = lays[0].full
    case = next(c for c in CASES if c[0] == name)
    for r, res in enumerate(world):
        st = res[case]
        lay = lays[r]
        assert tuple(st["shapes"]) == lay.local.shapes
        for shape, local, d in zip(full.shapes, lay.local.shapes, lay.dims):
            if d is None:
                assert local == shape
            else:
                assert local[d] * 2 == shape[d]
                assert local[:d] + local[d + 1:] == shape[:d] + shape[d + 1:]
        split = sum(n for n, d in zip(full.sizes, lay.dims) if d is not None)
        assert split > full.numel // 2
        assert st["flat"].size == st["mu"].size == full.numel - split // 2
    # the blocks agree with the spec: each leaf's split dimension is where
    # the rules put ``model`` (tests/test_torch_tensor_parallel.py holds
    # that against JAX's own logical_spec for every dense config)
    for (path, shape), d in zip(zip(full.paths, full.shapes), lays[0].dims):
        if path[-1] == "w" and path[-2] in ("wq", "wk", "wv", "up", "gate"):
            assert d == len(shape) - 1, path
        elif path[-1] == "w" and path[-2] in ("wo", "down"):
            assert d == len(shape) - 2, path
        elif path[-1] == "table":
            assert d == 0
        else:
            assert d is None, path


def _ckpt_layouts(arch):
    cfg = _ckpt_cfg(arch)
    return [transformer.tp_layout(cfg, MESH, resolve_rules(MESH), r)
            for r in range(MESH.size)]


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_tp_checkpoint_kill_and_resume(world, root, arch):
    """The resumed run's steps 2-3, its final parameter, moment and EF
    blocks and its step-4 file equal the uninterrupted run's."""
    assert "tp=model:2" in world[0]["ckpt"][arch]["stdout"]
    for r in world:
        ck = r["ckpt"][arch]
        assert [h["step"] for h in ck["full"]] == [0, 1, 2, 3]
        assert [h["step"] for h in ck["resumed"]] == [2, 3]
        for a, b in zip(ck["resumed"], ck["full"][2:]):
            for k in ("loss", "lr", "grad_global_norm", "fa_weights",
                      "comm_bits"):
                assert a[k] == b[k], k
        for a, b in zip(ck["resumed"], world[0]["ckpt"][arch]["resumed"]):
            assert a["loss"] == b["loss"]
        for a, b in zip(ck["resumed_state"], ck["full_state"]):
            np.testing.assert_array_equal(a, b)
    files = [np.load(f"{root}/{arch}/{d}/step_00000004/state_0.npz")
             for d in ("full", "killed")]
    assert sorted(files[0].files) == sorted(files[1].files)
    for k in files[0].files:
        np.testing.assert_array_equal(files[0][k], files[1][k], err_msg=k)


@pytest.mark.parametrize("arch", CKPT_ARCHS)
def test_tp_checkpoint_loads_unsharded_and_in_jax(world, root, arch):
    """The step-4 file holds whole leaves: it loads into the port's
    unsharded state (the EF a (W, N) buffer) and into JAX's launcher
    template with the bits of the ranks' blocks put together; for
    deepseek-moe-16b a body bank split behind the period axis (dimension
    3 of (periods, E, d, d_e)) comes back whole, bit for bit."""
    import jax
    from repro.checkpoint import load_checkpoint as jax_load
    from repro.comm import init_ef as jinit_ef
    from repro.models import transformer as jtransformer
    from repro.optim import adamw as jadamw
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.dist.train_step import train_state_tree
    lays = _ckpt_layouts(arch)
    blocks = [dict(zip(("flat", "mu", "nu", "ef"),
                       r["ckpt"][arch]["resumed_state"])) for r in world]
    flat, mu, nu = (_whole(blocks, None, k, lays)
                    for k in ("flat", "mu", "nu"))
    ef = _whole_ef([b["ef"] for b in blocks], lays)
    d = f"{root}/{arch}/killed"
    state = init_train_state(_ckpt_cfg(arch), adamw(), seed=3,
                             comm=CommConfig(codec="signsgd"),
                             workers=CKPT_W)
    _, step = load_checkpoint(d, train_state_tree(state))
    assert step == 4 and state.tp is None
    np.testing.assert_array_equal(state.flat.numpy(), flat)
    np.testing.assert_array_equal(state.opt_state["mu"].numpy(), mu)
    np.testing.assert_array_equal(state.opt_state["nu"].numpy(), nu)
    np.testing.assert_array_equal(state.ef.numpy(), ef)
    params = jtransformer.init_params(jax.random.PRNGKey(0),
                                      _ckpt_jcfg(arch))
    template = (params, jadamw().init(params), jinit_ef(params, CKPT_W))
    (jp, jopt, jef), step = jax_load(d, template)
    assert step == 4

    def cat(tree, lead=()):
        return np.concatenate([np.asarray(x).reshape(*lead, -1)
                               for x in jax.tree.leaves(tree)], -1)
    np.testing.assert_array_equal(cat(jp), flat)
    np.testing.assert_array_equal(cat(jopt["mu"]), mu)
    np.testing.assert_array_equal(cat(jef, (CKPT_W,)), ef)
    if arch == "deepseek-moe-16b":
        i = lays[0].full.paths.index(("body", 0, "ffn", "w_up"))
        assert lays[0].dims[i] == 3
        parts = [unflatten(torch.from_numpy(blocks[r]["flat"]),
                           lays[r].local) for r in range(2)]
        np.testing.assert_array_equal(
            np.asarray(jp["body"][0]["ffn"]["w_up"]),
            np.concatenate([p["body"][0]["ffn"]["w_up"].numpy()
                            for p in parts], axis=3))


def test_moe_config_trains_tensor_parallel(world):
    """The deepseek smoke run says ``tp=model:2`` (its banks among the
    split leaves) and its ranks' losses are the same bits."""
    out = world[0]["ckpt"]["deepseek-moe-16b"]["stdout"]
    line = next(ln for ln in out.splitlines()
                if ln.startswith("arch=deepseek-moe-16b-smoke"))
    assert "mesh={'data': 2, 'model': 2}" in line
    assert "tp=model:2 split=" in line and ".ffn.w_up" in line
    hists = [r["ckpt"]["deepseek-moe-16b"]["full"] for r in world]
    assert all(np.isfinite(h["loss"]) for h in hists[0])
    for h in hists[1:]:
        assert [x["loss"] for x in h] == [x["loss"] for x in hists[0]]


def test_a_state_whose_split_the_rules_do_not_give_raises(world):
    for r in world:
        assert r["mixed"] is not None and "parameter split" in r["mixed"]
