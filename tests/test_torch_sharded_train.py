"""Port parity: the sharded train step (``TrainConfig(sharded_agg=True)``)
on gloo worlds of 2 CPU ranks (W = 4 over data 2: the split path, one
``all_to_all`` per worker of a group), 3 (3 does not divide 4: the
replicated path) and 4 (mesh (2, 2): the split path, the two ranks of a
group computing the same workers and each taking its columns from the
rank of its ``model`` index), and the launcher's ``--sharded-agg`` /
``--multi-pod``.

Each world is started once for the module (``repro_torch.launch.ranks.
spawn``); its ranks import only ``repro_torch`` and hand their results
back.  Held:

* JAX's ``test_train_step_sharded_matches_single`` setting (reduced
  smollm-360m, W = 4, SGD momentum 0.9, flag lambda 0, tol 0, constant
  1e-3, its tokens) against JAX's unsharded step at that test's
  tolerances (loss rtol 1e-6; FA weights and parameters rtol 1e-4 /
  atol 1e-5);
* each of the seven attacks and the churn schedule's mask against the
  port's unsharded step: the loss exactly (the same per-worker forward),
  the FA weights and parameters at the same tolerances (the Gram is
  reassociated; under ``ipm`` the Gram is singular and only the update
  is held); on a stack, the
  attacked shard equals the slice of the unsharded attacked stack bit
  for bit for every attack but ``gaussian`` (whose leaf std is combined
  across ranks: rtol 1e-5, fp32 reassociation);
* every rank's metrics and parameters are the same bits.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import attacks as tattacks
from repro_torch.core.flag import FlagConfig
from repro_torch.dist.aggregation import AggregatorConfig
from repro_torch.dist.membership import get_fault_schedule
from repro_torch.dist.sharded import coord_shards, shard_index
from repro_torch.dist.sharding import use_sharding
from repro_torch.dist.train_step import (TrainConfig, build_train_step,
                                         init_train_state)
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.ranks import spawn
from repro_torch.optim import constant, sgd

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

W = 4
ATTACKS = ("random", "gaussian", "sign_flip", "zero", "drop", "ipm", "alie")
CASES = ("plain",) + ATTACKS + ("churn",)
SPAWN_TIMEOUT = 300
AGG = AggregatorConfig(name="flag", flag=FlagConfig(lam=0.0,
                                                    regularizer="none",
                                                    tol=0.0))


def _cfg():
    return reduce_for_smoke(get_config("smollm-360m"))


def _batch(seed=23):
    rng = np.random.default_rng(seed)
    vocab = _cfg().vocab_size
    return {k: rng.integers(0, vocab, (W, 2, 16)).astype(np.int32)
            for k in ("tokens", "labels")}


def _tc(case: str, sharded: bool) -> TrainConfig:
    kw = {}
    if case in ATTACKS:
        kw = dict(attack=case, attack_f=1)
    elif case == "churn":
        kw = dict(faults=get_fault_schedule("churn", W))
    return TrainConfig(aggregator=AGG, sharded_agg=sharded, **kw)


def _one_step(np_params, case, sharded, step_idx):
    cfg, opt = _cfg(), sgd(momentum=0.9)
    state = init_train_state(cfg, opt, params=np_params)
    step = build_train_step(cfg, _tc(case, sharded), opt, constant(1e-3))
    batch = {k: torch.from_numpy(v) for k, v in _batch().items()}
    m = step(state, batch, step_idx)
    return (float(m["loss"]), m["fa_weights"].numpy().copy(),
            state.flat.numpy().copy(),
            m.get("active_workers", torch.tensor(W)).item())


def _stack(seed, W_=9):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(W_, 900 + 77 + 1)).astype(
        np.float32)), (900, 77, 1)


def _rank(rank, np_params):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    try:
        mesh = make_host_mesh()
        out = {}
        with use_sharding(mesh):
            for case in CASES:
                step_idx = 5 if case == "churn" else 0
                out[case] = _one_step(np_params, case, True, step_idx)
            s = shard_index(mesh)
            for name in ATTACKS:
                X, sizes = _stack(31)
                shards = coord_shards(sizes, mesh)
                Xs = shards.local(X, s)
                tattacks.apply_attack(name, Xs, 3, seed=4, shards=shards,
                                      shard=s)
                tattacks.apply_attack(name, X, 3, leaf_sizes=sizes, seed=4)
                out[("stack", name)] = (Xs.numpy(),
                                        shards.local(X, s).numpy())
        return out
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def np_params():
    import jax
    from repro.configs import get_config as jget, reduce_for_smoke as jred
    from repro.models import transformer as jtransformer
    jcfg = jred(jget("smollm-360m")).replace(frontend=None,
                                             num_prefix_embeds=0)
    return jax.tree.map(np.asarray, jtransformer.init_params(
        jax.random.PRNGKey(0), jcfg))


@pytest.fixture(scope="module")
def worlds(np_params):
    cache = {}

    def get(R):
        if R not in cache:
            cache[R] = spawn(_rank, R, np_params, timeout=SPAWN_TIMEOUT)
        return cache[R]
    return get


@pytest.fixture(scope="module")
def unsharded(np_params):
    return {case: _one_step(np_params, case, False,
                            5 if case == "churn" else 0) for case in CASES}


@pytest.fixture(scope="module")
def jax_step(np_params):
    import jax
    import jax.numpy as jnp
    from repro.configs import get_config as jget, reduce_for_smoke as jred
    from repro.core.flag import FlagConfig as JFlag
    from repro.dist.aggregation import AggregatorConfig as JAgg
    from repro.dist.train_step import (TrainConfig as JTrainConfig,
                                       build_train_step as jbuild)
    from repro.optim import constant as jconstant, sgd as jsgd
    jcfg = jred(jget("smollm-360m")).replace(frontend=None,
                                             num_prefix_embeds=0)
    opt = jsgd(momentum=0.9)
    params = jax.tree.map(jnp.asarray, np_params)
    tc = JTrainConfig(aggregator=JAgg(name="flag", flag=JFlag(
        lam=0.0, regularizer="none", tol=0.0)))
    step = jax.jit(jbuild(jcfg, tc, opt, jconstant(1e-3)))
    p, _, m = step(params, opt.init(params),
                   jax.tree.map(jnp.asarray, _batch()),
                   jax.random.PRNGKey(1), jnp.zeros((), jnp.int32))
    return (float(m["loss"]), np.asarray(m["fa_weights"]),
            np.concatenate([np.asarray(x).reshape(-1)
                            for x in jax.tree.leaves(p)]))


def _same_on_every_rank(res, key):
    for r in res[1:]:
        for a, b in zip(res[0][key], r[key]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("R", [2, 3, 4])
def test_sharded_step_matches_jax_unsharded(R, worlds, jax_step):
    res = worlds(R)
    _same_on_every_rank(res, "plain")
    loss, c, flat, _ = res[0]["plain"]
    j_loss, j_c, j_flat = jax_step
    assert np.isfinite(loss)
    np.testing.assert_allclose(loss, j_loss, rtol=1e-6)
    np.testing.assert_allclose(c, j_c, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(flat, j_flat, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("R", [2, 3, 4])
def test_sharded_step_matches_port_unsharded(R, case, worlds, unsharded):
    res = worlds(R)
    _same_on_every_rank(res, case)
    loss, c, flat, active = res[0][case]
    u_loss, u_c, u_flat, u_active = unsharded[case]
    assert loss == u_loss and active == u_active
    if case == "churn":
        assert active == W - 1 and c[1] == 0.0
    if case != "ipm":
        # ipm's Byzantine row is -0.1 x the honest mean, an exact linear
        # combination of the others: the Gram is singular, the FA
        # weights are not unique (a reassociated Gram moves them ~2 %),
        # and only the update they give is held
        np.testing.assert_allclose(c, u_c, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(flat, u_flat, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("name", ATTACKS)
@pytest.mark.parametrize("R", [2, 3, 4])
def test_attack_on_a_shard_is_the_slice(R, name, worlds):
    for r in worlds(R):
        got, want = r[("stack", name)]
        if name == "gaussian":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


def test_sharded_step_needs_an_active_mesh(np_params):
    with pytest.raises(ValueError, match="needs an active mesh"):
        _one_step(np_params, "plain", True, 0)


def test_sharded_config_rejects_decoding_codecs():
    from repro_torch.comm import CommConfig
    from repro_torch.dist.train_step import check_train_config
    check_train_config(TrainConfig(sharded_agg=True,
                                   comm=CommConfig(codec="countsketch")))
    for codec in ("signsgd", "topk", "identity"):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            check_train_config(TrainConfig(sharded_agg=True,
                                           comm=CommConfig(codec=codec)))


def test_launcher_sharded_world_of_one_prints_the_same_steps(capsys):
    """One shard is the whole stack: the same bits as without the flag.
    One intra-op thread, because the CPU backward's multi-threaded
    reductions vary in their last bit from run to run."""
    argv = ["--debug", "--device", "cpu", "--steps", "3", "--seq", "32",
            "--workers", "6", "--byzantine", "1", "--attack", "random",
            "--log-every", "1"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        plain = tlaunch.main(argv)
        out_plain = capsys.readouterr().out
        sharded = tlaunch.main(argv + ["--sharded-agg"])
        out_sharded = capsys.readouterr().out
    finally:
        torch.set_num_threads(threads)
    assert not dist.is_initialized()          # the group is destroyed
    assert "sharded_agg ranks=1" in out_sharded
    def steps(out):     # the step lines without their elapsed seconds
        return [ln.rsplit(" (", 1)[0] for ln in out.splitlines()
                if ln.startswith("step")]
    assert len(steps(out_plain)) == 3
    assert steps(out_plain) == steps(out_sharded)
    for a, b in zip(plain, sharded):
        assert a["loss"] == b["loss"]
        assert a["fa_weights"] == b["fa_weights"]
        assert a["grad_global_norm"] == b["grad_global_norm"]


def test_launcher_multi_pod_raises_before_drawing_weights(monkeypatch):
    from repro_torch.models import transformer
    monkeypatch.setattr(transformer, "init_params", lambda *a, **k: (
        pytest.fail("weights drawn")))
    with pytest.raises(ValueError, match="512"):
        tlaunch.main(["--device", "cpu", "--multi-pod", "--steps", "1"])
    assert not dist.is_initialized()
