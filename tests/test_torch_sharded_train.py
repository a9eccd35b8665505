"""Port parity: the sharded train step (``TrainConfig(sharded_agg=True)``)
on gloo worlds of 2 CPU ranks (W = 4 over data 2: the split path, one
``all_to_all`` per worker of a group), 3 (3 does not divide 4: the
replicated path) and 4 (mesh (2, 2) with the rules that split the model
over ``model`` overridden to keep it replicated: the split path, the two
ranks of a group computing the same workers and each taking its columns
from the rank of its ``model`` index), and the launcher's
``--sharded-agg`` / ``--multi-pod``.

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
* every rank's metrics and parameters are the same bits;
* the codecs with error feedback (CODEC_CASES: signSGD and top-k, alone
  and under churn; two steps, the EF memory carried): each rank's EF
  memory is its (W, width) coordinate shard, never (W, N); against the
  port's unsharded steps, step 0's loss exactly, top-k's EF shard bit
  for bit and signSGD's within atol 1e-6 of its largest entry (a cut
  row's scale sums its parts over the ranks), the FA weights and
  parameters at the tolerances above; at step 1 (from parameters that
  differ by step 0's reassociated weights) the loss rtol 1e-6 and the EF
  as test_torch_train_comm.py holds a biased codec's (a coordinate near
  the k-th |h| or near 0 may decode otherwise): in norm within 5 % of its
  own norm; against JAX's step with the codec (signSGD, top-k) the loss,
  weights and parameters as the plain step, the EF in norm as above;
* in the world of 2, the launcher with ``--sharded-agg --codec signsgd
  --ckpt-dir``: a run killed after step 2 and resumed equals the
  uninterrupted run bit for bit (steps, parameters, EF shards, the step-4
  files), and the file it writes (one format-v2 file, the EF as whole
  (W, *shape) leaves) loads into the port's unsharded state and into
  ``repro.checkpoint.load_checkpoint``'s JAX template with the same bits
  as the ranks' state.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.comm import CommConfig
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
from repro_torch.optim import adamw, constant, sgd

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

W = 4
ATTACKS = ("random", "gaussian", "sign_flip", "zero", "drop", "ipm", "alie")
CASES = ("plain",) + ATTACKS + ("churn",)
# codec runs with error feedback: (codec, churn)
CODEC_CASES = (("signsgd", False), ("topk", False), ("signsgd", True),
               ("topk", True))
CKPT_ARGV = ["--debug", "--device", "cpu", "--sharded-agg", "--workers",
             str(W), "--codec", "signsgd", "--steps", "4", "--seq", "16",
             "--per-worker-batch", "2", "--ckpt-every", "2", "--log-every",
             "100"]
SPAWN_TIMEOUT = 300
# rule overrides that keep the model replicated on a mesh with a model axis
REPLICATED = {"vocab": None, "mlp": None, "qkv": None, "heads": None,
              "kv_heads": None}
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


def _codec_steps(np_params, case, sharded):
    """Two steps under the codec with EF: per step (loss, FA weights,
    parameters, active workers, the EF memory: this rank's shard when
    ``sharded``)."""
    codec, churn = case
    cfg, opt = _cfg(), sgd(momentum=0.9)
    tc = TrainConfig(aggregator=AGG, comm=CommConfig(codec=codec),
                     sharded_agg=sharded,
                     **(dict(faults=get_fault_schedule("churn", W))
                        if churn else {}))
    state = init_train_state(cfg, opt, params=np_params, comm=tc.comm,
                             workers=W, sharded=sharded or None)
    step = build_train_step(cfg, tc, opt, constant(1e-3))
    out = []
    for j, t in enumerate((5, 6) if churn else (0, 1)):
        batch = {k: torch.from_numpy(v) for k, v in _batch(23 + j).items()}
        m = step(state, batch, t)
        out.append((float(m["loss"]), m["fa_weights"].numpy().copy(),
                    state.flat.numpy().copy(),
                    m.get("active_workers", torch.tensor(W)).item(),
                    state.ef.numpy().copy()))
    return out


class _Kill(Exception):
    """Ends a launcher run from its step hook, as a crash would."""


def _ckpt_runs(root):
    """The launcher's sharded signSGD run with --ckpt-dir, uninterrupted
    (``root/full``) and killed after step 2 then resumed (``root/killed``):
    both histories, and the last step's parameters and EF shard."""
    last = {}

    def keep(name):
        def hook(t, state, m):
            if t == 3:
                last[name + "_state"] = (state.flat.numpy().copy(),
                                         state.ef.numpy().copy())
        return hook

    def kill(t, state, m):
        if t == 2:
            raise _Kill
    full = tlaunch.main(CKPT_ARGV + ["--ckpt-dir", f"{root}/full"],
                        on_step=keep("full"))
    try:
        tlaunch.main(CKPT_ARGV + ["--ckpt-dir", f"{root}/killed"],
                     on_step=kill)
    except _Kill:
        pass
    dist.barrier()
    resumed = tlaunch.main(CKPT_ARGV + ["--ckpt-dir", f"{root}/killed"],
                           on_step=keep("resumed"))
    return {"full": full, "resumed": resumed, **last}


def _stack(seed, W_=9):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.normal(size=(W_, 900 + 77 + 1)).astype(
        np.float32)), (900, 77, 1)


def _rank(rank, np_params, ckpt_root):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    try:
        mesh = make_host_mesh()
        out = {}
        if mesh.size == 2:
            out["ckpt"] = _ckpt_runs(ckpt_root)
        # the world of 4 is the mesh (2, 2): the rules that would split
        # the model over ``model`` are overridden, so every rank holds the
        # whole model and its loss is the unsharded forward's bits
        # (tensor parallelism: tests/test_torch_tp_train.py)
        with use_sharding(mesh, REPLICATED if mesh.size == 4 else None):
            for case in CASES:
                step_idx = 5 if case == "churn" else 0
                out[case] = _one_step(np_params, case, True, step_idx)
            for case in CODEC_CASES:
                out[case] = _codec_steps(np_params, case, True)
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
def ckpt_root(tmp_path_factory):
    return str(tmp_path_factory.mktemp("sharded_ckpt"))


@pytest.fixture(scope="module")
def worlds(np_params, ckpt_root):
    cache = {}

    def get(R):
        if R not in cache:
            cache[R] = spawn(_rank, R, np_params, ckpt_root,
                             timeout=SPAWN_TIMEOUT)
        return cache[R]
    return get


@pytest.fixture(scope="module")
def unsharded(np_params):
    out = {case: _one_step(np_params, case, False,
                           5 if case == "churn" else 0) for case in CASES}
    out.update({case: _codec_steps(np_params, case, False)
                for case in CODEC_CASES})
    return out


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


@pytest.fixture(scope="module")
def jax_codec_step(np_params):
    """JAX's step (the setting of ``jax_step``) under signSGD and top-k
    with EF, from zero memory: loss, FA weights, parameters, the new EF
    memory as (W, N)."""
    import jax
    import jax.numpy as jnp
    from repro.comm import compressors as jcomp
    from repro.comm import init_ef as jinit_ef
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
    out = {}
    for codec in ("signsgd", "topk"):
        tc = JTrainConfig(aggregator=JAgg(name="flag", flag=JFlag(
            lam=0.0, regularizer="none", tol=0.0)),
            comm=jcomp.CommConfig(codec=codec))
        step = jax.jit(jbuild(jcfg, tc, opt, jconstant(1e-3)))
        p, _, m, ef = step(params, opt.init(params),
                           jax.tree.map(jnp.asarray, _batch()),
                           jax.random.PRNGKey(1), jnp.zeros((), jnp.int32),
                           jinit_ef(params, W))
        out[codec] = (float(m["loss"]), np.asarray(m["fa_weights"]),
                      np.concatenate([np.asarray(x).reshape(-1)
                                      for x in jax.tree.leaves(p)]),
                      np.concatenate([np.asarray(x).reshape(W, -1)
                                      for x in jax.tree.leaves(ef)], 1))
    return out


def _whole_ef(res, step: int, key) -> np.ndarray:
    """The ranks' EF shards after ``step`` put back into (W, N)."""
    from repro_torch.dist.sharding import CoordShards
    sizes = tuple(int(n) for n in _layout_sizes())
    shards = CoordShards(sizes, len(res))
    return np.stack([shards.gather(torch.from_numpy(np.stack(
        [r[key][step][4][w] for r in res])), torch.empty(sum(sizes))).numpy()
        for w in range(W)])


def _layout_sizes():
    from repro_torch.models.transformer import param_shapes_tree
    from repro_torch.weights import layout_of
    return layout_of(param_shapes_tree(_cfg())).sizes


def _rel_norm(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


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


def test_sharded_config_rejects_an_unknown_codec():
    from repro_torch.dist.train_step import check_train_config
    for codec in ("countsketch", "signsgd", "topk", "identity"):
        check_train_config(TrainConfig(sharded_agg=True,
                                       comm=CommConfig(codec=codec)))
    with pytest.raises(KeyError, match="unknown codec"):
        check_train_config(TrainConfig(sharded_agg=True,
                                       comm=CommConfig(codec="zstd")))


@pytest.mark.parametrize("case", CODEC_CASES,
                         ids=[f"{c}{'-churn' if ch else ''}"
                              for c, ch in CODEC_CASES])
@pytest.mark.parametrize("R", [2, 3, 4])
def test_sharded_codec_steps_match_port_unsharded(R, case, worlds,
                                                  unsharded):
    """Two steps with EF: every rank's EF memory is its (W, width) shard;
    step 0 as the unsharded step (the EF shard: top-k bit for bit,
    signSGD within atol 1e-6 of its largest entry), step 1 from the
    reassociated parameters (module docstring)."""
    from repro_torch.dist.sharding import CoordShards
    res = worlds(R)
    sizes = tuple(int(n) for n in _layout_sizes())
    shards = CoordShards(sizes, R)
    for r in res:
        for step in r[case]:
            assert step[4].shape == (W, shards.width)
            assert shards.width < sum(sizes) or R == 1
    for r in res[1:]:
        for a, b in zip(r[case], res[0][case]):
            assert a[0] == b[0] and a[3] == b[3]
            np.testing.assert_array_equal(a[1], b[1])
            np.testing.assert_array_equal(a[2], b[2])
    u = unsharded[case]
    for t in (0, 1):
        loss, c, flat, active, _ = res[0][case][t]
        u_loss, u_c, u_flat, u_active, u_ef = u[t]
        assert active == u_active and np.isfinite(loss)
        if t == 0:
            assert loss == u_loss
        else:
            np.testing.assert_allclose(loss, u_loss, rtol=1e-6)
        np.testing.assert_allclose(c, u_c, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(flat, u_flat, rtol=1e-4, atol=1e-5)
        ef = _whole_ef(res, t, case)
        if t == 0:
            np.testing.assert_allclose(
                ef, u_ef, rtol=0,
                atol=0 if case[0] == "topk" else 1e-6 * np.abs(u_ef).max())
        else:
            assert _rel_norm(ef, u_ef) < 5e-2
    if case[1]:
        assert res[0][case][0][3] == W - 1


@pytest.mark.parametrize("codec", ["signsgd", "topk"])
@pytest.mark.parametrize("R", [2, 3, 4])
def test_sharded_codec_step_matches_jax(R, codec, worlds, jax_codec_step):
    res = worlds(R)
    loss, c, flat, _, _ = res[0][(codec, False)][0]
    j_loss, j_c, j_flat, j_ef = jax_codec_step[codec]
    np.testing.assert_allclose(loss, j_loss, rtol=1e-6)
    np.testing.assert_allclose(c, j_c, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(flat, j_flat, rtol=1e-4, atol=1e-5)
    assert _rel_norm(_whole_ef(res, 0, (codec, False)), j_ef) < 5e-2


def test_sharded_checkpoint_kill_and_resume(worlds, ckpt_root):
    """The world of 2: the resumed run's steps 2-3, final parameters and
    EF shards, and its step-4 file, equal the uninterrupted run's."""
    res = worlds(2)
    for r in res:
        ck = r["ckpt"]
        assert [h["step"] for h in ck["full"]] == [0, 1, 2, 3]
        assert [h["step"] for h in ck["resumed"]] == [2, 3]
        for a, b in zip(ck["resumed"], ck["full"][2:]):
            for k in ("loss", "lr", "grad_global_norm", "fa_weights",
                      "comm_bits"):
                assert a[k] == b[k], k
        for a, b in zip(ck["resumed_state"], ck["full_state"]):
            np.testing.assert_array_equal(a, b)
    files = [np.load(f"{ckpt_root}/{d}/step_00000004/state_0.npz")
             for d in ("full", "killed")]
    assert sorted(files[0].files) == sorted(files[1].files)
    for k in files[0].files:
        np.testing.assert_array_equal(files[0][k], files[1][k], err_msg=k)


def test_sharded_checkpoint_loads_unsharded_and_in_jax(worlds, ckpt_root):
    """The sharded run's step-4 file is the one-device format: it loads
    into the port's unsharded state (the EF a (W, N) buffer) and into
    JAX's launcher template with the bits of the ranks' parameters and EF
    shards."""
    import jax
    from repro.checkpoint import load_checkpoint as jax_load
    from repro.comm import init_ef as jinit_ef
    from repro.configs import get_config as jget, reduce_for_smoke as jred
    from repro.models import transformer as jtransformer
    from repro.optim import adamw as jadamw
    from repro_torch.checkpoint import load_checkpoint
    from repro_torch.dist.sharding import CoordShards
    from repro_torch.dist.train_step import train_state_tree
    res = worlds(2)
    flat = res[0]["ckpt"]["resumed_state"][0]
    sizes = tuple(int(n) for n in _layout_sizes())
    shards = CoordShards(sizes, 2)
    ef = np.stack([shards.gather(torch.from_numpy(np.stack(
        [r["ckpt"]["resumed_state"][1][w] for r in res])),
        torch.empty(sum(sizes))).numpy() for w in range(W)])
    d = f"{ckpt_root}/killed"
    state = init_train_state(_cfg(), adamw(), seed=3,
                             comm=CommConfig(codec="signsgd"), workers=W)
    _, step = load_checkpoint(d, train_state_tree(state))
    assert step == 4 and state.ef.shape == (W, sum(sizes))
    np.testing.assert_array_equal(state.flat.numpy(), flat)
    np.testing.assert_array_equal(state.ef.numpy(), ef)
    jcfg = jred(jget("smollm-360m")).replace(frontend=None,
                                             num_prefix_embeds=0)
    params = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    template = (params, jadamw().init(params), jinit_ef(params, W))
    (jp, _, jef), step = jax_load(d, template)
    assert step == 4
    np.testing.assert_array_equal(np.concatenate(
        [np.asarray(x).reshape(-1) for x in jax.tree.leaves(jp)]), flat)
    np.testing.assert_array_equal(np.concatenate(
        [np.asarray(x).reshape(W, -1) for x in jax.tree.leaves(jef)], 1),
        ef)


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
