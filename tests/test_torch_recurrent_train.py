"""The recurrent architectures' training state against the JAX package:
one FA train step (``repro.dist.train_step``) on the reduced xlstm-1.3b
and recurrentgemma-9b from the same weights and tokens; their train
states saved by the port and loaded by ``repro.checkpoint`` and the other
way round, bit for bit; and the train launcher's ``--ckpt-dir`` resume on
``--arch xlstm-1.3b``, equal to the uninterrupted run.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.core.flag import FlagConfig as JFlagConfig
from repro.dist.aggregation import AggregatorConfig as JAggregatorConfig
from repro.dist.train_step import TrainConfig as JTrainConfig
from repro.dist.train_step import build_train_step as jax_build_train_step
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.checkpoint import (checkpoint_meta, latest_step, leaf_keys,
                                    load_checkpoint, save_checkpoint)
from repro_torch.checkpoint.checkpoint import keystr
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.flag import FlagConfig
from repro_torch.dist.aggregation import AggregatorConfig
from repro_torch.dist.train_step import (TrainConfig, build_train_step,
                                         init_train_state, train_state_tree)
from repro_torch.launch import train as tlaunch
from repro_torch.optim import adamw, sgd, warmup_cosine
from repro_torch.weights import leaf_items, params_to_numpy

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ARCHS = ("xlstm-1.3b", "recurrentgemma-9b")
W, B, S, F = 6, 2, 16, 1


def _cfgs(arch):
    return (jax_reduce(jax_get_config(arch)),
            reduce_for_smoke(get_config(arch)))


@pytest.mark.parametrize("arch", ARCHS)
def test_fa_train_step_matches_jax(arch):
    """One step of the whole pipeline (per-worker grads, sign_flip on
    f = 1 of W = 6, flag with lambda = W, SGD) from JAX's weights on the
    same tokens.  Tolerances as tests/test_torch_train.py states them: the
    loss rtol 1e-5 (an fp32 forward), the FA weights rtol 5e-3 / atol
    5e-4 (eigensolvers differ), grad_global_norm rtol 1e-3 (fp32 sums in
    another order), each parameter within 1 % of the largest change JAX
    made to any parameter plus 2 ulp of the parameter."""
    jcfg, tcfg = _cfgs(arch)
    jparams = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    np_params = jax.tree.map(np.asarray, jparams)
    lam = float(W)
    jtc = JTrainConfig(aggregator=JAggregatorConfig(
        name="flag", f=F, flag=JFlagConfig(lam=lam), impl="xla"),
        attack="sign_flip", attack_f=F, attn_impl="xla")
    ttc = TrainConfig(aggregator=AggregatorConfig(
        name="flag", f=F, flag=FlagConfig(lam=lam)),
        attack="sign_flip", attack_f=F)
    jstep = jax.jit(jax_build_train_step(
        jcfg, jtc, jsgd(momentum=0.9), jwarmup_cosine(0.05, 8, 1)))
    tstep = build_train_step(tcfg, ttc, sgd(momentum=0.9),
                             warmup_cosine(0.05, 8, 1))
    state = init_train_state(tcfg, sgd(momentum=0.9), params=np_params)
    toks = np.random.default_rng(31).integers(0, 512, (W, B, S + 1),
                                              dtype=np.int32)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    jnew, _, jm = jstep(jparams, jsgd(momentum=0.9).init(jparams),
                        jax.tree.map(jnp.asarray, batch),
                        jax.random.PRNGKey(1), jnp.asarray(1, jnp.int32))
    tm = tstep(state, {k: torch.from_numpy(v) for k, v in batch.items()}, 1)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(tm["fa_weights"].numpy(),
                               np.asarray(jm["fa_weights"]), rtol=5e-3,
                               atol=5e-4)
    np.testing.assert_allclose(float(tm["grad_global_norm"]),
                               float(jm["grad_global_norm"]), rtol=1e-3)
    moved = max(np.abs(np.asarray(b) - p0).max() for b, p0 in zip(
        jax.tree.leaves(jnew), jax.tree.leaves(np_params)))
    assert moved > 0
    for a, b in zip(jax.tree.leaves(params_to_numpy(state.params)),
                    jax.tree.leaves(jnew), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), rtol=2 ** -22,
                                   atol=1e-2 * moved)


# ---------------------------------------------------------------------------
# checkpoints on the new trees, both directions, bit for bit
# ---------------------------------------------------------------------------

def _bits(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.uint16).numpy()
    return t.numpy()


def _jax_keyed(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.mark.parametrize("arch", ARCHS)
def test_port_save_loads_in_jax(tmp_path, arch):
    """A random AdamW train state of the port, saved, fills JAX's template
    (``(params, adamw state)``) bit for bit with JAX's leaf keys."""
    jcfg, tcfg = _cfgs(arch)
    state = init_train_state(tcfg, adamw(), seed=0)
    rng = np.random.default_rng(41)
    with torch.no_grad():
        state.flat.copy_(torch.tensor(rng.normal(size=state.flat.shape)))
        for v in state.opt_state.values():
            v.copy_(torch.tensor(rng.normal(size=v.shape)) if v.dim()
                    else torch.tensor(int(rng.integers(1, 1000))))
    tree = train_state_tree(state)
    save_checkpoint(str(tmp_path), 7, tree)
    params = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    template = (params, jadamw().init(params))
    assert checkpoint_meta(str(tmp_path))["keys"] == sorted(
        _jax_keyed(template)) == leaf_keys(tree)
    out, step = jax_load(str(tmp_path), template)
    assert step == 7
    got = _jax_keyed(out)
    for p, leaf in leaf_items(tree):
        k = keystr(p)
        assert got[k].dtype == _bits(leaf).dtype, k
        np.testing.assert_array_equal(got[k], _bits(leaf), err_msg=k)


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_save_loads_in_port(tmp_path, arch):
    """A random state saved by JAX in its layout restores into the port's
    flat storage bit for bit, in canonical order, in place."""
    jcfg, tcfg = _cfgs(arch)
    params = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    template = (params, jadamw().init(params))
    rng = np.random.default_rng(42)
    leaves, treedef = jax.tree.flatten(template)
    filled = jax.tree.unflatten(treedef, [
        jnp.asarray(rng.integers(1, 1000, x.shape), x.dtype)
        if x.dtype == jnp.int32 else
        jnp.asarray(rng.normal(size=x.shape), x.dtype) for x in leaves])
    jax_save(str(tmp_path), 3, filled)
    state = init_train_state(tcfg, adamw(), seed=5)
    ptr = state.flat.data_ptr()
    _, step = load_checkpoint(str(tmp_path), train_state_tree(state))
    assert step == 3 and state.flat.data_ptr() == ptr

    def flat_of(tree):
        return np.concatenate([np.asarray(x).reshape(-1)
                               for x in jax.tree.leaves(tree)])
    np.testing.assert_array_equal(state.flat.numpy(), flat_of(filled[0]))
    for k in ("mu", "nu"):
        np.testing.assert_array_equal(state.opt_state[k].numpy(),
                                      flat_of(filled[1][k]))
    assert int(state.opt_state["count"]) == int(filled[1]["count"])


class _Killed(Exception):
    pass


def _argv(d, steps=4):
    return ["--arch", "xlstm-1.3b", "--debug", "--device", "cpu",
            "--workers", "4", "--seq", "16", "--per-worker-batch", "1",
            "--steps", str(steps), "--ckpt-dir", str(d), "--ckpt-every", "2",
            "--log-every", "100"]


def test_launcher_resumes_xlstm(tmp_path, capsys):
    """``launch.train --arch xlstm-1.3b --debug --device cpu --ckpt-dir``
    killed after the step-2 checkpoint resumes from step 2, and steps 2-3
    and the final checkpoint equal the uninterrupted run's exactly."""
    full = tlaunch.main(_argv(tmp_path / "a"))

    def kill_after_step_1(t, state, m):
        if t == 1:
            raise _Killed
    with pytest.raises(_Killed):
        tlaunch.main(_argv(tmp_path / "b"), on_step=kill_after_step_1)
    assert latest_step(str(tmp_path / "b")) == 2
    capsys.readouterr()
    resumed = tlaunch.main(_argv(tmp_path / "b"))
    assert "resumed from step 2" in capsys.readouterr().out
    assert [r["step"] for r in resumed] == [2, 3]
    for k in ("loss", "lr", "grad_global_norm", "fa_weights"):
        assert [r[k] for r in resumed] == [r[k] for r in full[2:]], k
    with np.load(tmp_path / "a" / "step_00000004" / "state_0.npz") as za, \
            np.load(tmp_path / "b" / "step_00000004" / "state_0.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)
