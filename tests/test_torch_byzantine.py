"""Port parity for the paper's CNN training loop (``launch/byzantine.py``)
against ``benchmarks/common.py``: single steps chained from the same
weights on the same draws (the whole loop is held against JAX in
``test_torch_byzantine_loop.py``), the config, the CLI and the unknown
codec's refusal (the codec route: ``test_torch_train_comm.py``).

The JAX side is built from ``benchmarks.common``'s own functions
(``cnn_loss``, ``_flatten``, ``_unflatten_like``) and the JAX package's
``apply_attack`` and flat aggregators, with FA-N for ``flag`` as the
driver configures it.  Its images come from ``jax.random`` along the
driver's key chain; the port is given the same arrays.

Tolerances: the gradient matrix to 1e-6 of its largest entry at the
first step (the same parameters: fp32 sums in another order,
``test_torch_cnn.py``; 3.7e-7 seen), and to 1e-2 of it at later steps,
whose parameters agree only to the parameter tolerance below: 1 % of a
step apart, so G may be 1 % of what one step moves it apart, and one step
moves G by up to 0.9 of max |G| in these runs (flag, the loosest, was
8.1e-4 apart at step 3, the others under 1e-6);
d to the FA tolerance, rtol 5e-3 / atol 5e-4 of d normalised by its norm
(``tests/test_properties.py:114``; every rule is held to it, the picks
below hold the selections exactly); Krum's and Bulyan's picks equal; each
parameter within 1 % of the largest change JAX made to any parameter
(``tests/test_torch_train.py``'s rule).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from repro.core import aggregators as jagg
from repro.core.attacks import apply_attack as japply_attack
from repro.core.flag import FlagConfig as JFlagConfig
from repro.data.synthetic import SyntheticImages as JSyntheticImages
from repro_torch.core import aggregators as tagg
from repro_torch.launch import byzantine
from repro_torch.launch.byzantine import (ByzRunConfig, byzantine_step,
                                          run_byzantine_training)
from repro_torch.weights import pack

P, F, B, STEPS, LR = 7, 1, 8, 3, 0.05


def _jax_draws(p: int, batch: int, steps: int, seed: int = 0):
    """The images and labels ``run_byzantine_training`` draws at each step
    (its key chain) with the attack's key, and the test set, as numpy
    arrays."""
    task = JSyntheticImages(seed=seed)
    sample = jax.jit(jax.vmap(lambda k: task.sample(k, batch)))
    key = jax.random.PRNGKey(seed + 1)
    out = []
    for _ in range(steps):
        key, k = jax.random.split(key)
        ks = jax.random.split(k, p + 2)
        xs, ys = sample(ks[:p])
        out.append((np.asarray(xs), np.asarray(ys), ks[-1]))
    xt, yt = task.test_set(1024)
    return out, (np.asarray(xt), np.asarray(yt))


@pytest.fixture(scope="module")
def setup():
    params = jcommon.cnn_init(jax.random.PRNGKey(0))
    draws, _ = _jax_draws(P, B, STEPS)
    grads = jax.jit(jax.vmap(
        lambda pr, x, y: jcommon._flatten(jax.grad(jcommon.cnn_loss)(
            pr, x, y)), in_axes=(None, 0, 0)))
    return params, draws, grads


def _jax_rule(agg: str, p: int, f: int):
    fn = jagg.get_aggregator(agg)
    if agg == "flag":
        return fn, {"cfg": JFlagConfig(lam=float(p), norm_mode="clip",
                                       renormalize=True)}
    return fn, {"f": f}


def _picks(agg: str, G, f: int, lib) -> list[int]:
    D = lib.pairwise_sq_dists(G)
    if agg == "krum":
        return [int(np.argmin(np.asarray(lib.krum_scores(D, f))))]
    if agg == "bulyan":
        return [int(i) for i in np.asarray(lib.bulyan_select(D, f))]
    return []


def _close_fa(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.linalg.norm(want) + 1e-12
    np.testing.assert_allclose(got / scale, want / scale, rtol=5e-3,
                               atol=5e-4, err_msg=what)


@pytest.mark.parametrize("attack", ["none", "sign_flip"])
@pytest.mark.parametrize("agg", ["flag", "krum", "mean", "median", "bulyan"])
def test_steps_match_jax(setup, agg, attack):
    """Three chained steps (p = 7, f = 1, batch 8) from JAX's weights on
    JAX's draws: G, d, the picks and the parameters after every step."""
    jparams, draws, jgrads = setup
    fn, kw = _jax_rule(agg, P, F)
    theta, layout = pack({k: np.asarray(v) for k, v in jparams.items()})
    theta0 = theta.clone()
    mom = torch.zeros_like(theta)
    jmom = jnp.zeros(theta.shape[0], jnp.float32)
    cfg = ByzRunConfig(p=P, f=F, batch=B, attack=attack, aggregator=agg)
    rule = byzantine.aggregator_for(cfg)
    for t, (xs, ys, kattack) in enumerate(draws):
        Gj = japply_attack(attack, jgrads(jparams, xs, ys), kattack, F)
        dj = fn(Gj, **kw)
        jmom = 0.9 * jmom + dj
        jparams = jax.tree.map(lambda a, b: a - LR * b, jparams,
                               jcommon._unflatten_like(jparams, jmom))
        G, d = byzantine_step(theta, mom, layout, torch.tensor(xs),
                              torch.tensor(ys), cfg=cfg, step=t, lr=LR,
                              rule=rule)
        Gj, dj = np.asarray(Gj), np.asarray(dj)
        np.testing.assert_allclose(G.numpy(), Gj, rtol=0,
                                   atol=(1e-6 if t == 0 else 1e-2)
                                   * np.abs(Gj).max(),
                                   err_msg=f"G, step {t}")
        assert _picks(agg, G, F, tagg) == _picks(agg, jnp.asarray(Gj), F,
                                                 jagg), f"picks, step {t}"
        _close_fa(d.numpy(), dj, f"d, step {t}")
        want = np.asarray(jcommon._flatten(jparams))
        change = np.abs(want - theta0.numpy()).max()
        np.testing.assert_allclose(theta.numpy(), want, rtol=0,
                                   atol=0.01 * change,
                                   err_msg=f"parameters, step {t}")


def test_config_fields_and_defaults_match_jax():
    jf = dataclasses.fields(jcommon.ByzRunConfig)
    tf = dataclasses.fields(ByzRunConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    j, t = jcommon.ByzRunConfig(), ByzRunConfig()
    assert all(getattr(t, f.name) == getattr(j, f.name) for f in tf)


def test_codecs_raise():
    """Every codec of the registry runs (test_torch_train_comm.py); an
    unknown one raises before the first step, listing the registry."""
    with pytest.raises(KeyError, match="unknown codec 'zstd'.*countsketch"):
        run_byzantine_training(ByzRunConfig(codec="zstd", steps=1),
                               device="cpu")


def test_augmented_workers_are_the_honest_ones(monkeypatch):
    """f <= w < f + augment_workers augment (benchmarks/common.py:156),
    not the pipeline's first k."""
    seen = []
    real = byzantine.augment_lib.augment_batch

    def spy(gen, x, **kw):
        seen.append(x.clone())
        return real(gen, x, **kw)
    monkeypatch.setattr(byzantine.augment_lib, "augment_batch", spy)
    gen = torch.Generator().manual_seed(0)
    xs = torch.rand((6, 2, 32, 32, 3), generator=gen)
    cfg = ByzRunConfig(p=6, f=2, augment_scheme="cat_map", augment_workers=3,
                       gaussian_sigma=0.0)
    out = byzantine._augment(torch.Generator(), xs.clone(), cfg)
    assert len(seen) == 1 and torch.equal(seen[0], xs[2:5])
    assert torch.equal(out[:2], xs[:2]) and torch.equal(out[5:], xs[5:])
    assert not torch.equal(out[2:5], xs[2:5])


def test_cli_runs_on_the_cpu(capsys):
    out = byzantine.main(["--device", "cpu", "--p", "4", "--f", "1",
                          "--batch", "2", "--steps", "3", "--eval-every",
                          "2", "--aggregator", "multi_krum", "--attack",
                          "sign_flip", "--attack-kw", '{"scale": 5.0}',
                          "--flag-cfg", '{"lam": 2.0}'])
    assert out["config"]["attack_kw"] == {"scale": 5.0}
    assert out["config"]["flag_cfg"]["lam"] == 2.0
    assert [s for s, _ in out["trajectory"]] == [2, 3]
    assert out["device"] == "cpu" and out["us_per_step"] > 0
    assert '"final_accuracy"' in capsys.readouterr().out.splitlines()[-1]
    flags = {a.dest for a in byzantine._parser()._actions}
    assert {f.name for f in dataclasses.fields(ByzRunConfig)} <= flags


def test_cuda_is_the_default_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        byzantine.main(["--steps", "1"])
