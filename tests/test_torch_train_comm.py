"""Port parity for the codec and membership paths end to end: the
reduced train step under each codec (error feedback carried across the
steps) and under worker churn, against ``repro.dist.train_step``; and
the CNN loop's codec route against ``benchmarks/common.py``'s.

Both packages start from the same weights and see the same numpy tokens
(or JAX's image draws); CountSketch runs with JAX's maps carried across
(the port's own are drawn from a CPU generator, test_torch_comm.py).

Tolerances.  The exact codecs (identity, and CountSketch: a sum of signed
coordinates in another order) keep the rules of test_torch_train.py: the
loss rtol 1e-5, the FA weights rtol 5e-3 / atol 5e-4, each parameter
within 1 % of the largest change JAX made (plus 2 ulp).  The biased
codecs are discontinuous in their input: a coordinate whose h = g + e is
within rounding of 0 (signSGD) or of the k-th largest |h| of its leaf
(top-k) decodes to another value when the two packages' gradients differ
in their last bits, and the error-feedback memory carries the difference
to the next step.  So there each parameter is held within the largest
change, the parameters in norm within 2 % of the displacement JAX made,
and the EF memory in norm within 5 % of its own norm (perturbing the
port's own initial weights by one ulp moves its signSGD run by a
comparable share of the displacement after one step).  The loss stays within rtol 1e-5 (it is computed before
the step's update).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from repro.comm import compressors as jcomp
from repro.comm import init_ef as jax_init_ef
from repro.core.attacks import apply_attack as japply_attack
from repro.core.flag import FlagConfig as JFlagConfig
from repro.dist import membership as jmem
from repro.dist.aggregation import AggregatorConfig as JAggregatorConfig
from repro.dist.aggregation import compressed_aggregate as jax_compressed
from repro.dist.train_step import TrainConfig as JTrainConfig
from repro.dist.train_step import build_train_step as jax_build_train_step
from repro.optim import sgd as jsgd
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch.comm import CommConfig, init_ef
from repro_torch.comm import compressors as tcomp
from repro_torch.core.flag import FlagConfig
from repro_torch.dist import membership as tmem
from repro_torch.dist.aggregation import AggregatorConfig
from repro_torch.dist.train_step import (TrainConfig, build_train_step,
                                         init_train_state)
from repro_torch.launch import byzantine
from repro_torch.launch.byzantine import ByzRunConfig, byzantine_step
from repro_torch.optim import sgd, warmup_cosine
from repro_torch.weights import pack
from tests.test_torch_byzantine import _jax_draws
from tests.test_torch_train import _jax_cfg, _port_cfg, _tokens

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

BIASED = ("signsgd", "topk")


def _carry_jax_maps(monkeypatch, jcodec) -> None:
    """Every port CountSketch codec draws JAX's maps."""
    def maps(self, n, i):
        b, s = jcodec._maps(n, i)
        return torch.tensor(np.asarray(b)), torch.tensor(np.asarray(s))
    monkeypatch.setattr(tcomp.CountSketchCodec, "_maps", maps)


def _flat_leaves(tree, lead: int = 0) -> np.ndarray:
    leaves = jax.tree.leaves(tree)
    if lead:
        return np.concatenate([np.asarray(x).reshape(lead, -1)
                               for x in leaves], axis=1)
    return np.concatenate([np.asarray(x).reshape(-1) for x in leaves])


W, B, S, F = 8, 2, 16, 2
# (rule, codec, faults): every codec under flag (the other rules' routes
# are held on identical gradients in test_torch_comm.py); signSGD with EF
# under a crash at step 2 and under churn with period 2 (worker 0 out for
# steps 0-1, worker 1 for 2-3: a leave and a rejoin inside steps 1-3)
STEP_CASES = [("flag", "identity", None), ("flag", "signsgd", None),
              ("flag", "topk", None), ("flag", "countsketch", None),
              ("flag", "signsgd", ("crash", {"at": 2})),
              ("flag", "signsgd", ("churn", {"period": 2}))]


@pytest.fixture(scope="module")
def jax_smoke_params():
    from repro.models import transformer as jtransformer
    params = jtransformer.init_params(jax.random.PRNGKey(0), _jax_cfg(True))
    return jax.tree.map(np.asarray, params)


@pytest.mark.parametrize("agg,codec,faults", STEP_CASES,
                         ids=[f"{a}-{c}-{f[0] if f else 'none'}"
                              for a, c, f in STEP_CASES])
def test_train_step_with_codec_matches_jax(agg, codec, faults,
                                           jax_smoke_params, monkeypatch):
    """Three steps (sign_flip on f = 2 of W = 8, lambda = W, SGD): loss,
    FA weights, comm_bits / comm_ratio, the parameters and the EF memory
    after every step; under faults the active count and staleness."""
    jcomm = jcomp.CommConfig(codec=codec)
    comm = CommConfig(codec=codec)
    if codec == "countsketch":
        _carry_jax_maps(monkeypatch, jcomp.get_codec(jcomm))
    name, kw = faults or ("none", {})
    jtc = JTrainConfig(aggregator=JAggregatorConfig(
        name=agg, f=F, flag=JFlagConfig(lam=float(W)), impl="xla"),
        attack="sign_flip", attack_f=F, attn_impl="xla", comm=jcomm,
        faults=jmem.get_fault_schedule(name, W, **kw))
    ttc = TrainConfig(aggregator=AggregatorConfig(
        name=agg, f=F, flag=FlagConfig(lam=float(W))),
        attack="sign_flip", attack_f=F, comm=comm,
        faults=tmem.get_fault_schedule(name, W, **kw))
    jstep = jax.jit(jax_build_train_step(
        _jax_cfg(True), jtc, jsgd(momentum=0.9), jwarmup_cosine(0.05, 8, 1)))
    tstep = build_train_step(_port_cfg(True), ttc, sgd(momentum=0.9),
                             warmup_cosine(0.05, 8, 1))
    jparams = jax.tree.map(jnp.asarray, jax_smoke_params)
    jopt_state = jsgd(momentum=0.9).init(jparams)
    jef = jax_init_ef(jparams, W) if jcomm.wants_ef else None
    state = init_train_state(_port_cfg(True), sgd(momentum=0.9),
                             params=jax_smoke_params, comm=comm, workers=W)
    assert (state.ef is None) == (jef is None)
    p0 = _flat_leaves(jax_smoke_params)
    biased = codec in BIASED
    for t in (1, 2, 3):
        batch = _tokens(100 + t, (W, B), S)
        args = (jparams, jopt_state, jax.tree.map(jnp.asarray, batch),
                jax.random.PRNGKey(t), jnp.asarray(t, jnp.int32))
        if jef is None:
            jparams, jopt_state, jm = jstep(*args)
        else:
            jparams, jopt_state, jm, jef = jstep(*args, jef)
        tm = tstep(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                   t)
        what = f"step {t}"
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-5, err_msg=what)
        np.testing.assert_allclose(tm["fa_weights"].numpy(),
                                   np.asarray(jm["fa_weights"]), rtol=5e-3,
                                   atol=5e-4, err_msg=what)
        for k in ("comm_bits", "comm_ratio"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)
        if faults:
            assert int(tm["active_workers"]) == int(jm["active_workers"])
            np.testing.assert_array_equal(tm["worker_staleness"].numpy(),
                                          np.asarray(jm["worker_staleness"]))
        want, got = _flat_leaves(jparams), state.flat.numpy()
        moved = np.abs(want - p0).max()
        np.testing.assert_allclose(got, want, rtol=2 ** -22,
                                   atol=(1.0 if biased else 1e-2) * moved,
                                   err_msg=what)
        if biased:
            off = np.linalg.norm(got - want) / np.linalg.norm(want - p0)
            assert off <= 2e-2, (what, off)
        if jef is not None:
            je = _flat_leaves(jef, W)
            off = np.linalg.norm(state.ef.numpy() - je) / np.linalg.norm(je)
            assert off <= 5e-2, (what, off)
    if faults and name == "churn":
        assert int(tm["active_workers"]) == W - 1


def test_init_train_state_sets_the_ef_memory(jax_smoke_params):
    s = init_train_state(_port_cfg(True), sgd(), params=jax_smoke_params,
                         comm=CommConfig(codec="signsgd"), workers=3)
    assert s.ef.shape == (3, s.layout.numel) and not bool(s.ef.any())
    assert init_train_state(_port_cfg(True), sgd(), params=jax_smoke_params,
                            comm=CommConfig(codec="countsketch")).ef is None
    with pytest.raises(ValueError, match="workers"):
        init_train_state(_port_cfg(True), sgd(), params=jax_smoke_params,
                         comm=CommConfig(codec="topk"))


def test_worker_influence_reads_the_pre_codec_norms(jax_smoke_params):
    """|c_i| ||g_i|| from the attacked gradients, not the decoded ones:
    under the mean (c uniform) signSGD's step gives the influence the
    uncompressed step gives, where the sign-flipping worker (10x its
    gradient) holds the largest share; decoded norms would differ."""
    batch = {k: torch.from_numpy(v) for k, v in _tokens(7, (4, B), S).items()}
    out = {}
    for codec in ("none", "signsgd"):
        tc = TrainConfig(aggregator=AggregatorConfig(name="mean"),
                         attack="sign_flip", attack_f=1,
                         comm=CommConfig(codec=codec))
        state = init_train_state(_port_cfg(True), sgd(),
                                 params=jax_smoke_params, comm=tc.comm,
                                 workers=4)
        out[codec] = build_train_step(_port_cfg(True), tc, sgd(),
                                      warmup_cosine(0.05, 8, 1))(
            state, batch, 1)["worker_influence"].numpy()
    np.testing.assert_allclose(out["signsgd"], out["none"], rtol=1e-6)
    assert out["none"][0] > 0.5 and abs(out["none"].sum() - 1) < 1e-6


# ---------------------------------------------------------------------------
# the CNN loop's codec route
# ---------------------------------------------------------------------------

P, FB, BATCH, LR = 7, 1, 8, 0.05


@pytest.fixture(scope="module")
def cnn_setup():
    params = jcommon.cnn_init(jax.random.PRNGKey(0))
    draws, _ = _jax_draws(P, BATCH, 3)
    grads = jax.jit(jax.vmap(
        lambda pr, x, y: jcommon._flatten(jax.grad(jcommon.cnn_loss)(
            pr, x, y)), in_axes=(None, 0, 0)))
    return params, draws, grads


@pytest.mark.parametrize("agg", ["flag", "mean"])
@pytest.mark.parametrize("codec", ["identity", "signsgd", "topk",
                                   "countsketch"])
def test_cnn_steps_with_codec_match_jax(cnn_setup, codec, agg, monkeypatch):
    """Three chained CNN steps (p = 7, f = 1 sign_flip, batch 8) through
    the codec route, against benchmarks/common.py's: the same
    compressed_aggregate call on the per-leaf tree, AggregatorConfig with
    FA-N, EF memory carried.  d to the FA tolerance over its norm, the
    parameters within 1 % of the largest change JAX made; under the biased
    codecs d to it in all but 1e-4 of its coordinates (one signSGD sign
    flip was seen at step 2) and within 2 % in norm, the parameters within
    the largest change and 2 % in norm, the EF memory within 5 % in norm.
    comm_bits and comm_ratio of the run as JAX's."""
    jparams, draws, jgrads = cnn_setup
    jcomm = jcomp.CommConfig(codec=codec)
    if codec == "countsketch":
        _carry_jax_maps(monkeypatch, jcomp.get_codec(jcomm))
    jcfg = JAggregatorConfig(name=agg, f=FB, flag=JFlagConfig(
        lam=float(P), norm_mode="clip", renormalize=True))
    cfg = ByzRunConfig(p=P, f=FB, batch=BATCH, attack="sign_flip",
                       aggregator=agg, codec=codec)
    rule = byzantine.aggregator_for(cfg)
    theta, layout = pack({k: np.asarray(v) for k, v in jparams.items()})
    theta0 = theta.clone()
    mom = torch.zeros_like(theta)
    jmom = jnp.zeros(theta.shape[0], jnp.float32)
    wants_ef = jcomm.wants_ef
    assert wants_ef == rule[1]["comm"].wants_ef
    ef = init_ef(theta, P) if wants_ef else None
    jef = jax_init_ef(jparams, P) if wants_ef else None
    biased = codec in BIASED
    for t, (xs, ys, kattack) in enumerate(draws):
        Gj = japply_attack("sign_flip", jgrads(jparams, xs, ys), kattack, FB)
        g_tree = jax.vmap(lambda v: jcommon._unflatten_like(jparams, v))(Gj)
        d_tree, _, jef = jax_compressed(g_tree, jcfg, jcomm, jef)
        dj = np.asarray(jcommon._flatten(d_tree))
        jmom = 0.9 * jmom + dj
        jparams = jax.tree.map(lambda a, b: a - LR * b, jparams,
                               jcommon._unflatten_like(jparams, jmom))
        _, d = byzantine_step(theta, mom, layout, torch.tensor(xs),
                              torch.tensor(ys), cfg=cfg, step=t, lr=LR,
                              rule=rule, ef=ef)
        what = f"step {t}"
        scale = np.linalg.norm(dj) + 1e-12
        if biased:
            # a decoded coordinate that flipped moves d there by a whole
            # decoded value: FA tolerance but for 1e-4 of d, 2 % in norm
            bad = np.abs(d.numpy() - dj) > 5e-4 * scale + 5e-3 * np.abs(dj)
            assert bad.sum() <= 1e-4 * dj.size, (what, int(bad.sum()))
            assert np.linalg.norm(d.numpy() - dj) <= 2e-2 * scale, what
        else:
            np.testing.assert_allclose(d.numpy() / scale, dj / scale,
                                       rtol=5e-3, atol=5e-4, err_msg=what)
        want = np.asarray(jcommon._flatten(jparams))
        change = np.abs(want - theta0.numpy()).max()
        np.testing.assert_allclose(theta.numpy(), want, rtol=0,
                                   atol=(1.0 if biased else 0.01) * change,
                                   err_msg=what)
        if biased:
            off = (np.linalg.norm(theta.numpy() - want)
                   / np.linalg.norm(want - theta0.numpy()))
            assert off <= 2e-2, (what, off)
        if wants_ef:
            je = _flat_leaves(jef, P)
            off = np.linalg.norm(ef.numpy() - je) / np.linalg.norm(je)
            assert off <= 5e-2, (what, off)
    jout = jcomp.get_codec(jcomm)
    like = jax.eval_shape(lambda: jax_init_ef(jparams, P))
    run = byzantine.run_byzantine_training(
        ByzRunConfig(p=P, f=FB, batch=BATCH, steps=1, codec=codec,
                     aggregator=agg), device="cpu")
    assert run["comm_bits_per_step"] == jout.bits(like)
    assert run["comm_ratio"] == jcomp.dense_bits(like) / jout.bits(like)
