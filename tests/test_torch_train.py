"""Port parity for the training path: parameter layout and weight
carry-over, the transformer loss, the optimizers and schedules, the data
task, and three whole train steps, each against the JAX package on the
same weights and the same numpy tokens (the smoke config computes in
fp32)."""

from __future__ import annotations

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.core.flag import FlagConfig as JFlagConfig
from repro.data.synthetic import SyntheticLM as JSyntheticLM
from repro.dist.aggregation import AggregatorConfig as JAggregatorConfig
from repro.dist.train_step import TrainConfig as JTrainConfig
from repro.dist.train_step import build_train_step as jax_build_train_step
from repro.models import transformer as jtransformer
from repro.optim import adamw as jadamw
from repro.optim import sgd as jsgd
from repro.optim import warmup_cosine as jwarmup_cosine
from repro_torch import device as tdevice
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.flag import FlagConfig
from repro_torch.data import SyntheticLM, WorkerDataConfig, lm_worker_batches
from repro_torch.dist.aggregation import AggregatorConfig
from repro_torch.dist.train_step import (TrainConfig, build_train_step,
                                         init_train_state)
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer
from repro_torch.optim import adamw, apply_updates, sgd, warmup_cosine
from repro_torch.weights import (leaf_items, params_from_jax,
                                 params_to_numpy)

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

SMOLLM_N = 361_821_120


def _jax_cfg(smoke: bool):
    cfg = jax_get_config("smollm-360m")
    if smoke:
        cfg = jax_reduce(cfg).replace(frontend=None, num_prefix_embeds=0)
    return cfg


def _port_cfg(smoke: bool):
    cfg = get_config("smollm-360m")
    return reduce_for_smoke(cfg) if smoke else cfg


def _key(k):
    return k.key if hasattr(k, "key") else k.idx


@pytest.fixture(scope="module")
def jax_smoke_params():
    params = jtransformer.init_params(jax.random.PRNGKey(0), _jax_cfg(True))
    return jax.tree.map(np.asarray, params)


# ---------------------------------------------------------------------------
# parameter layout and weight carry-over
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [False, True])
def test_leaf_order_matches_jax_tree_leaves(smoke):
    """The canonical order of repro_torch.weights is jax.tree.leaves order,
    leaf for leaf with equal shapes (fails if either tree changes)."""
    shapes = jax.eval_shape(
        lambda k: jtransformer.init_params(k, _jax_cfg(smoke)),
        jax.random.PRNGKey(0))
    want = [(tuple(_key(k) for k in path), tuple(leaf.shape))
            for path, leaf in jax.tree_util.tree_flatten_with_path(shapes)[0]]
    got = [(path, tuple(t.shape)) for path, t in
           leaf_items(transformer.param_shapes_tree(_port_cfg(smoke)))]
    assert got == want
    if not smoke:
        assert len(got) == 11
        assert sum(math.prod(s) for _, s in got) == SMOLLM_N
        assert _port_cfg(False).param_count() == SMOLLM_N


def test_params_round_trip(jax_smoke_params):
    params = params_from_jax(jax_smoke_params)
    back = params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(jax_smoke_params)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jax_smoke_params)):
        np.testing.assert_array_equal(a, b)
    # every leaf is a view of one flat vector, in canonical order
    leaves = [t for _, t in leaf_items(params)]
    base = leaves[0].untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base for t in leaves)
    offs = [t.storage_offset() for t in leaves]
    assert offs == sorted(offs)


def test_init_params_shapes_and_scales():
    cfg = _port_cfg(True)
    params = transformer.init_params(cfg, seed=3)
    p2 = transformer.init_params(cfg, seed=3)
    for (path, a), (_, b) in zip(leaf_items(params), leaf_items(p2)):
        assert torch.equal(a, b), path
    wq = params["body"][0]["mixer"]["wq"]["w"]
    assert wq.abs().max() <= 2.0 / math.sqrt(cfg.d_model) + 1e-6
    assert torch.equal(params["final_norm"]["scale"],
                       torch.ones(cfg.d_model))


# ---------------------------------------------------------------------------
# model, optimizers, schedules, data
# ---------------------------------------------------------------------------

def _tokens(seed: int, lead: tuple, S: int, vocab: int = 512):
    toks = np.random.default_rng(seed).integers(
        0, vocab, size=lead + (S + 1,)).astype(np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


# The dense family's other settings, all at once: LayerNorm, plain GELU
# MLP with biases, untied unembedding, logit softcap, partial RoPE and a
# sliding window shorter than the sequence.
VARIANT = dict(norm="layernorm", act="gelu", gated_mlp=False, use_bias=True,
               tie_embeddings=False, logit_softcap=30.0, rope_fraction=0.25,
               window=8)


@pytest.mark.parametrize("variant", [False, True])
def test_transformer_loss_matches_jax(variant, jax_smoke_params):
    """fp32 smoke config: the same loss and gradients up to fp32 rounding."""
    batch = _tokens(1, (2,), 24)
    jcfg, tcfg = _jax_cfg(True), _port_cfg(True)
    np_params = jax_smoke_params
    if variant:
        jcfg, tcfg = jcfg.replace(**VARIANT), tcfg.replace(**VARIANT)
        np_params = jax.tree.map(np.asarray, jtransformer.init_params(
            jax.random.PRNGKey(1), jcfg))

    def jloss(p):
        return jtransformer.forward(p, jax.tree.map(jnp.asarray, batch),
                                    jcfg)[0]
    want, jgrad = jax.value_and_grad(jloss)(
        jax.tree.map(jnp.asarray, np_params))
    params = params_from_jax(np_params)
    leaves = [t.requires_grad_(True) for _, t in leaf_items(params)]
    loss, metrics = transformer.forward(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want), rtol=1e-5)
    assert float(metrics["ppl_proxy"].detach()) == pytest.approx(
        math.exp(float(want)), rel=1e-4)
    for t, g in zip(leaves, jax.tree.leaves(jgrad)):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=1e-3,
                                   atol=1e-6 * np.abs(np.asarray(g)).max())


@pytest.mark.parametrize("which", ["adamw", "sgd"])
def test_optimizer_matches_jax(which):
    rng = np.random.default_rng(4)
    p = rng.normal(size=500).astype(np.float32)
    grads = [rng.normal(size=500).astype(np.float32) * 10 ** -k
             for k in range(3)]
    jopt = jadamw() if which == "adamw" else jsgd(momentum=0.9)
    topt = adamw() if which == "adamw" else sgd(momentum=0.9)
    jp, js = {"p": jnp.asarray(p)}, None
    js = jopt.init(jp)
    tp = torch.from_numpy(p.copy())
    ts = topt.init(tp)
    for g in grads:
        ju, js = jopt.update({"p": jnp.asarray(g)}, js, jp, 0.01)
        jp = jax.tree.map(lambda a, u: a + u, jp, ju)
        tu, ts = topt.update(torch.from_numpy(g), ts, tp, torch.tensor(0.01))
        apply_updates(tp, tu)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp["p"]), rtol=1e-6,
                               atol=1e-7)


def test_warmup_cosine_matches_jax():
    js, ts = jwarmup_cosine(3e-3, 40, warmup=8), warmup_cosine(3e-3, 40,
                                                               warmup=8)
    for step in range(45):
        assert float(ts(step)) == pytest.approx(
            float(js(jnp.asarray(step, jnp.int32))), rel=1e-6, abs=1e-12)


def test_synthetic_successor_table_matches_jax():
    """The hash runs in int32 with wraparound in both packages."""
    ctx = np.concatenate([np.arange(512), [2**31 - 1, 123456789,
                                           2**30 + 7]]).astype(np.int32)
    want = np.asarray(JSyntheticLM(vocab_size=49152)._succ(jnp.asarray(ctx)))
    got = SyntheticLM(vocab_size=49152)._succ(torch.from_numpy(ctx)).numpy()
    np.testing.assert_array_equal(got, want)


def test_lm_worker_batches_follow_the_chain():
    task = SyntheticLM(vocab_size=512)
    wdc = WorkerDataConfig(workers=3, per_worker_batch=2)
    b = lm_worker_batches(task, wdc, 4, 10)
    assert b["tokens"].shape == (3, 2, 10) and b["tokens"].dtype == torch.int32
    assert torch.equal(b["tokens"][..., 1:], b["labels"][..., :-1])
    succ = task._succ(b["tokens"])
    assert (succ == b["labels"][..., None]).any(-1).all()
    again = lm_worker_batches(task, wdc, 4, 10)
    assert torch.equal(again["tokens"], b["tokens"])
    assert not torch.equal(lm_worker_batches(task, wdc, 5, 10)["tokens"],
                           b["tokens"])


# ---------------------------------------------------------------------------
# whole train steps
# ---------------------------------------------------------------------------

W, B, S, F = 8, 2, 16, 2


@pytest.mark.parametrize("agg", ["flag", "mean", "krum", "median",
                                 "bulyan"])
def test_train_step_matches_jax(agg, jax_smoke_params):
    """Three steps of the full pipeline (per-worker grads, sign_flip on
    f = 2 of W = 8, aggregation with lambda = W, SGD) from the same weights
    on the same tokens.

    Tolerances: the loss is an fp32 forward (rtol 1e-5); the FA weights
    carry the FA tolerance rtol 5e-3 / atol 5e-4 (eigensolvers differ);
    grad_global_norm is an fp32 sum of 1.3e6 squares taken in another
    order (rtol 1e-3); each parameter may differ by 1 % of the largest
    change JAX made to any parameter (the update carries c's and the
    gradients' error) plus 2 ulp of the parameter (rtol 2**-22).  SGD
    keeps parameter differences proportional to the update differences,
    where AdamW's m / sqrt(v) would turn a rounding-level difference of a
    near-zero coordinate into an O(lr) step; the AdamW arithmetic itself
    is held to JAX in test_optimizer_matches_jax.

    Bulyan at W = 8, f = 2 keeps beta = max(theta - 2f, 1) = 1 of its
    theta = 4 picked values per coordinate: the one nearer the midpoint of
    the middle two, a tie in real arithmetic that the fp32 rounding of
    (a + b) * 0.5 decides.  Gradients that differ in their last bits
    between the packages flip that choice in ~20 % of the coordinates, each
    by up to lr * |a - b|.  What holds there: the picks (fa_weights)
    exactly, each parameter within the largest change JAX made (atol
    1 x moved; 0.89 x observed), the loss to rtol 5e-4 and
    grad_global_norm to rtol 5e-3.  Krum and the median have no such tie
    and keep the tolerances above.
    """
    tie = agg == "bulyan"
    lam = float(W)
    jtc = JTrainConfig(aggregator=JAggregatorConfig(
        name=agg, f=F, flag=JFlagConfig(lam=lam), impl="xla"),
        attack="sign_flip", attack_f=F, attn_impl="xla")
    ttc = TrainConfig(aggregator=AggregatorConfig(
        name=agg, f=F, flag=FlagConfig(lam=lam)),
        attack="sign_flip", attack_f=F)
    jstep = jax.jit(jax_build_train_step(
        _jax_cfg(True), jtc, jsgd(momentum=0.9), jwarmup_cosine(0.05, 8, 1)))
    tstep = build_train_step(_port_cfg(True), ttc, sgd(momentum=0.9),
                             warmup_cosine(0.05, 8, 1))
    jparams = jax.tree.map(jnp.asarray, jax_smoke_params)
    jopt_state = jsgd(momentum=0.9).init(jparams)
    state = init_train_state(_port_cfg(True), sgd(momentum=0.9),
                             params=jax_smoke_params)
    for t in (1, 2, 3):
        batch = _tokens(100 + t, (W, B), S)
        jparams, jopt_state, jm = jstep(
            jparams, jopt_state, jax.tree.map(jnp.asarray, batch),
            jax.random.PRNGKey(t), jnp.asarray(t, jnp.int32))
        tm = tstep(state, {k: torch.from_numpy(v) for k, v in batch.items()},
                   t)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=5e-4 if tie else 1e-5)
        np.testing.assert_allclose(tm["fa_weights"].numpy(),
                                   np.asarray(jm["fa_weights"]),
                                   rtol=0 if tie else 5e-3,
                                   atol=0 if tie else 5e-4)
        np.testing.assert_allclose(float(tm["grad_global_norm"]),
                                   float(jm["grad_global_norm"]),
                                   rtol=5e-3 if tie else 1e-3)
        np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        moved = max(np.abs(np.asarray(b) - p0).max() for b, p0 in zip(
            jax.tree.leaves(jparams), jax.tree.leaves(jax_smoke_params)))
        assert moved > 0
        for a, b in zip(jax.tree.leaves(params_to_numpy(state.params)),
                        jax.tree.leaves(jparams)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=2 ** -22,
                                       atol=(1.0 if tie else 1e-2) * moved)
    if agg == "flag":      # sign_flip workers are voted down
        c = tm["fa_weights"].numpy()
        assert np.abs(c[:F]).max() < np.abs(c[F:]).mean()


def test_microbatch_splits_accumulate_the_same_gradient(jax_smoke_params):
    """k = 2 sequential half-batches give the full batch's gradient (the
    loss is a mean over equal halves), so the same step up to fp32."""
    batch = {k: torch.from_numpy(v) for k, v in _tokens(9, (4, 2), 8).items()}
    out = []
    for k in (1, 2):
        tc = TrainConfig(aggregator=AggregatorConfig(name="mean"),
                         microbatch_splits=k)
        state = init_train_state(_port_cfg(True), sgd(),
                                 params=jax_smoke_params)
        m = build_train_step(_port_cfg(True), tc, sgd(),
                             warmup_cosine(0.05, 8, 1))(state, batch, 2)
        out.append((float(m["loss"]), state.flat.clone()))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-5)
    np.testing.assert_allclose(out[1][1].numpy(), out[0][1].numpy(),
                               rtol=1e-5, atol=1e-7)
    with pytest.raises(ValueError, match="microbatch_splits"):
        build_train_step(_port_cfg(True),
                         TrainConfig(aggregator=AggregatorConfig(name="mean"),
                                     microbatch_splits=3),
                         sgd(), warmup_cosine(0.05, 8, 1))(
            init_train_state(_port_cfg(True), sgd(),
                             params=jax_smoke_params), batch, 0)


def test_later_slice_options_raise():
    with pytest.raises(NotImplementedError, match="later slice"):
        build_train_step(_port_cfg(True), TrainConfig(sharded_agg=True),
                         sgd(), warmup_cosine(0.05, 8, 1))


def test_unknown_aggregator_raises_before_training():
    with pytest.raises(KeyError, match="unknown aggregator 'nope'.*krum"):
        tlaunch.main(["--debug", "--device", "cpu", "--steps", "1",
                      "--aggregator", "nope"])


# ---------------------------------------------------------------------------
# entry point
# ---------------------------------------------------------------------------

def test_launch_train_cli_runs_on_cpu(capsys):
    hist = tlaunch.main(["--debug", "--device", "cpu", "--steps", "2",
                         "--seq", "16", "--workers", "4",
                         "--per-worker-batch", "2", "--byzantine", "1",
                         "--attack", "sign_flip", "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(hist) == 2 and out.count("step ") == 2
    assert all(math.isfinite(h["loss"]) for h in hist)
    assert all(len(h["fa_weights"]) == 4 for h in hist)


def test_launch_train_cli_bulyan_on_cpu(capsys):
    hist = tlaunch.main(["--debug", "--device", "cpu", "--aggregator",
                         "bulyan", "--workers", "8", "--byzantine", "1",
                         "--attack", "sign_flip", "--steps", "2", "--seq",
                         "32", "--per-worker-batch", "2"])
    assert "agg=bulyan" in capsys.readouterr().out
    assert len(hist) == 2 and all(math.isfinite(h["loss"]) for h in hist)
    for h in hist:     # 1/theta on theta = W - 2f = 6 picks, 0 elsewhere
        c = np.array(h["fa_weights"])
        assert (c > 0).sum() == 6 and c.sum() == pytest.approx(1.0)


def test_entry_points_refuse_missing_card(monkeypatch):
    """Without a card and without --device cpu the entry point raises; it
    never carries on quietly on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--debug", "--steps", "1"])
