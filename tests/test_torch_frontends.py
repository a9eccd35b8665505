"""The frontend path's pieces and the names the port carries beside it,
each held against the JAX package on the same numpy inputs (explicit
seeds): ``layers.sinusoidal_positions``; ``transformer._embed_inputs``'s
embedded sequence, positions and loss mask with and without a prefix and
a caller's ``loss_mask``; ``optim.constant`` / ``step_decay``;
``data.make_lm_task``; ``core.beta_mle.beta_nll``; ``dist.train_step.
global_norm``; and the two launchers' ``--debug``, which strips the
frontend as the JAX launchers do (their synthetic data has no prefix),
and their refusal to run without a card unless ``--device cpu`` is given.

Tolerances: the sinusoid to 4 * max_position * 2^-24 absolute (XLA's and
ATen's fp32 ``exp`` may round a frequency an ulp apart, which moves the
angle by up to position * 2^-24 relative of it); the embedded sequence to
1e-6 of its largest |x| (the projector's fp32 sums of up to d_model = 256
products, taken in another order); the schedules, masks, positions and
token streams exactly; ``beta_nll`` and ``global_norm`` to rtol 1e-6
(fp32 sums in another order).
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.core import beta_mle as jbeta
from repro.data import make_lm_task as jmake_lm_task
from repro.dist.train_step import global_norm as jglobal_norm
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.optim import constant as jconstant
from repro.optim import step_decay as jstep_decay
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core import beta_mle
from repro_torch.data import make_lm_task
from repro_torch.dist.train_step import global_norm
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import layers, transformer
from repro_torch.optim import constant, step_decay
from repro_torch.weights import params_from_jax

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

FRONTENDS = ("musicgen-medium", "phi-3-vision-4.2b")


@pytest.mark.parametrize("d_model", [8, 32, 256, 1536, 3072])
def test_sinusoidal_positions_match_jax(d_model):
    pos = np.random.default_rng(d_model).integers(0, 8192, (3, 17))
    pos[0, :4] = (0, 1, 4095, 8191)
    want = np.asarray(jlayers.sinusoidal_positions(jnp.asarray(pos),
                                                   d_model))
    got = layers.sinusoidal_positions(torch.from_numpy(pos), d_model)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=4 * 8191 * 2.0 ** -24)
    # [sin, cos] halves, not interleaved: position 0 is (0...0, 1...1)
    zero = layers.sinusoidal_positions(torch.zeros(1, dtype=torch.long),
                                       d_model)[0]
    half = d_model // 2
    assert torch.equal(zero[:half], torch.zeros(half))
    assert torch.equal(zero[half:], torch.ones(half))


def _embed_case(arch, seed, prefix: bool, mask: bool):
    jcfg = jax_reduce(jax_get_config(arch))
    tcfg = reduce_for_smoke(get_config(arch))
    jp = jtransformer.init_params(jax.random.PRNGKey(seed), jcfg)
    rng = np.random.default_rng(seed)
    B, S = 3, 11
    batch = {"tokens": rng.integers(0, jcfg.vocab_size, (B, S),
                                    dtype=np.int32)}
    if prefix:
        batch["prefix_embeds"] = rng.normal(
            size=(B, jcfg.num_prefix_embeds, jcfg.d_frontend)).astype(
            np.float32)
    if mask:
        batch["loss_mask"] = rng.random((B, S)) < 0.6
    want = jtransformer._embed_inputs(jp, jax.tree.map(jnp.asarray, batch),
                                      jcfg)
    got = transformer._embed_inputs(
        params_from_jax(jax.tree.map(np.asarray, jp)),
        {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    return want, got, batch, tcfg


@pytest.mark.parametrize("mask", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_embed_inputs_splices_the_prefix_as_jax(arch, mask):
    """x, positions and the loss mask over the spliced sequence: the
    projected prefix first (masked out), then the tokens (the caller's
    mask, or all True); musicgen's sinusoid over all of it."""
    (jx, jpos, jmask), (x, pos, lmask), batch, cfg = _embed_case(
        arch, 3, True, mask)
    P, S = cfg.num_prefix_embeds, batch["tokens"].shape[1]
    assert x.shape == (3, P + S, cfg.d_model) and x.dtype == torch.float32
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jx)).max())
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(pos[0].numpy(), np.arange(P + S))
    np.testing.assert_array_equal(lmask.numpy(), np.asarray(jmask))
    assert not lmask[:, :P].any()
    want_tok = batch["loss_mask"] if mask else np.ones((3, S), bool)
    np.testing.assert_array_equal(lmask[:, P:].numpy(), want_tok)


@pytest.mark.parametrize("mask", [False, True], ids=["no_mask", "mask"])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_embed_inputs_without_prefix_is_the_token_path(arch, mask):
    """A frontend config whose batch has no ``prefix_embeds``: the tokens
    alone at positions 0..S-1, the caller's mask (or None) passed on."""
    (jx, jpos, jmask), (x, pos, lmask), batch, cfg = _embed_case(
        arch, 4, False, mask)
    assert x.shape == (3, batch["tokens"].shape[1], cfg.d_model)
    np.testing.assert_allclose(x.detach().numpy(), np.asarray(jx), rtol=0,
                               atol=1e-6 * np.abs(np.asarray(jx)).max())
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    if mask:
        np.testing.assert_array_equal(lmask.numpy(), np.asarray(jmask))
    else:
        assert lmask is None and jmask is None


def test_sinusoid_is_added_to_the_prefix_too():
    """musicgen-smoke with its projector zeroed: the prefix rows are the
    sinusoid alone at positions 0..P-1 (JAX adds it to the whole spliced
    sequence)."""
    cfg = reduce_for_smoke(get_config("musicgen-medium"))
    params = transformer.init_params(cfg, seed=0)
    with torch.no_grad():
        for k in ("proj1", "proj2"):
            params["frontend"][k]["w"].zero_()
    batch = {"tokens": torch.zeros((1, 5), dtype=torch.int32),
             "prefix_embeds": torch.ones((1, 8, cfg.d_frontend))}
    x, pos, _ = transformer._embed_inputs(params, batch, cfg)
    want = layers.sinusoidal_positions(torch.arange(8)[None], cfg.d_model)
    assert torch.equal(x[:, :8], want)


@pytest.mark.parametrize("step", [0, 1, 9_999, 10_000, 25_000])
def test_schedules_constant_and_step_decay_match_jax(step):
    for t in (step, torch.tensor(step)):
        got = step_decay(0.1)(t)
        assert got.dtype == torch.float32 and got.dim() == 0
        want = np.asarray(jstep_decay(0.1)(jnp.asarray(step, jnp.int32)))
        assert got.numpy() == want
        got = step_decay(0.5, decay=0.3, every=7)(t)
        want = np.asarray(jstep_decay(0.5, decay=0.3, every=7)(
            jnp.asarray(step, jnp.int32)))
        assert got.numpy() == want
        c = constant(3e-3)(t)
        assert c.dtype == torch.float32 and c.numpy() == \
            np.asarray(jconstant(3e-3)(step))
    # x0.2 every 10,000 steps
    k = step // 10_000
    np.testing.assert_allclose(float(step_decay(0.1)(step)), 0.1 * 0.2 ** k,
                               rtol=1e-6)


def test_make_lm_task_matches_jax():
    """The same task (fields, the hashed successor table over every
    context) and batches that walk it: each label is a successor of its
    token under JAX's table, and the next token is that label.  The start
    tokens and picks come from a torch generator, not jax.random."""
    task = make_lm_task(512, seed=3, branch=4)
    jtask = jmake_lm_task(512, seed=3, branch=4)
    assert (task.vocab_size, task.seed, task.branch, task.order) == \
        (jtask.vocab_size, jtask.seed, jtask.branch, jtask.order)
    ctx = np.arange(512, dtype=np.int32)
    succ = np.asarray(jtask._succ(jnp.asarray(ctx)))
    np.testing.assert_array_equal(task._succ(torch.from_numpy(ctx)).numpy(),
                                  succ)
    b = task.batch(torch.Generator().manual_seed(5), 4, 33)
    toks, labels = b["tokens"].numpy(), b["labels"].numpy()
    assert toks.shape == labels.shape == (4, 33)
    assert toks.dtype == labels.dtype == np.int32
    np.testing.assert_array_equal(toks[:, 1:], labels[:, :-1])
    assert (succ[toks] == labels[..., None]).any(-1).all()


@pytest.mark.parametrize("kw", [{}, {"alpha": 2.0, "beta": 0.5, "a": 3.0},
                                {"alpha": 1.5, "beta": 1.0}])
def test_beta_nll_matches_jax(kw):
    v = np.random.default_rng(6).random(40).astype(np.float32)
    v[:2] = (0.0, 1.0)                                # clipped ends
    want = float(jbeta.beta_nll(jnp.asarray(v), **kw))
    got = beta_mle.beta_nll(torch.from_numpy(v), **kw)
    assert got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-6)
    np.testing.assert_allclose(
        float(got), float(beta_mle.beta_nll_terms(torch.from_numpy(v),
                                                  **kw).sum()), rtol=1e-7)


def test_global_norm_matches_jax():
    rng = np.random.default_rng(7)
    tree = {"a": rng.normal(size=(3, 4)).astype(np.float32),
            "b": [rng.normal(size=5).astype(np.float32),
                  {"c": rng.normal(size=(2, 2, 2)).astype(np.float32)}],
            "d": None}
    want = float(jglobal_norm(jax.tree.map(jnp.asarray, tree)))
    ttree = {"a": torch.from_numpy(tree["a"]),
             "b": [torch.from_numpy(tree["b"][0]),
                   {"c": torch.from_numpy(tree["b"][1]["c"]).bfloat16()}],
             "d": None}
    got = global_norm(ttree)
    assert got.dtype == torch.float32 and got.dim() == 0
    # the bf16 leaf is squared in fp32 after its rounding
    flat = np.concatenate([tree["a"].ravel(), tree["b"][0],
                           ttree["b"][1]["c"].float().numpy().ravel()])
    np.testing.assert_allclose(float(got), np.sqrt((flat.astype(np.float64)
                                                    ** 2).sum()), rtol=1e-6)
    np.testing.assert_allclose(
        float(global_norm({"a": ttree["a"], "b": [ttree["b"][0],
                                                  torch.from_numpy(
                                                      tree["b"][1]["c"])]})),
        want, rtol=1e-6)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_train_launcher_debug_strips_the_frontend(arch):
    args = tlaunch._parser().parse_args(
        ["--arch", arch, "--debug", "--device", "cpu", "--workers", "2",
         "--steps", "1", "--seq", "8", "--per-worker-batch", "1"])
    run = tlaunch.setup(args)
    assert run.cfg.frontend is None and run.cfg.num_prefix_embeds == 0
    assert run.cfg.name == arch + "-smoke"
    assert "frontend" not in transformer.param_shapes_tree(run.cfg)
    assert run.state.layout.numel == transformer.count_params_analytic(
        run.cfg)


@pytest.mark.parametrize("arch", FRONTENDS)
def test_serve_launcher_debug_strips_the_frontend(arch, monkeypatch, capsys):
    seen = []
    init = transformer.init_params

    def spy(cfg, **kw):
        seen.append(cfg)
        return init(cfg, **kw)
    monkeypatch.setattr(transformer, "init_params", spy)
    out = tserve.main(["--arch", arch, "--debug", "--device", "cpu",
                       "--batch", "2", "--prompt-len", "6", "--gen", "3"])
    assert out["tokens"].shape == (2, 3)
    assert [c.frontend for c in seen] == [None]
    assert seen[0].num_prefix_embeds == 0
    assert f"arch={arch}-smoke" in capsys.readouterr().out


@pytest.mark.parametrize("which", ["train", "serve"])
def test_launchers_need_a_card_without_device_cpu(which, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--arch", "musicgen-medium", "--debug"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        if which == "train":
            tlaunch.main(argv + ["--steps", "1"])
        else:
            tserve.main(argv)
