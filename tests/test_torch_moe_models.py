"""Model-level port parity for the Mixture-of-Experts architectures,
mixtral-8x7b (8 experts top-2, a sliding window) and deepseek-moe-16b (64
routed top-6 + 2 shared, a dense-FFN head layer), on their
``reduce_for_smoke`` configs (fp32 compute; 4 experts, top-2, d_expert
128, capacity factor 4.0: drop-free; deepseek-smoke is its dense head
plus 2 MoE layers with one shared expert; mixtral-smoke's window is 64)
with JAX's weights carried across (``weights.params_from_jax``) and the
same numpy tokens: the parameter tree's paths, shapes and canonical
order; the training loss, its metrics (``moe_aux``, ``moe_z``) and
gradients; prefill logits; decode steps over a 70-token prompt (mixtral's
ring of 64 wraps); one FA train step at W = 4 against
``repro.dist.train_step``; the full configs' parameter counts; a
deepseek-smoke train state across ``repro.checkpoint`` both ways; the
expert banks' init law; and the two launchers on ``--arch``.  The JAX
references are computed once per architecture (module-scoped fixtures).

Tolerances: the loss to rtol 1e-5 and the router losses to rtol 1e-5 (an
fp32 forward); gradients to 1e-4 of the leaf's largest |g| (fp32 sums in
another order; MoE outputs are ~1e2 times their input under JAX's bank
init, std 1/sqrt(E)); logits to 2e-4 absolute (O(1) fp32 logits, as
tests/test_torch_recurrent_models.py holds them).  Routing is discrete:
a token whose top-2 probs were within rounding of a tie would route
differently in the two packages, so the tests hold logits on this seed's
draws, where no such tie occurs (a flip would show as an O(1) error).
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
from repro_torch.checkpoint import (checkpoint_meta, leaf_keys,
                                    load_checkpoint, save_checkpoint)
from repro_torch.checkpoint.checkpoint import keystr
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.flag import FlagConfig
from repro_torch.dist.aggregation import AggregatorConfig
from repro_torch.dist.train_step import (TrainConfig, build_train_step,
                                         init_train_state, train_state_tree)
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import transformer
from repro_torch.optim import adamw, sgd, warmup_cosine
from repro_torch.weights import leaf_items, params_from_jax, params_to_numpy

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ARCHS = ("mixtral-8x7b", "deepseek-moe-16b")
LOGIT_TOL, GRAD_TOL = 2e-4, 1e-4
B, S = 2, 24
PROMPT, DECODE_MAX = 70, 80


def _cfgs(arch):
    return (jax_reduce(jax_get_config(arch)),
            reduce_for_smoke(get_config(arch)))


def _tokens(seed, shape):
    return np.random.default_rng(seed).integers(0, 512, shape,
                                                dtype=np.int32)


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """JAX's weights and references for one architecture."""
    arch = request.param
    jcfg, tcfg = _cfgs(arch)
    jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    toks = _tokens(1, (B, S + 1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: jtransformer.forward(p, jax.tree.map(jnp.asarray, batch),
                                       jcfg), has_aux=True)(jp)
    prompt = _tokens(2, (B, PROMPT))
    prefill = jtransformer.prefill(jp, {"tokens": jnp.asarray(prompt)}, jcfg)
    step = jax.jit(lambda p, tok, c, s: jtransformer.decode_step(
        p, tok, c, s, jcfg, max_len=DECODE_MAX))
    caches = jtransformer.init_caches(jcfg, B, DECODE_MAX, jnp.float32)
    decode = []
    for t in range(PROMPT):
        lg, caches = step(jp, jnp.asarray(prompt[:, t:t + 1]), caches,
                          jnp.asarray(t, jnp.int32))
        decode.append(np.asarray(lg))
    return {"arch": arch, "jcfg": jcfg, "tcfg": tcfg, "jparams": jp,
            "params": jax.tree.map(np.asarray, jp), "batch": batch,
            "loss": float(loss),
            "metrics": {k: float(v) for k, v in metrics.items()},
            "grads": [np.asarray(g) for g in jax.tree.leaves(grads)],
            "prompt": prompt, "prefill": np.asarray(prefill),
            "decode": np.concatenate(decode, 1)}


def test_tree_paths_shapes_and_order_match_jax(ref):
    """The port's tree has JAX's leaves in JAX's flat order: ``head[0]``
    (deepseek's dense layer), ``ffn.router``, ``ffn.shared`` and the 3-D
    banks included."""
    flat = jax.tree_util.tree_flatten_with_path(ref["jparams"])[0]
    want = [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in flat]
    got = [(keystr(p), tuple(t.shape)) for p, t in
           leaf_items(transformer.param_shapes_tree(ref["tcfg"]))]
    assert got == want
    keys = [k for k, _ in got]
    assert any("['router']" in k for k in keys)
    assert any("['w_up']" in k for k in keys)
    if ref["tcfg"].moe_skip_first:
        head = [k for k in keys if k.startswith("['head'][0]")]
        assert "['head'][0]['ffn']['up']['w']" in head
        assert any("['shared']" in k for k in keys)
    else:
        assert not any(k.startswith("['head']") for k in keys)


def test_loss_metrics_and_gradients_match_jax(ref):
    params = params_from_jax(ref["params"])
    leaves = [t.requires_grad_(True) for _, t in leaf_items(params)]
    total, metrics = transformer.forward(
        params, {k: torch.from_numpy(v) for k, v in ref["batch"].items()},
        ref["tcfg"])
    total.backward()
    want = ref["metrics"]
    assert sorted(metrics) == sorted(want)
    for k in ("loss", "moe_aux", "moe_z"):
        np.testing.assert_allclose(float(metrics[k].detach()), want[k],
                                   rtol=1e-5,
                                   err_msg=k)
    assert want["moe_aux"] > 0 and want["moe_z"] > 0
    np.testing.assert_allclose(float(total.detach()), ref["loss"],
                               rtol=1e-5)
    np.testing.assert_allclose(
        float(total.detach()),
        float(metrics["loss"] + metrics["moe_aux"] + metrics["moe_z"]),
        rtol=1e-6)
    assert len(leaves) == len(ref["grads"])
    for (path, t), g in zip(leaf_items(params), ref["grads"]):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=GRAD_TOL * np.abs(g).max(),
                                   err_msg=str(path))


def test_prefill_logits_match_jax(ref):
    with torch.no_grad():
        got = transformer.prefill(params_from_jax(ref["params"]),
                                  {"tokens": torch.from_numpy(ref["prompt"])},
                                  ref["tcfg"])
    np.testing.assert_allclose(got.numpy(), ref["prefill"], rtol=0,
                               atol=LOGIT_TOL)


def test_decode_steps_match_jax_and_prefill(ref):
    """70 decode steps (fp32 caches; past mixtral-smoke's window of 64, so
    its ring buffer wraps): every step's logits against JAX's decode, and
    the port's decode against its own prefill (drop-free: the smoke
    capacity factor 4.0 keeps every slot in both)."""
    tcfg = ref["tcfg"]
    params = params_from_jax(ref["params"])
    caches = transformer.init_caches(tcfg, B, DECODE_MAX, torch.float32)
    ring = transformer.attention.cache_is_ring(tcfg, DECODE_MAX)
    assert ring == (tcfg.window is not None)
    if ring:
        assert caches["body"][0]["k"].shape[3] == tcfg.window < PROMPT
    if tcfg.moe_skip_first:
        assert caches["head"][0]["k"].shape == (B, tcfg.num_kv_heads,
                                                DECODE_MAX, tcfg.head_dim)
    out = []
    with torch.no_grad():
        for t in range(PROMPT):
            lg, caches = transformer.decode_step(
                params, torch.from_numpy(ref["prompt"][:, t:t + 1]), caches,
                t, tcfg, max_len=DECODE_MAX)
            out.append(lg.numpy())
    got = np.concatenate(out, 1)
    np.testing.assert_allclose(got, ref["decode"], rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(got, ref["prefill"], rtol=0, atol=LOGIT_TOL)


def test_fa_train_step_matches_jax(ref):
    """One step of the whole pipeline (per-worker grads, sign_flip on
    f = 1 of W = 4, flag with lambda = W, SGD) from JAX's weights on the
    same tokens.  Tolerances as tests/test_torch_train.py states them: the
    loss and the router losses rtol 1e-5, the FA weights rtol 5e-3 / atol
    5e-4 (eigensolvers differ), grad_global_norm rtol 1e-3, each parameter
    within 1 % of the largest change JAX made plus 2 ulp."""
    W, F, Bw, Sw = 4, 1, 2, 16
    jcfg, tcfg = ref["jcfg"], ref["tcfg"]
    jparams, np_params = ref["jparams"], ref["params"]
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
    toks = _tokens(31, (W, Bw, Sw + 1))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    jnew, _, jm = jstep(jparams, jsgd(momentum=0.9).init(jparams),
                        jax.tree.map(jnp.asarray, batch),
                        jax.random.PRNGKey(1), jnp.asarray(1, jnp.int32))
    tm = tstep(state, {k: torch.from_numpy(v) for k, v in batch.items()}, 1)
    for k in ("loss", "moe_aux", "moe_z"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   err_msg=k)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_counts_match_jax(arch):
    """``param_count`` / ``active_param_count`` of the full configs and of
    the depth cuts the card runs equal JAX's ``count_params_analytic``
    (through ``eval_shape``: no weight is drawn)."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert tcfg.param_count() == jtransformer.count_params_analytic(jcfg)
    assert tcfg.active_param_count() == jtransformer.count_params_analytic(
        jcfg, active_only=True) < tcfg.param_count()
    assert transformer.count_embedding_params(tcfg) == \
        jtransformer.count_embedding_params(jcfg)
    for layers in (2, 4):
        assert transformer.count_params_analytic(
            tcfg.replace(num_layers=layers)) == \
            jtransformer.count_params_analytic(
                jcfg.replace(num_layers=layers))


def test_full_counts_are_the_published_sizes():
    assert get_config("mixtral-8x7b").param_count() == 46_702_792_704
    assert get_config("mixtral-8x7b").active_param_count() == 12_879_925_248
    assert get_config("deepseek-moe-16b").param_count() == 16_375_728_128
    assert get_config("deepseek-moe-16b").active_param_count() == \
        2_828_650_496


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy()


def _jax_keyed(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_deepseek_checkpoint_port_to_jax(tmp_path):
    """A random AdamW train state of deepseek-smoke saved by the port
    fills JAX's template bit for bit, ``['head'][0]...`` and the banks
    included."""
    jcfg, tcfg = _cfgs("deepseek-moe-16b")
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
    keys = checkpoint_meta(str(tmp_path))["keys"]
    assert keys == sorted(_jax_keyed(template)) == leaf_keys(tree)
    assert "[0]['head'][0]['ffn']['gate']['w']" in keys
    assert "[1]['mu']['body'][0]['ffn']['shared']['w_down']" in keys
    out, step = jax_load(str(tmp_path), template)
    assert step == 7
    got = _jax_keyed(out)
    for p, leaf in leaf_items(tree):
        k = keystr(p)
        np.testing.assert_array_equal(got[k], _bits(leaf), err_msg=k)


def test_deepseek_checkpoint_jax_to_port(tmp_path):
    """A random state saved by JAX restores into the port's flat storage
    bit for bit, in canonical order, in place."""
    jcfg, tcfg = _cfgs("deepseek-moe-16b")
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


# std of N(0, 1) truncated to [-2, 2]
_TRUNC_STD = 0.8796


def test_expert_banks_draw_with_fan_in_E():
    """``init_params`` draws every expert bank (E, d_in, d_out) with
    fan-in E, as JAX's ``moe_init`` (``layers.truncated_normal_init``'s
    ``shape[0]``): std 0.88 / sqrt(E), so the banks are not zeroed as a
    bias would be; the router with fan-in d_model; the head layer's dense
    FFN with fan-in d_model (up / gate) and dense_d_ff_first (down).  The
    JAX package's own draw has the same stds."""
    jcfg, tcfg = _cfgs("deepseek-moe-16b")
    params = transformer.init_params(tcfg, seed=3)
    jp = jtransformer.init_params(jax.random.PRNGKey(3), jcfg)
    E, d = tcfg.moe.num_experts, tcfg.d_model
    ffn, jffn = params["body"][0]["ffn"], jp["body"][0]["ffn"]
    cases = [(ffn["w_up"], jffn["w_up"], E),
             (ffn["w_down"], jffn["w_down"], E),
             (ffn["shared"]["w_gate"], jffn["shared"]["w_gate"], 1),
             (ffn["router"]["w"], jffn["router"]["w"], d),
             (params["head"][0]["ffn"]["down"]["w"],
              jp["head"][0]["ffn"]["down"]["w"], tcfg.dense_d_ff_first)]
    for got, want, fan_in in cases:
        std = _TRUNC_STD / fan_in ** 0.5
        assert float(got.abs().max()) <= 2 / fan_in ** 0.5 * (1 + 1e-6)
        for t in (got.numpy(), np.asarray(want)):
            assert abs(float(t.std()) / std - 1) < 0.05, (t.shape, fan_in)


def test_serve_launcher_runs_mixtral_on_the_cpu(capsys):
    out = tserve.main(["--arch", "mixtral-8x7b", "--debug", "--device",
                       "cpu", "--batch", "2", "--prompt-len", "70", "--gen",
                       "4"])
    assert out["tokens"].shape == (2, 4)
    assert "arch=mixtral-8x7b-smoke" in capsys.readouterr().out


def test_train_launcher_reports_router_losses(capsys):
    hist = tlaunch.main(["--arch", "deepseek-moe-16b", "--debug", "--device",
                         "cpu", "--steps", "2", "--seq", "16", "--workers",
                         "4", "--per-worker-batch", "1", "--log-every", "1"])
    assert len(hist) == 2
    for h in hist:
        assert np.isfinite(h["loss"]) and h["moe_aux"] > 0 and h["moe_z"] > 0
    assert "arch=deepseek-moe-16b-smoke" in capsys.readouterr().out
