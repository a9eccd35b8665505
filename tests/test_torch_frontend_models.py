"""Model-level port parity for the multimodal frontends, musicgen-medium
(audio: sinusoidal positions, LayerNorm with biases, plain GELU MLP, a
(B, 64, 768) conditioning prefix) and phi-3-vision-4.2b (vlm: RoPE,
RMSNorm, SwiGLU, a (B, 256, 1024) patch prefix), on their
``reduce_for_smoke`` configs (fp32 compute; 8 prefix embeddings of width
32) with JAX's weights carried across (``weights.params_from_jax``) and
the same numpy tokens and prefixes: the parameter tree's paths, shapes and
canonical order with ``frontend`` between ``final_norm`` and ``head`` (so
the flat vector, the (W, N) rows and d need no new logic); the training
loss with a prefix and its gradients, ``proj1`` / ``proj2`` included;
the token path of a frontend config (no ``prefix_embeds``: the projector's
gradient is zero, as JAX's); prefill logits with a prefix; decode steps
over a token prompt; one FA train step at W = 4 with ``prefix_embeds``
(W, B, P, d_frontend) against ``repro.dist.train_step``, whole and in two
micro-batches; the full configs' parameter counts; a musicgen-smoke train
state across ``repro.checkpoint`` both ways; the projector's init law.

Tolerances as tests/test_torch_dense_configs.py states them: the loss to
rtol 1e-5 (an fp32 forward), gradients to rtol 1e-3 with atol 1e-5 of the
leaf's largest |g|, logits to 2e-4 absolute (O(1) fp32 logits); the train
step as tests/test_torch_moe_models.py states it.  One leaf is held
otherwise: the key projection's bias (musicgen has ``use_bias``) adds
q . b to every score of a query, which the softmax cancels, so its
gradient is zero in real arithmetic and rounding noise (~1e-10) in both
packages; it is held below 1e-6 of the model's largest |g| in both.
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
from repro_torch.models import transformer
from repro_torch.optim import adamw, sgd, warmup_cosine
from repro_torch.weights import (layout_of, leaf_items, params_from_jax,
                                 params_to_numpy)

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ARCHS = ("musicgen-medium", "phi-3-vision-4.2b")
LOGIT_TOL = 2e-4
B, S = 2, 16
PROMPT, DECODE_MAX = 20, 24


def _cfgs(arch):
    return (jax_reduce(jax_get_config(arch)),
            reduce_for_smoke(get_config(arch)))


def _batch(seed, cfg, lead=(), S_tok=S):
    """Tokens, labels and ``prefix_embeds`` from a numpy seed."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (*lead, B, S_tok + 1),
                        dtype=np.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:],
            "prefix_embeds": rng.normal(size=(*lead, B, cfg.num_prefix_embeds,
                                               cfg.d_frontend)).astype(
                np.float32)}


def _value_and_grads(jp, batch, jcfg):
    loss, grads = jax.value_and_grad(lambda p: jtransformer.forward(
        p, jax.tree.map(jnp.asarray, batch), jcfg)[0])(jp)
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


@pytest.fixture(scope="module", params=ARCHS)
def ref(request):
    """JAX's weights and references for one architecture."""
    arch = request.param
    jcfg, tcfg = _cfgs(arch)
    jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    batch = _batch(1, jcfg)
    loss, grads = _value_and_grads(jp, batch, jcfg)
    tok_batch = {k: batch[k] for k in ("tokens", "labels")}
    tok_loss, tok_grads = _value_and_grads(jp, tok_batch, jcfg)
    rng = np.random.default_rng(2)
    prompt = rng.integers(0, jcfg.vocab_size, (B, PROMPT), dtype=np.int32)
    pre_batch = {"tokens": prompt, "prefix_embeds": batch["prefix_embeds"]}
    prefill = jtransformer.prefill(jp, jax.tree.map(jnp.asarray, pre_batch),
                                   jcfg)
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
            "loss": loss, "grads": grads, "tok_loss": tok_loss,
            "tok_grads": tok_grads, "prompt": prompt,
            "pre_batch": pre_batch, "prefill": np.asarray(prefill),
            "decode": np.concatenate(decode, 1)}


def _hold_grads(params, want) -> None:
    """Each leaf's gradient against JAX's (see the module doc; a leaf
    autograd never reached counts as zero)."""
    top = max(float(np.abs(g).max()) for g in want)
    for (path, t), g in zip(leaf_items(params), want, strict=True):
        got = t.grad.numpy() if t.grad is not None else np.zeros_like(g)
        if path[-2:] == ("wk", "b"):
            assert max(np.abs(got).max(), np.abs(g).max()) <= 1e-6 * top
            continue
        np.testing.assert_allclose(got, g, rtol=1e-3,
                                   atol=1e-5 * np.abs(g).max(),
                                   err_msg=str(path))


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_tree_paths_shapes_and_order_match_jax(ref):
    """JAX's leaves in JAX's flat order: ``frontend.proj1.w`` (d_frontend,
    d_model) and ``frontend.proj2.w`` (d_model, d_model), no bias even
    where the config has ``use_bias``, between ``final_norm`` and
    ``head``; so the flat vector's offsets follow JAX's leaf order."""
    flat = jax.tree_util.tree_flatten_with_path(ref["jparams"])[0]
    want = [(jax.tree_util.keystr(p), tuple(x.shape)) for p, x in flat]
    tree = transformer.param_shapes_tree(ref["tcfg"])
    got = [(keystr(p), tuple(t.shape)) for p, t in leaf_items(tree)]
    assert got == want
    keys = [k for k, _ in got]
    cfg = ref["tcfg"]
    fe = [k for k in keys if k.startswith("['frontend']")]
    assert fe == ["['frontend']['proj1']['w']", "['frontend']['proj2']['w']"]
    i = keys.index(fe[0])
    assert keys[i - 1].startswith("['final_norm']")
    # head and tail are empty (a plain attention stack): unembed follows
    assert keys[i + 2:] == ["['unembed']['table']"]
    assert dict(got)[fe[0]] == (cfg.d_frontend, cfg.d_model)
    assert dict(got)[fe[1]] == (cfg.d_model, cfg.d_model)
    layout = layout_of(tree)
    sizes = [int(np.prod(s)) for _, s in want]
    assert list(layout.offsets) == list(np.cumsum([0] + sizes[:-1]))
    assert layout.numel == transformer.count_params_analytic(cfg) == \
        jtransformer.count_params_analytic(ref["jcfg"])


def test_loss_and_gradients_with_a_prefix_match_jax(ref):
    params = params_from_jax(ref["params"])
    leaves = [t.requires_grad_(True) for _, t in leaf_items(params)]
    total, metrics = transformer.forward(params, _torch(ref["batch"]),
                                         ref["tcfg"])
    total.backward()
    np.testing.assert_allclose(float(total.detach()), ref["loss"],
                               rtol=1e-5)
    assert float(metrics["loss"].detach()) == float(total.detach())
    assert len(leaves) == len(ref["grads"])
    _hold_grads(params, ref["grads"])
    for k in ("proj1", "proj2"):
        assert float(params["frontend"][k]["w"].grad.abs().max()) > 0


def test_prefix_is_masked_out_of_the_loss(ref):
    """The loss over the spliced sequence is the token positions' mean
    NLL: a caller's mask that drops every token but one gives that token's
    NLL, with JAX's value."""
    params = params_from_jax(ref["params"])
    batch = dict(ref["batch"])
    mask = np.zeros(batch["tokens"].shape, bool)
    mask[1, 5] = True
    batch["loss_mask"] = mask
    want = float(jtransformer.forward(
        ref["jparams"], jax.tree.map(jnp.asarray, batch), ref["jcfg"])[0])
    with torch.no_grad():
        got, _ = transformer.forward(params, _torch(batch), ref["tcfg"])
        logits = transformer.prefill(
            params, {k: _torch(batch)[k] for k in ("tokens",
                                                   "prefix_embeds")},
            ref["tcfg"])
    P = ref["tcfg"].num_prefix_embeds
    nll = -torch.log_softmax(logits[1, P + 5], -1)[batch["labels"][1, 5]]
    np.testing.assert_allclose(float(got), want, rtol=1e-5)
    np.testing.assert_allclose(float(got), float(nll), rtol=1e-5)


def test_token_path_leaves_the_projector_untouched(ref):
    """A frontend config whose batch has no ``prefix_embeds`` runs the
    token path (JAX's ``"prefix_embeds" in batch``): the loss and every
    gradient as JAX's, the projector's gradient zero in both."""
    params = params_from_jax(ref["params"])
    for _, t in leaf_items(params):
        t.requires_grad_(True)
    total, _ = transformer.forward(
        params, _torch({k: ref["batch"][k] for k in ("tokens", "labels")}),
        ref["tcfg"])
    total.backward()
    np.testing.assert_allclose(float(total.detach()), ref["tok_loss"],
                               rtol=1e-5)
    for (path, t), g in zip(leaf_items(params), ref["tok_grads"]):
        if path[0] == "frontend":
            assert t.grad is None or not t.grad.any(), path
            assert not np.any(g), path
    _hold_grads(params, ref["tok_grads"])


def test_prefill_with_a_prefix_matches_jax(ref):
    P, cfg = ref["tcfg"].num_prefix_embeds, ref["tcfg"]
    params = params_from_jax(ref["params"])
    with torch.no_grad():
        got = transformer.prefill(params, _torch(ref["pre_batch"]), cfg)
        other = dict(ref["pre_batch"])
        other["prefix_embeds"] = other["prefix_embeds"][::-1].copy()
        moved = transformer.prefill(params, _torch(other), cfg)
    assert got.shape == (B, P + PROMPT, cfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), ref["prefill"], rtol=0,
                               atol=LOGIT_TOL)
    # causal: another prefix moves every token position's logits
    gap = (moved[:, P:] - got[:, P:]).abs().amax(dim=-1)
    assert float(gap.min()) > 100 * LOGIT_TOL


def test_decode_steps_match_jax_and_prefill(ref):
    """Decode over a token prompt (fp32 caches; musicgen adds the
    sinusoid at each step) against JAX's decode and against the port's
    own token prefill."""
    cfg = ref["tcfg"]
    params = params_from_jax(ref["params"])
    caches = transformer.init_caches(cfg, B, DECODE_MAX, torch.float32)
    out = []
    with torch.no_grad():
        for t in range(PROMPT):
            lg, caches = transformer.decode_step(
                params, torch.from_numpy(ref["prompt"][:, t:t + 1]), caches,
                t, cfg, max_len=DECODE_MAX)
            out.append(lg.numpy())
        pre = transformer.prefill(
            params, {"tokens": torch.from_numpy(ref["prompt"])}, cfg)
    got = np.concatenate(out, 1)
    np.testing.assert_allclose(got, ref["decode"], rtol=0, atol=LOGIT_TOL)
    np.testing.assert_allclose(got, pre.numpy(), rtol=0, atol=LOGIT_TOL)


@pytest.mark.parametrize("splits", [1, 2])
def test_fa_train_step_with_prefix_matches_jax(ref, splits):
    """One step of the whole pipeline with ``prefix_embeds`` (W, B, P,
    d_frontend) in the worker-major batch (per-worker grads over the
    spliced sequence, sign_flip on f = 1 of W = 4, flag with lambda = W,
    SGD), whole and in two micro-batches (each key sliced by worker and by
    micro-batch), from JAX's weights.  Tolerances as
    tests/test_torch_moe_models.py states them: the loss rtol 1e-5, the FA
    weights rtol 5e-3 / atol 5e-4 (eigensolvers differ),
    grad_global_norm rtol 1e-3, each parameter within 1 % of the largest
    change JAX made plus 2 ulp; the projector's rows of d non-zero."""
    W, F = 4, 1
    jcfg, tcfg = ref["jcfg"], ref["tcfg"]
    jparams, np_params = ref["jparams"], ref["params"]
    lam = float(W)
    jtc = JTrainConfig(aggregator=JAggregatorConfig(
        name="flag", f=F, flag=JFlagConfig(lam=lam), impl="xla"),
        attack="sign_flip", attack_f=F, attn_impl="xla",
        microbatch_splits=splits)
    ttc = TrainConfig(aggregator=AggregatorConfig(
        name="flag", f=F, flag=FlagConfig(lam=lam)),
        attack="sign_flip", attack_f=F, microbatch_splits=splits)
    jstep = jax.jit(jax_build_train_step(
        jcfg, jtc, jsgd(momentum=0.9), jwarmup_cosine(0.05, 8, 1)))
    tstep = build_train_step(tcfg, ttc, sgd(momentum=0.9),
                             warmup_cosine(0.05, 8, 1))
    state = init_train_state(tcfg, sgd(momentum=0.9), params=np_params)
    batch = _batch(31, jcfg, lead=(W,), S_tok=12)
    jnew, _, jm = jstep(jparams, jsgd(momentum=0.9).init(jparams),
                        jax.tree.map(jnp.asarray, batch),
                        jax.random.PRNGKey(1), jnp.asarray(1, jnp.int32))
    tm = tstep(state, _torch(batch), 1)
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
    d = state.opt_state["mu"]                # SGD's first step: mu = d
    layout = state.layout
    for path, o, n in zip(layout.paths, layout.offsets, layout.sizes):
        if path[0] == "frontend":
            assert float(d[o:o + n].abs().max()) > 0, path


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_counts_match_jax(arch):
    """``param_count`` of the full configs and of the depth cut the card
    trains (musicgen at 16 layers) equal JAX's ``count_params_analytic``
    (through ``eval_shape``: no weight is drawn)."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert tcfg.param_count() == jtransformer.count_params_analytic(jcfg)
    assert tcfg.active_param_count() == tcfg.param_count()
    assert transformer.count_embedding_params(tcfg) == \
        jtransformer.count_embedding_params(jcfg)
    for layers in (2, 16):
        assert transformer.count_params_analytic(
            tcfg.replace(num_layers=layers)) == \
            jtransformer.count_params_analytic(
                jcfg.replace(num_layers=layers))


def test_full_counts_are_the_card_runs_sizes():
    assert get_config("musicgen-medium").param_count() == 1_369_746_432
    assert get_config("phi-3-vision-4.2b").param_count() == 3_833_662_464
    assert get_config("musicgen-medium").replace(
        num_layers=16).param_count() == 463_137_792


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().contiguous().numpy()


def _jax_keyed(tree) -> dict:
    return {jax.tree_util.keystr(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_musicgen_checkpoint_port_to_jax(tmp_path):
    """A random AdamW train state of musicgen-smoke saved by the port
    fills JAX's template bit for bit, the projector's leaves included."""
    jcfg, tcfg = _cfgs("musicgen-medium")
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
    assert "[0]['frontend']['proj1']['w']" in keys
    assert "[1]['nu']['frontend']['proj2']['w']" in keys
    out, step = jax_load(str(tmp_path), template)
    assert step == 7
    got = _jax_keyed(out)
    for p, leaf in leaf_items(tree):
        k = keystr(p)
        np.testing.assert_array_equal(got[k], _bits(leaf), err_msg=k)


def test_musicgen_checkpoint_jax_to_port(tmp_path):
    """A random state saved by JAX restores into the port's flat storage
    bit for bit, in canonical order, in place."""
    jcfg, tcfg = _cfgs("musicgen-medium")
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
    np.testing.assert_array_equal(
        state.params["frontend"]["proj1"]["w"].detach().numpy(),
        np.asarray(filled[0]["frontend"]["proj1"]["w"]))


# std of N(0, 1) truncated to [-2, 2]
_TRUNC_STD = 0.8796


def test_projector_draws_with_fan_in_its_input_width():
    """``init_params`` draws ``proj1`` with fan-in d_frontend and
    ``proj2`` with fan-in d_model (JAX's ``linear_init``): std 0.88 /
    sqrt(fan_in), within [-2, 2] / sqrt(fan_in); the JAX package's own
    draw has the same stds."""
    jcfg, tcfg = _cfgs("phi-3-vision-4.2b")
    tcfg, jcfg = (c.replace(d_frontend=1024) for c in (tcfg, jcfg))
    params = transformer.init_params(tcfg, seed=3)
    jp = jtransformer.init_params(jax.random.PRNGKey(3), jcfg)
    for k, fan_in in (("proj1", 1024), ("proj2", tcfg.d_model)):
        got = params["frontend"][k]["w"]
        assert float(got.abs().max()) <= 2 / fan_in ** 0.5 * (1 + 1e-6)
        for t in (got.numpy(), np.asarray(jp["frontend"][k]["w"])):
            std = _TRUNC_STD / fan_in ** 0.5
            assert abs(float(t.std()) / std - 1) < 0.05, (k, fan_in)
