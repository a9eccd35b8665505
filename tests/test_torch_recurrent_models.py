"""Model-level port parity for the recurrent architectures, xlstm-1.3b
(mLSTM / sLSTM) and recurrentgemma-9b (RG-LRU and local attention), on
their ``reduce_for_smoke`` configs (fp32 compute) with JAX's weights
carried across (``weights.params_from_jax``) and the same numpy tokens:
the training loss and gradients, prefill logits, decode steps and caches
under fp32 and the default bf16 cache dtype, the greedy decode loop (a
ring buffer for recurrentgemma), and, on the full configs (shapes only),
the parameter tree and counts; then each new leaf's init law.  The JAX
references are computed once per architecture (module-scoped fixtures).

Tolerances: the loss to rtol 1e-5 (an fp32 forward); gradients to rtol
1e-3 with atol 1e-5 of the leaf's largest |g| (fp32 sums in another
order through the exp-gated cells); logits to 2e-4 absolute (O(1) fp32
logits two recurrent blocks deep; mLSTM outputs carry the reference's
2e-4, tests/test_models.py); caches to 2e-3 absolute and relative (the
mLSTM state tolerance of tests/test_models.py), except a bf16 leaf,
which may differ by one bf16 ulp (2^-8 relative) where the two fp32
values it rounds straddle a rounding boundary.
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
from repro.dist import serve_step as jserve
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.dist import serve_step
from repro_torch.models import transformer
from repro_torch.weights import leaf_items, params_from_jax

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ARCHS = ("xlstm-1.3b", "recurrentgemma-9b")
LOGIT_TOL = 2e-4
CACHE_TOL = 2e-3
B, S = 2, 20
DECODE_STEPS, DECODE_MAX = 12, 16


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
    loss, grads = jax.value_and_grad(lambda p: jtransformer.forward(
        p, jax.tree.map(jnp.asarray, batch), jcfg)[0])(jp)
    prefill = jtransformer.prefill(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    step = jax.jit(lambda p, tok, c, s: jtransformer.decode_step(
        p, tok, c, s, jcfg, max_len=DECODE_MAX))
    decode = {}
    for name, dt in (("float32", jnp.float32), ("bfloat16", jnp.bfloat16)):
        caches = jtransformer.init_caches(jcfg, B, DECODE_MAX, dt)
        logits = []
        for t in range(DECODE_STEPS):
            lg, caches = step(jp, jnp.asarray(toks[:, t:t + 1]), caches,
                              jnp.asarray(t, jnp.int32))
            logits.append(np.asarray(lg))
        decode[name] = (np.concatenate(logits, 1),
                        jax.tree.map(np.asarray, caches))
    return {"arch": arch, "jcfg": jcfg, "tcfg": tcfg,
            "params": jax.tree.map(np.asarray, jp), "toks": toks,
            "batch": batch, "loss": float(loss),
            "grads": [np.asarray(g) for g in jax.tree.leaves(grads)],
            "prefill": np.asarray(prefill), "decode": decode}


def test_loss_and_gradients_match_jax(ref):
    params = params_from_jax(ref["params"])
    leaves = [t.requires_grad_(True) for _, t in leaf_items(params)]
    loss, _ = transformer.forward(
        params, {k: torch.from_numpy(v) for k, v in ref["batch"].items()},
        ref["tcfg"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), ref["loss"], rtol=1e-5)
    assert len(leaves) == len(ref["grads"])
    for (path, t), g in zip(leaf_items(params), ref["grads"]):
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-3,
                                   atol=1e-5 * np.abs(g).max(),
                                   err_msg=str(path))


def test_prefill_logits_match_jax(ref):
    with torch.no_grad():
        got = transformer.prefill(params_from_jax(ref["params"]),
                                  {"tokens": torch.from_numpy(ref["toks"])},
                                  ref["tcfg"])
    np.testing.assert_allclose(got.numpy(), ref["prefill"], rtol=0,
                               atol=LOGIT_TOL)


@pytest.mark.parametrize("cache_dtype", ["float32", "bfloat16"])
def test_decode_steps_match_jax(ref, cache_dtype):
    """12 decode steps: the logits of each, and the caches after the last
    in dtype (the conv states come back fp32 even from bf16 caches, as
    JAX's promoted concatenation returns them) and value."""
    want_logits, want_caches = ref["decode"][cache_dtype]
    params = params_from_jax(ref["params"])
    caches = transformer.init_caches(ref["tcfg"], B, DECODE_MAX,
                                     getattr(torch, cache_dtype))
    logits = []
    with torch.no_grad():
        for t in range(DECODE_STEPS):
            lg, caches = transformer.decode_step(
                params, torch.from_numpy(ref["toks"][:, t:t + 1]), caches, t,
                ref["tcfg"], max_len=DECODE_MAX)
            logits.append(lg)
    np.testing.assert_allclose(torch.cat(logits, 1).numpy(), want_logits,
                               rtol=0, atol=LOGIT_TOL)
    got = leaf_items(caches)
    want = jax.tree_util.tree_flatten_with_path(want_caches)[0]
    assert len(got) == len(want)
    for (path, a), (_, b) in zip(got, want):
        b = np.asarray(b)
        assert str(a.dtype).split(".")[-1] == str(b.dtype), path
        rtol = CACHE_TOL + (2.0 ** -8 if b.dtype != np.float32 else 0)
        np.testing.assert_allclose(a.float().numpy(), b.astype(np.float32),
                                   rtol=rtol, atol=CACHE_TOL,
                                   err_msg=str(path))


def test_default_cache_dtype_is_bf16_and_conv_states_promote(ref):
    """``init_caches``' default dtype is bf16 (as in JAX); the recurrent
    states are fp32 and a conv state is promote(bf16, compute dtype):
    JAX's state after one step."""
    caches = transformer.init_caches(ref["tcfg"], B, DECODE_MAX)
    jcaches = jtransformer.init_caches(ref["jcfg"], B, DECODE_MAX)
    got = leaf_items(caches)
    want = jax.tree_util.tree_flatten_with_path(jcaches)[0]
    assert [tuple(a.shape) for _, a in got] == [b.shape for _, b in want]
    for (path, a), (_, b) in zip(got, want):
        if path[-1] in ("k", "v"):
            assert a.dtype == torch.bfloat16, path
        else:
            assert a.dtype == torch.float32, path
        np.testing.assert_array_equal(a.float().numpy(),
                                      np.asarray(b, np.float32))


@pytest.mark.parametrize("prompt,gen,max_len", [(6, 5, 12), (60, 10, 72)])
def test_decode_loop_matches_jax(ref, prompt, gen, max_len):
    """Greedy tokens equal JAX's, over a short and a 70-step decode; at
    max_len 72 > the reduced window 64, recurrentgemma's attention caches
    are ring buffers (xlstm has no attention: a long decode there)."""
    prompts = _tokens(7, (B, prompt))
    jp = jax.tree.map(jnp.asarray, ref["params"])
    want = np.asarray(jserve.decode_loop(jp, ref["jcfg"],
                                         jnp.asarray(prompts),
                                         num_steps=gen, max_len=max_len))
    got = serve_step.decode_loop(params_from_jax(ref["params"]), ref["tcfg"],
                                 torch.from_numpy(prompts), num_steps=gen,
                                 max_len=max_len)
    np.testing.assert_array_equal(got.numpy(), want)
    if max_len > 64 and ref["arch"] == "recurrentgemma-9b":
        assert transformer.attention.cache_is_ring(ref["tcfg"], max_len)


# ---------------------------------------------------------------------------
# the full configurations: the tree, the counts (shapes only)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_param_tree_and_counts_match_jax(arch):
    """``param_shapes_tree`` (meta tensors) has ``jax.eval_shape(init_
    params)``'s leaf paths, order and shapes at full size, and the counts
    equal JAX's ``count_params_analytic`` / ``count_embedding_params``."""
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    want = jax.tree_util.tree_flatten_with_path(jax.eval_shape(
        lambda k: jtransformer.init_params(k, jcfg), jax.random.PRNGKey(0)))[0]
    got = leaf_items(transformer.param_shapes_tree(tcfg))
    assert [(tuple(getattr(k, "key", getattr(k, "idx", None)) for k in p),
             tuple(x.shape)) for p, x in want] == \
        [(p, tuple(t.shape)) for p, t in got]
    assert transformer.count_params_analytic(tcfg) == \
        jtransformer.count_params_analytic(jcfg) == tcfg.param_count()
    assert transformer.count_embedding_params(tcfg) == \
        jtransformer.count_embedding_params(jcfg)


# ---------------------------------------------------------------------------
# init laws
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_init_laws_match_jax(arch):
    """Each leaf of the port's draw against JAX's draw on the same reduced
    config: constant leaves (norm scales, biases) equal; random leaves'
    means within 5 standard errors of 0 and their standard deviations
    within 5 standard errors of JAX's (relative 5 / sqrt(2 n) for n
    entries; the body's leaves hold 1 or more layers).  Lambda is checked
    against its range.  A wrong fan-in moves a std by 2x or more: the
    mLSTM q / k / v blocks (fan-in nb, not 4), sLSTM's r (fan-in 4, not
    dh), the conv (N(0, 1) / width, untruncated)."""
    jcfg, tcfg = _cfgs(arch)
    jp = jax.tree_util.tree_flatten_with_path(jax.tree.map(
        np.asarray, jtransformer.init_params(jax.random.PRNGKey(3), jcfg)))[0]
    tp = leaf_items(transformer.init_params(tcfg, seed=3))
    lo = float(np.log(np.expm1(-np.log(0.999))))
    hi = float(np.log(np.expm1(-np.log(0.9))))
    for (path, t), (_, j) in zip(tp, jp, strict=True):
        a = t.numpy().astype(np.float64)
        j = j.astype(np.float64)
        n = a.size
        if path[-1] == "lam":
            assert lo - 1e-5 <= a.min() and a.max() <= hi + 1e-5
            assert lo - 1e-5 <= j.min() and j.max() <= hi + 1e-5
        elif j.std() == 0:
            np.testing.assert_array_equal(a, j, err_msg=str(path))
        else:
            se = 5 / np.sqrt(2 * n)
            assert abs(a.mean()) < 5 * j.std() / np.sqrt(n), path
            assert abs(a.std() / j.std() - 1) < se, (path, a.std(), j.std())
    if arch == "xlstm-1.3b":
        p = transformer.init_params(tcfg, seed=3)["body"]
        # reduced: d_in 512, nb 128 -> std 0.8796 / sqrt(128); r: 0.8796 / 2
        wq = p[0]["mixer"]["wq"]["w"]
        assert abs(float(wq.std()) * 128 ** 0.5 / 0.8796 - 1) < 0.05
        r = p[1]["mixer"]["r"]
        assert abs(float(r.std()) * 2 / 0.8796 - 1) < 0.05


# ---------------------------------------------------------------------------
# the sLSTM's gain at full width, in the reference as in the port
# ---------------------------------------------------------------------------

def test_slstm_amplifies_perturbations_in_jax_as_in_the_port():
    """xlstm-1.3b's sLSTM at its full width (d_model 2048, 4 heads of 512,
    one layer, vocab 512, fp32), JAX's weights: under the JAX package's
    init (r with fan-in 4, std 0.5) the recurrence amplifies a
    perturbation ~1.7x a step, in the reference as in the port.  This is
    why the card's full-width prefill and decode part after a few
    positions and the 128-token training gradient overflows
    (``chip_smoke.py``: SERVE_HOLD, TRAIN_XLSTM_SEQS).

    Held: the gradient norm grows over 1e3x from 16 to 32 tokens in both
    packages, which agree within 5 % at 16 tokens (at 32 the two
    packages' rounding differences are amplified apart too: 30 % under
    another thread count); a relative 2^-20 change of the embedding table
    moves the logits at position 20 over 1e3x as much as at position 0,
    in both."""
    jcfg = jax_get_config("xlstm-1.3b").replace(
        block_pattern=("slstm",), num_layers=1, vocab_size=512,
        compute_dtype="float32")
    tcfg = get_config("xlstm-1.3b").replace(
        block_pattern=("slstm",), num_layers=1, vocab_size=512,
        compute_dtype="float32")
    jp = jax.tree.map(np.asarray,
                      jtransformer.init_params(jax.random.PRNGKey(0), jcfg))
    toks = _tokens(1, (1, 33))
    norms = {}
    for S in (16, 32):
        batch = {"tokens": toks[:, :S], "labels": toks[:, 1:S + 1]}
        g = jax.grad(lambda p: jtransformer.forward(
            p, jax.tree.map(jnp.asarray, batch), jcfg)[0])(
                jax.tree.map(jnp.asarray, jp))
        params = params_from_jax(jp)
        leaves = [t.requires_grad_(True) for _, t in leaf_items(params)]
        loss, _ = transformer.forward(
            params, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
        loss.backward()
        norms[S] = (np.sqrt(sum(np.sum(np.asarray(x, np.float64) ** 2)
                                for x in jax.tree.leaves(g))),
                    float(torch.sqrt(sum((t.grad.double() ** 2).sum()
                                         for t in leaves))))
    assert abs(norms[16][1] / norms[16][0] - 1) < 0.05, norms
    assert norms[32][0] > 1e3 * norms[16][0], norms
    assert norms[32][1] > 1e3 * norms[16][1], norms
    moved = dict(jp, embed={"table": (jp["embed"]["table"]
                                      * (1 + 2.0 ** -20)).astype(np.float32)})
    prompt = toks[:, :21]
    for name, run in (
            ("jax", lambda p: np.asarray(jtransformer.prefill(
                jax.tree.map(jnp.asarray, p), {"tokens": jnp.asarray(prompt)},
                jcfg))),
            ("port", lambda p: transformer.prefill(
                params_from_jax(p), {"tokens": torch.from_numpy(prompt)},
                tcfg).detach().numpy())):
        gap = np.abs(run(jp) - run(moved)).max(axis=(0, 2))
        assert gap[20] > 1e3 * gap[0] > 0, (name, gap)
