"""Port parity for the serving path: prefill logits, per-position decode
logits and KV caches, the greedy decode loop (full-length and ring-buffer
caches), the loop's validation errors, and the serving CLI, each against
the JAX package on the same weights (``weights.params_from_jax``) and the
same numpy tokens.  The smoke config computes in fp32.

Tolerance: logits to 1e-4 absolute (they are O(1)): fp32 throughout, the
sums taken in another order (the JAX prefill's online softmax over key
chunks against one softmax here; einsum against matmul).  Caches to 1e-5:
they hold k and v, two fp32 projections and a rotation deep.
"""

from __future__ import annotations

import functools
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
from repro_torch import device as tdevice
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.dist import serve_step
from repro_torch.launch import serve as tlaunch
from repro_torch.models import transformer
from repro_torch.weights import leaf_items, params_from_jax

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

LOGIT_TOL = 1e-4
CACHE_TOL = 1e-5


def _cfgs(window=None):
    jcfg = jax_reduce(jax_get_config("smollm-360m")).replace(
        frontend=None, num_prefix_embeds=0, window=window)
    return jcfg, reduce_for_smoke(get_config("smollm-360m")).replace(
        window=window)


@pytest.fixture(scope="module")
def weights():
    jcfg, _ = _cfgs()
    jp = jax.tree.map(np.asarray,
                      jtransformer.init_params(jax.random.PRNGKey(0), jcfg))
    return jp, params_from_jax(jp)


def _tokens(seed, shape, vocab):
    return np.random.default_rng(seed).integers(0, vocab, shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("window", [None, 4])
def test_prefill_logits_match_jax(weights, window):
    jp, params = weights
    jcfg, cfg = _cfgs(window)
    toks = _tokens(1 + (window or 0), (2, 24), cfg.vocab_size)
    want = np.asarray(jserve.build_prefill_step(jcfg)(
        jax.tree.map(jnp.asarray, jp), {"tokens": jnp.asarray(toks)}))
    got = serve_step.build_prefill_step(cfg)(
        params, {"tokens": torch.from_numpy(toks)})
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=LOGIT_TOL)


def _close_caches(got, want):
    g, w = leaf_items(got), jax.tree_util.tree_leaves(want)
    assert len(g) == len(w) == 4          # body[0..1].{k, v}
    for (path, t), a in zip(g, w):
        assert tuple(t.shape) == a.shape, path
        np.testing.assert_allclose(t.float().numpy(),
                                   np.asarray(a, np.float32), rtol=0,
                                   atol=CACHE_TOL, err_msg=str(path))


@pytest.mark.parametrize("window,max_len", [(None, 10), (4, 10)])
def test_decode_steps_match_jax(weights, window, max_len):
    """Logits at every position and the caches after every step; with
    window 4 < max_len the caches are ring buffers of 4 slots."""
    jp, params = weights
    jcfg, cfg = _cfgs(window)
    toks = _tokens(2, (2, max_len - 1), cfg.vocab_size)
    jstep = jax.jit(functools.partial(jtransformer.decode_step, cfg=jcfg,
                                      max_len=max_len))
    jparams = jax.tree.map(jnp.asarray, jp)
    jc = jtransformer.init_caches(jcfg, 2, max_len, jnp.float32)
    tc = transformer.init_caches(cfg, 2, max_len, torch.float32)
    clen = 4 if window else max_len
    assert tc["body"][1]["k"].shape == (1, 2, 2, clen, 64)
    for t in range(toks.shape[1]):
        want, jc = jstep(jparams, jnp.asarray(toks[:, t:t + 1]), jc,
                         step=jnp.asarray(t, jnp.int32))
        with torch.no_grad():
            got, tc = transformer.decode_step(
                params, torch.from_numpy(toks[:, t:t + 1]), tc, t, cfg,
                max_len=max_len)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=LOGIT_TOL, err_msg=f"step {t}")
        _close_caches(tc, jc)


def test_default_cache_dtype_is_bf16_as_in_jax():
    jcfg, cfg = _cfgs()
    jc = jtransformer.init_caches(jcfg, 2, 6)
    tc = transformer.init_caches(cfg, 2, 6)
    for (_, t), a in zip(leaf_items(tc), jax.tree_util.tree_leaves(jc)):
        assert t.dtype == torch.bfloat16 and a.dtype == jnp.bfloat16
        assert tuple(t.shape) == a.shape and not t.any()


@pytest.mark.parametrize("window,prompt,gen,max_len",
                         [(None, 5, 4, 10), (4, 6, 5, 12)])
def test_decode_loop_matches_jax(weights, window, prompt, gen, max_len):
    jp, params = weights
    jcfg, cfg = _cfgs(window)
    prompts = _tokens(3 + prompt, (2, prompt), cfg.vocab_size)
    want = np.asarray(jserve.decode_loop(
        jax.tree.map(jnp.asarray, jp), jcfg, jnp.asarray(prompts),
        num_steps=gen, max_len=max_len))
    got = serve_step.decode_loop(params, cfg, torch.from_numpy(prompts),
                                 num_steps=gen, max_len=max_len)
    assert got.dtype == torch.int32 and got.shape == (2, gen)
    np.testing.assert_array_equal(got.numpy(), want)


def test_decode_loop_first_token_is_prefill_argmax(weights):
    """Generated token 0 is the greedy token of the prompt's last position,
    which prefill computes in one pass."""
    _, params = weights
    _, cfg = _cfgs()
    prompts = torch.from_numpy(_tokens(4, (2, 7), cfg.vocab_size))
    first = serve_step.decode_loop(params, cfg, prompts, num_steps=1,
                                   max_len=8)
    logits = serve_step.build_prefill_step(cfg)(params, {"tokens": prompts})
    assert torch.equal(first[:, 0].long(), logits[:, -1].argmax(-1))


@pytest.mark.parametrize("prompt_len,num_steps,max_len,match", [
    (0, 2, 8, "non-empty prompt"),
    (3, 0, 8, "num_steps >= 1"),
    (5, 4, 8, "exceeds max_len=8"),
])
def test_decode_loop_validation_errors(weights, prompt_len, num_steps,
                                       max_len, match):
    jp, params = weights
    jcfg, cfg = _cfgs()
    prompts = np.zeros((2, prompt_len), np.int32)
    with pytest.raises(ValueError, match=match):
        jserve.decode_loop(jax.tree.map(jnp.asarray, jp), jcfg,
                           jnp.asarray(prompts), num_steps=num_steps,
                           max_len=max_len)
    with pytest.raises(ValueError, match=match):
        serve_step.decode_loop(params, cfg, torch.from_numpy(prompts),
                               num_steps=num_steps, max_len=max_len)


def test_launch_serve_cli_runs_on_cpu(capsys):
    out = tlaunch.main(["--debug", "--device", "cpu", "--batch", "2",
                        "--prompt-len", "6", "--gen", "3"])
    line = capsys.readouterr().out.splitlines()[0]
    assert line.startswith("arch=smollm-360m-smoke batch=2 prefill 6 steps")
    assert "decode 3 steps" in line and line.endswith("tok/s)")
    assert out["tokens"].shape == (2, 3) and out["prompts"].shape == (2, 6)
    assert out["tok_per_s"] > 0


def test_launch_serve_refuses_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tdevice.resolve_device("cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tlaunch.main(["--debug"])


@pytest.mark.parametrize("argv,match", [
    (["--prompt-len", "0"], "non-empty prompt"),
    (["--gen", "0"], "num_steps >= 1")])
def test_launch_serve_cli_checks_lengths(argv, match):
    """The CLI holds its lengths to decode_loop's checks before any step."""
    with pytest.raises(ValueError, match=match):
        tlaunch.main(["--debug", "--device", "cpu", "--batch", "1", *argv])
