"""The dense configurations the registry carries over from the JAX
package beside smollm-360m -- stablelm-1.6b (LayerNorm, partial RoPE on
25 % of the head, MHA), starcoder2-15b (LayerNorm with biases, plain GELU
MLP, GQA) and command-r-35b (LayerNorm, tied embeddings, RoPE theta 8e6)
-- each held against the JAX package on its ``reduce_for_smoke`` config
(fp32 compute) with JAX's weights carried across: the config itself, the
parameter tree, the training loss and gradients, prefill logits and 12
decode steps; and the full configs' parameter counts.  They need no new
code path: each option already runs for smollm-360m or recurrentgemma-9b.

Tolerances as tests/test_torch_recurrent_models.py states them: the loss
to rtol 1e-5 (an fp32 forward), gradients to rtol 1e-3 with atol 1e-5 of
the leaf's largest |g|, logits to 2e-4 absolute.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JAX_ARCHS
from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import transformer as jtransformer
from repro_torch.checkpoint.checkpoint import keystr
from repro_torch.configs import ARCHS as PORT_ARCHS
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import transformer
from repro_torch.weights import leaf_items, params_from_jax

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

ARCHS = ("stablelm-1.6b", "starcoder2-15b", "command-r-35b")
LOGIT_TOL = 2e-4
B, S, DECODE_STEPS, DECODE_MAX = 2, 20, 12, 16


def _cfgs(arch):
    return (jax_reduce(jax_get_config(arch)),
            reduce_for_smoke(get_config(arch)))


@pytest.mark.parametrize("arch", sorted(JAX_ARCHS))
def test_config_is_a_copy_of_jax(arch):
    """The port's registry holds every JAX config, in JAX's order, and
    each carries every JAX field but ``remat`` and ``scan_layers`` (the
    port runs the layer loop eagerly), equal to JAX's."""
    assert list(PORT_ARCHS) == list(JAX_ARCHS)
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    jf = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    for f in dataclasses.fields(tcfg):
        want = jf.pop(f.name)
        got = getattr(tcfg, f.name)
        if f.name == "moe" and got is not None:
            got, want = dataclasses.asdict(got), dataclasses.asdict(want)
        assert got == want, f.name
    assert set(jf) == {"remat", "scan_layers"}


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_config_matches_jax(arch):
    jcfg, tcfg = _cfgs(arch)
    jp = jtransformer.init_params(jax.random.PRNGKey(0), jcfg)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert [(keystr(p), tuple(t.shape)) for p, t in leaf_items(
        transformer.param_shapes_tree(tcfg))] == [
        (jax.tree_util.keystr(p), tuple(x.shape)) for p, x in flat]
    toks = np.random.default_rng(1).integers(0, 512, (B, S + 1),
                                             dtype=np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    loss, grads = jax.value_and_grad(lambda p: jtransformer.forward(
        p, jax.tree.map(jnp.asarray, batch), jcfg)[0])(jp)
    params = params_from_jax(jax.tree.map(np.asarray, jp))
    leaves = [t.requires_grad_(True) for _, t in leaf_items(params)]
    tloss, _ = transformer.forward(
        params, {k: torch.from_numpy(v) for k, v in batch.items()}, tcfg)
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), float(loss), rtol=1e-5)
    want = jax.tree.leaves(grads)
    assert len(leaves) == len(want)
    for (path, t), g in zip(leaf_items(params), want):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=1e-3,
                                   atol=1e-5 * np.abs(g).max(),
                                   err_msg=str(path))

    for t in leaves:
        t.requires_grad_(False)
    want_pre = np.asarray(jtransformer.prefill(
        jp, {"tokens": jnp.asarray(toks)}, jcfg))
    step = jax.jit(lambda p, tok, c, s: jtransformer.decode_step(
        p, tok, c, s, jcfg, max_len=DECODE_MAX))
    jc = jtransformer.init_caches(jcfg, B, DECODE_MAX, jnp.float32)
    tc = transformer.init_caches(tcfg, B, DECODE_MAX, torch.float32)
    with torch.no_grad():
        pre = transformer.prefill(params, {"tokens": torch.from_numpy(toks)},
                                  tcfg)
        np.testing.assert_allclose(pre.numpy(), want_pre, rtol=0,
                                   atol=LOGIT_TOL)
        for t in range(DECODE_STEPS):
            jl, jc = step(jp, jnp.asarray(toks[:, t:t + 1]), jc,
                          jnp.asarray(t, jnp.int32))
            tl, tc = transformer.decode_step(
                params, torch.from_numpy(toks[:, t:t + 1]), tc, t, tcfg,
                max_len=DECODE_MAX)
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=0,
                                       atol=LOGIT_TOL, err_msg=f"step {t}")


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_full_counts_match_jax(arch):
    jcfg, tcfg = jax_get_config(arch), get_config(arch)
    assert tcfg.param_count() == jtransformer.count_params_analytic(jcfg)
    assert tcfg.active_param_count() == tcfg.param_count()
    assert transformer.count_embedding_params(tcfg) == \
        jtransformer.count_embedding_params(jcfg)
