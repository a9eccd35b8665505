"""A whole bf16 forward of the port against JAX's on the CPU.

smollm-360m's smoke config (2 layers, d_model 256) computing in bf16,
JAX's weights carried across (``params_from_jax``), tokens from
``default_rng(1)``, B = 2, S = 20: the loss, each leaf's gradient norm
and the prefill logits against ``jax.jit``'s, and layer 0's stages
(embedding, ``norm1``, the q / k / v projections, the MLP) bit for bit.

Readings (JAX 0.9, torch 2.13, CPU): loss 6.785701 (JAX) and 6.786244
(port); the logits 22.4 % bit-equal, at most 0.03125 apart at |logit| <=
4.125 (one bf16 ulp at that scale); the per-leaf gradient norms within
0.22 % (the layer-1 norms' scales).  Layer 0's embedding, norm,
projections and MLP are the same bits; ``attend`` is ~99.98 % equal (1
ulp) and the block ~99.3 %: fp32 sums in another order in attention
(JAX's chunked ``xla_flash`` against the port's plain ``attend``), which
the later layers and the head carry on.  ``jax.jit`` and eager JAX give
the same logits bit for bit, so JAX's compiled forward keeps no excess
precision the port would have to follow.
"""

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
from repro.models import layers as jlayers
from repro.models import mlp as jmlp
from repro.models import transformer as jtransformer
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import layers, mlp, transformer
from repro_torch.weights import leaf_items, map_tree, params_from_jax

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

B, S = 2, 20
# loss: an fp32 mean of B * S token losses whose logits differ by about a
# bf16 ulp in ~3/4 of their entries (reading: 8.0e-5 relative)
LOSS_RTOL = 2e-4
# logits: within 2 bf16 ulps of the logits' largest magnitude (reading:
# 1 ulp, 0.03125 at |logit| <= 4.125)
LOGIT_ULPS = 2
# each leaf's gradient norm: two bf16 ulps relative (2^-7); the
# gradients are bf16 products of cotangents that differ by an ulp where
# the forward did (reading: 0.22 %, the layer-1 norms' scales)
GRAD_NORM_RTOL = 2.0 ** -7


def _cfgs():
    jcfg = jax_reduce(jax_get_config("smollm-360m")).replace(
        compute_dtype="bfloat16", frontend=None, num_prefix_embeds=0)
    tcfg = reduce_for_smoke(get_config("smollm-360m")).replace(
        compute_dtype="bfloat16")
    return jcfg, tcfg


@pytest.fixture(scope="module")
def run():
    """JAX's and the port's loss, gradients and prefill logits."""
    jcfg, tcfg = _cfgs()
    np_params = jax.tree.map(np.asarray, jtransformer.init_params(
        jax.random.PRNGKey(0), jcfg))
    toks = np.random.default_rng(1).integers(
        0, jcfg.vocab_size, size=(B, S + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jp, jb = (jax.tree.map(jnp.asarray, t) for t in (np_params, batch))
    (jloss, _), jgrad = jax.jit(jax.value_and_grad(
        lambda p: jtransformer.forward(p, jb, jcfg), has_aux=True))(jp)
    jlogits = jax.jit(lambda p: jtransformer.prefill(
        p, {"tokens": jb["tokens"]}, jcfg))(jp)
    eager = jtransformer.prefill(jp, {"tokens": jb["tokens"]}, jcfg)

    params = params_from_jax(np_params)
    leaves = [t.requires_grad_(True) for _, t in leaf_items(params)]
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, _ = transformer.forward(params, tb, tcfg)
    loss.backward()
    with torch.no_grad():
        logits = transformer.prefill(params, {"tokens": tb["tokens"]}, tcfg)
    return {"np_params": np_params, "tokens": batch["tokens"],
            "jax_loss": float(jloss), "loss": float(loss.detach()),
            "jax_grads": [np.asarray(g, np.float32)
                          for g in jax.tree.leaves(jgrad)],
            "grads": [t.grad.numpy() for t in leaves],
            "paths": [p for p, _ in leaf_items(params)],
            "jax_logits": np.asarray(jlogits, np.float32),
            "jax_eager_logits": np.asarray(eager, np.float32),
            "logits": logits.float().numpy()}


def test_loss_matches_jax(run):
    assert math.isfinite(run["loss"])
    np.testing.assert_allclose(run["loss"], run["jax_loss"], rtol=LOSS_RTOL)


def test_prefill_logits_within_bf16_ulps_of_jax(run):
    got, want = run["logits"], run["jax_logits"]
    assert got.shape == want.shape == (B, S, 512)
    scale = float(np.abs(want).max())
    ulp = 2.0 ** (math.floor(math.log2(scale)) - 7)
    assert np.abs(got - want).max() <= LOGIT_ULPS * ulp
    # JAX's compiled forward keeps no excess precision: eager is the same
    np.testing.assert_array_equal(run["jax_eager_logits"], want)


def test_gradient_norms_per_leaf_match_jax(run):
    assert len(run["grads"]) == len(run["jax_grads"])
    for path, g, jg in zip(run["paths"], run["grads"], run["jax_grads"]):
        assert g.shape == jg.shape, path
        a, b = float(np.linalg.norm(g)), float(np.linalg.norm(jg))
        assert math.isfinite(a) and abs(a - b) <= GRAD_NORM_RTOL * b, (
            path, a, b)


@pytest.mark.parametrize("stage", ["embed", "norm1", "wq", "wk", "wv",
                                   "mlp"])
def test_layer0_stages_are_bit_equal(run, stage):
    """Layer 0's stages on the same input, JAX under ``jax.jit``: the
    same bits (the products accumulate bf16 x bf16 in fp32 and round
    once; the norm and the gated silu round as JAX's do)."""
    jcfg, tcfg = _cfgs()
    cdt, bf = torch.bfloat16, jnp.bfloat16
    npp = run["np_params"]
    blk = jax.tree.map(lambda a: a[0], npp["body"][0])
    tblk = map_tree(lambda a: torch.from_numpy(np.array(a)), blk)
    tok = run["tokens"]

    def jax_stage(p, emb, ids):
        x = jlayers.embed(emb, ids, bf)
        h = jlayers.apply_norm(p["norm1"], x, jcfg.norm)
        out = {"embed": x, "norm1": h,
               "mlp": jmlp.mlp_apply(p["ffn"], jlayers.apply_norm(
                   p["norm2"], x, jcfg.norm), jcfg)}
        for w in ("wq", "wk", "wv"):
            out[w] = jlayers.linear(p["mixer"][w], h, bf)
        return out[stage]
    want = np.asarray(jax.jit(jax_stage)(
        blk, jax.tree.map(jnp.asarray, npp["embed"]), jnp.asarray(tok)
    ).astype(jnp.float32))

    emb = {"table": torch.from_numpy(np.array(npp["embed"]["table"]))}
    with torch.no_grad():
        x = layers.embed(emb, torch.from_numpy(tok), cdt)
        h = layers.apply_norm(tblk["norm1"], x, tcfg.norm)
        got = {"embed": lambda: x, "norm1": lambda: h,
               "mlp": lambda: mlp.mlp_apply(tblk["ffn"], layers.apply_norm(
                   tblk["norm2"], x, tcfg.norm), tcfg),
               **{w: (lambda w=w: layers.linear(tblk["mixer"][w], h, cdt))
                  for w in ("wq", "wk", "wv")}}[stage]()
    assert got.dtype == cdt
    np.testing.assert_array_equal(got.float().numpy(), want)
