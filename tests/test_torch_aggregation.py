"""Port parity: aggregate_tree and the attack library against the JAX
package on worker-major trees of numpy leaves (the port reads them packed
into its (W, N) buffer, columns in jax.tree.leaves order)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attacks as jattacks
from repro.core.flag import FlagConfig as JFlagConfig
from repro.dist.aggregation import (AggregatorConfig as JAggregatorConfig,
                                    aggregate_tree as jax_aggregate_tree)
from repro_torch.comm import CommConfig
from repro_torch.core import attacks as tattacks
from repro_torch.core.flag import FlagConfig
from repro_torch.dist.aggregation import (AggregatorConfig, aggregate_tree,
                                          compressed_aggregate, tree_gram)
from repro_torch.weights import pack_workers


def _tree(seed: int, W: int, f: int = 2):
    """Worker-major tree: shared signal + noise, the first f rows large."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (8, 6), "b": {"c": (300,), "d": (4, 3, 2)}, "e": (5,)}

    def leaf(shape):
        mu = rng.normal(size=shape)
        x = mu[None] + 0.5 * rng.normal(size=(W,) + shape)
        x[:f] = rng.uniform(-8.0, 8.0, size=(f,) + shape)
        return x.astype(np.float32)
    return jax.tree.map(leaf, shapes, is_leaf=lambda s: isinstance(s, tuple))


def _flat_jax(d_tree) -> np.ndarray:
    return np.concatenate([np.asarray(x).reshape(-1)
                           for x in jax.tree.leaves(d_tree)])


RULES = ["flag", "pca", "mean", "geomed", "krum", "multi_krum", "median",
         "trimmed_mean", "meamed", "phocas", "bulyan"]
MASK = np.array([1, 1, 0, 1, 1, 1, 0, 1, 1], np.float32)


# Tolerance: rtol 5e-3 / atol 5e-4 relative to |d|'s scale, as the
# reference's own tree-vs-flat FA checks (tests/test_properties.py).
@pytest.mark.parametrize("name", RULES)
@pytest.mark.parametrize("W,lam", [(6, 0.0), (9, 9.0)])
@pytest.mark.parametrize("masked", [False, True])
def test_aggregate_tree_matches_jax(name, W, lam, masked):
    tree = _tree(10 + W, W)
    X, layout = pack_workers(tree)
    flag = dict(lam=lam, regularizer="pairwise" if lam else "none")
    mask = MASK[:W] if masked else None
    d, aux = aggregate_tree(
        X, AggregatorConfig(name=name, f=2, flag=FlagConfig(**flag)),
        mask=None if mask is None else torch.from_numpy(mask))
    jd, jaux = jax_aggregate_tree(
        jax.tree.map(jnp.asarray, tree),
        JAggregatorConfig(name=name, f=2, flag=JFlagConfig(**flag),
                          impl="xla"),
        mask=None if mask is None else jnp.asarray(mask))
    want = _flat_jax(jd)
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(d.numpy() / scale, want / scale,
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(aux["weights"].numpy(),
                               np.asarray(jaux["weights"]),
                               rtol=5e-3, atol=5e-4)
    assert d.shape == (layout.numel,)
    if masked:
        assert (aux["weights"].numpy()[mask == 0] == 0).all()


@pytest.mark.parametrize("name", ["flag", "mean"])
def test_aggregate_tree_matches_jax_pallas_kernels(name):
    """With impl='pallas_interpret' the JAX Pallas kernels themselves are
    the oracle (tiny size: the interpreter is slow)."""
    tree = _tree(77, 5)
    X, _ = pack_workers(tree)
    d, aux = aggregate_tree(X, AggregatorConfig(
        name=name, f=1, flag=FlagConfig(lam=2.0), sketch_stride=2))
    jd, jaux = jax_aggregate_tree(
        jax.tree.map(jnp.asarray, tree),
        JAggregatorConfig(name=name, f=1, flag=JFlagConfig(lam=2.0),
                          sketch_stride=2, impl="pallas_interpret"))
    want = _flat_jax(jd)
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(d.numpy() / scale, want / scale,
                               rtol=5e-3, atol=5e-4)
    np.testing.assert_allclose(aux["weights"].numpy(),
                               np.asarray(jaux["weights"]),
                               rtol=5e-3, atol=5e-4)


def test_aggregate_tree_mask_and_gram_override():
    tree = _tree(5, 8)
    X, _ = pack_workers(tree)
    mask = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)
    cfg = AggregatorConfig(name="flag", f=2, flag=FlagConfig(lam=3.0))
    d, aux = aggregate_tree(X, cfg, mask=torch.from_numpy(mask))
    jd, jaux = jax_aggregate_tree(
        jax.tree.map(jnp.asarray, tree),
        JAggregatorConfig(name="flag", f=2, flag=JFlagConfig(lam=3.0)),
        mask=jnp.asarray(mask))
    np.testing.assert_allclose(aux["weights"].numpy(),
                               np.asarray(jaux["weights"]),
                               rtol=5e-3, atol=5e-4)
    assert (aux["weights"].numpy()[mask == 0] == 0).all()
    K = tree_gram(X)
    d2, aux2 = aggregate_tree(X, cfg, gram=K, mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(d2.numpy(), d.numpy())


def test_unknown_rule_raises():
    with pytest.raises(KeyError, match="unknown aggregator 'nope'.*bulyan"):
        aggregate_tree(torch.zeros((4, 10)), AggregatorConfig(name="nope"))


@pytest.mark.parametrize("name", ["median", "trimmed_mean", "meamed",
                                  "phocas"])
def test_coordinate_rules_refuse_a_gram(name):
    X = torch.zeros((4, 10))
    with pytest.raises(ValueError, match="coordinate-wise"):
        aggregate_tree(X, AggregatorConfig(name=name), gram=tree_gram(X))


def test_compressed_aggregate_passthrough():
    X, _ = pack_workers(_tree(3, 4))
    d, aux, ef = compressed_aggregate(X, AggregatorConfig(name="mean"))
    assert ef is None
    np.testing.assert_allclose(d.numpy(), X.numpy().mean(0), rtol=1e-5,
                               atol=1e-6)
    assert float(aux["comm_bits"]) == X.numel() * 32
    with pytest.raises(ValueError, match="layout"):   # codecs act per leaf
        compressed_aggregate(X, AggregatorConfig(),
                             CommConfig(codec="signsgd"), torch.zeros_like(X))


# ---------------------------------------------------------------------------
# attacks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["none", "sign_flip", "zero", "ipm",
                                  "alie"])
def test_deterministic_attacks_match_jax(name):
    tree = _tree(21, 7, f=0)
    X, layout = pack_workers(tree)
    got = tattacks.apply_attack(name, X.clone(), 3,
                                leaf_sizes=layout.sizes).numpy()
    want = jattacks.apply_attack_tree(name, jax.tree.map(jnp.asarray, tree),
                                      jax.random.PRNGKey(0), 3)
    want = np.concatenate([np.asarray(x).reshape(7, -1)
                           for x in jax.tree.leaves(want)], axis=1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", ["random", "gaussian", "drop"])
def test_random_attacks_shape_support_scale(name):
    """Random draws cannot match jax.random's; check what they must do."""
    tree = _tree(22, 6, f=0)
    X, layout = pack_workers(tree)
    f = 2
    out = tattacks.apply_attack(name, X.clone(), f, leaf_sizes=layout.sizes,
                                seed=5)
    assert out.shape == X.shape
    np.testing.assert_array_equal(out[f:].numpy(), X[f:].numpy())
    assert not torch.equal(out[:f], X[:f])
    again = tattacks.apply_attack(name, X.clone(), f,
                                  leaf_sizes=layout.sizes, seed=5)
    np.testing.assert_array_equal(again.numpy(), out.numpy())
    for a, s in zip(layout.offsets, layout.sizes):
        leaf, byz = X[:, a:a + s], out[:f, a:a + s]
        if name == "random":       # uniform in +-max|leaf|
            assert byz.abs().max() <= leaf.abs().max()
        elif name == "gaussian":   # N(0, std(leaf)^2)
            assert byz.abs().max() <= 10 * leaf.std(correction=0)
        else:                      # a zeroed subset of the worker's own
            kept = byz != 0
            assert torch.equal(byz[kept], X[:f, a:a + s][kept])
    if name == "drop":
        frac = float((out[:f] == 0).float().mean())
        assert 0.02 < frac < 0.25


def test_unknown_attack_raises():
    with pytest.raises(KeyError, match="unknown attack"):
        tattacks.apply_attack("nope", torch.zeros((3, 4)), 1)
