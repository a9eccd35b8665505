"""Port parity: sharded aggregation (``repro_torch.dist.sharded``) on gloo
worlds of 1, 2, 3, 4 and 8 CPU ranks, against the JAX package's
``aggregate_tree`` and against the port's own unsharded path.

Each world is started once for the module (``repro_torch.launch.ranks.
spawn``, with its own time limit); its ranks import only ``repro_torch``
(this module imports the JAX package inside the tests, never at import
time), run every case on their coordinate shards and hand the results
back.  The JAX references run here, in the pytest process, on one
device: JAX's own tests hold its sharded path equal to these single-device
functions (``tests/test_sharded_agg.py``).

The stacks have JAX's ``_tree`` shapes (W = 9; leaves of 4096, 130 and
33 x 3 coordinates: ragged on purpose, so most worlds pad), made with
numpy from explicit seeds.  Tolerances are those of
``tests/test_sharded_agg.py``: weights rtol 2e-4 / atol 2e-5 and d rtol
2e-4 / atol 2e-4 (the FA solve runs the same iteration count in both
packages: explicit m and tol 0), the Gram rtol 1e-6 / atol 5e-4 (fp32
reassociation of the coordinate sum); the combine given one Gram and the
coordinate rules are bit-identical to the unsharded port, and every rank
returns the same bits.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.comm import CommConfig
from repro_torch.core.flag import FlagConfig
from repro_torch.dist.aggregation import (COORDWISE_RULES, GRAM_RULES,
                                          AggregatorConfig, aggregate_tree,
                                          compressed_aggregate, tree_gram)
from repro_torch.dist.sharded import (coord_shards, shard_index,
                                      sharded_tree_gram)
from repro_torch.dist.sharding import use_sharding
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.ranks import spawn
from repro_torch.weights import layout_of

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

WORLDS = (1, 2, 3, 4, 8)
RULES = ["mean", "flag", "pca", "median", "trimmed_mean", "meamed",
         "phocas", "krum", "multi_krum", "bulyan", "geomed"]
ACTIVE = np.array([1, 0, 1, 1, 0, 1, 1, 0, 1], bool)
SHAPES = ((4096,), (130,), (33, 3))
SIZES = tuple(int(np.prod(s)) for s in SHAPES)
SEEDS = {"rule": 7, "masked": 8, "gram": 11, "coord": 13, "stride": 3,
         "sketch": 20}
SPAWN_TIMEOUT = 300


def _cfg(name):
    # explicit m + tol 0: both packages run the same IRLS iteration count
    return AggregatorConfig(name=name, f=2,
                            flag=FlagConfig(lam=2.0, m=3, tol=0.0))


def _leaves(seed, W=9):
    rng = np.random.default_rng(seed)
    scale = np.linspace(0.5, 2.0, W).astype(np.float32)
    return [(rng.normal(size=(W,) + s).astype(np.float32)
             * scale.reshape((W,) + (1,) * len(s))) for s in SHAPES]


def _stack(leaves) -> torch.Tensor:
    return torch.from_numpy(np.concatenate(
        [l.reshape(l.shape[0], -1) for l in leaves], axis=1))


def _jax_tree(leaves):
    import jax.numpy as jnp
    a, c, d = (jnp.asarray(l) for l in leaves)
    return {"a": a, "b": {"c": c, "d": d}}


def _flat(tree) -> np.ndarray:
    import jax
    return np.concatenate([np.asarray(x).reshape(-1)
                           for x in jax.tree.leaves(tree)])


def _rank(rank, trees):
    """One rank of a world: every case on its coordinate shards."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    try:
        mesh = make_host_mesh()
        shards = coord_shards(SIZES, mesh)
        s = shard_index(mesh)
        X = {k: _stack(v) for k, v in trees.items()}
        Xs = {k: shards.local(v, s) for k, v in X.items()}
        mask = torch.from_numpy(ACTIVE.astype(np.float32))
        out = {"shard": s, "mesh": mesh.axis_sizes}
        with use_sharding(mesh):
            for name in RULES:
                for masked in (False, True):
                    key = "masked" if masked else "rule"
                    d, aux = aggregate_tree(
                        Xs[key].clone(), _cfg(name),
                        mask=mask if masked else None, sharded=True,
                        leaf_sizes=SIZES)
                    out[("rule", name, masked)] = (d.numpy(),
                                                   aux["weights"].numpy())
            K = tree_gram(X["gram"])
            for name in sorted(GRAM_RULES) + ["bulyan"]:
                d, aux = aggregate_tree(Xs["gram"].clone(), _cfg(name),
                                        gram=K, sharded=mesh,
                                        leaf_sizes=SIZES)
                d1, aux1 = aggregate_tree(X["gram"].clone(), _cfg(name),
                                          gram=K)
                out[("gram", name)] = (d.numpy(), aux["weights"].numpy(),
                                       d1.numpy(), aux1["weights"].numpy())
            for name in sorted(COORDWISE_RULES):
                for m in (None, mask):
                    d, _ = aggregate_tree(Xs["coord"].clone(), _cfg(name),
                                          mask=m, sharded=True,
                                          leaf_sizes=SIZES)
                    d1, _ = aggregate_tree(X["coord"].clone(), _cfg(name),
                                           mask=m)
                    out[("coord", name, m is not None)] = (d.numpy(),
                                                           d1.numpy())
            out["gram1"] = sharded_tree_gram(Xs["stride"], mesh).numpy()
            out["gram4"] = sharded_tree_gram(Xs["stride"], mesh,
                                             sketch_stride=4).numpy()
            layout = layout_of({"a": torch.empty(SHAPES[0]),
                                "b": {"c": torch.empty(SHAPES[1]),
                                      "d": torch.empty(SHAPES[2])}})
            comm = CommConfig(codec="countsketch", sketch_ratio=1.0 / 8.0)
            d, aux, _ = compressed_aggregate(Xs["sketch"].clone(),
                                             _cfg("flag"), comm,
                                             layout=layout, sharded=True)
            d1, aux1, _ = compressed_aggregate(X["sketch"].clone(),
                                               _cfg("flag"), comm,
                                               layout=layout)
            out["sketch"] = (d.numpy(), aux["weights"].numpy(),
                             float(aux["comm_bits"]), d1.numpy(),
                             aux1["weights"].numpy(),
                             float(aux1["comm_bits"]))
        return out
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def trees():
    return {k: _leaves(seed) for k, seed in SEEDS.items()}


@pytest.fixture(scope="module")
def worlds(trees):
    """R -> the ranks' results, each world started at its first use."""
    cache = {}

    def get(R):
        if R not in cache:
            cache[R] = spawn(_rank, R, trees, timeout=SPAWN_TIMEOUT)
        return cache[R]
    return get


@pytest.fixture(scope="module")
def jax_refs(trees):
    from repro.dist.aggregation import (AggregatorConfig as JCfg,
                                        aggregate_tree as jagg)
    from repro.core.flag import FlagConfig as JFlag
    import jax.numpy as jnp
    refs = {}
    for name in RULES:
        cfg = JCfg(name=name, f=2, flag=JFlag(lam=2.0, m=3, tol=0.0))
        for masked in (False, True):
            tree = _jax_tree(trees["masked" if masked else "rule"])
            d, aux = jagg(tree, cfg, mask=jnp.asarray(ACTIVE, jnp.float32)
                          if masked else None)
            refs[(name, masked)] = (_flat(d), np.asarray(aux["weights"]))
    return refs


def _same_on_every_rank(results, key):
    for r in results[1:]:
        for a, b in zip(results[0][key], r[key]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("R", WORLDS)
def test_world_layout(R, worlds):
    res = worlds(R)
    assert [r["shard"] for r in res] == list(range(R))
    assert res[0]["mesh"] == {1: (1, 1), 2: (2, 1), 3: (3, 1), 4: (2, 2),
                              8: (2, 4)}[R]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", RULES)
@pytest.mark.parametrize("R", WORLDS)
def test_rule_matches_jax(R, name, masked, worlds, jax_refs):
    res = worlds(R)
    _same_on_every_rank(res, ("rule", name, masked))
    d, w = res[0][("rule", name, masked)]
    d_j, w_j = jax_refs[(name, masked)]
    assert d.shape == (sum(SIZES),)
    if masked:
        assert np.all(w[~ACTIVE] == 0.0)
    np.testing.assert_allclose(w, w_j, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(d, d_j, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("name", sorted(GRAM_RULES) + ["bulyan"])
@pytest.mark.parametrize("R", WORLDS)
def test_given_one_gram_bit_identical_to_unsharded(R, name, worlds):
    """gram= composes: with the Gram pinned, the combine (and Bulyan's
    selection and MeaMed) give the unsharded port's bits."""
    res = worlds(R)
    _same_on_every_rank(res, ("gram", name))
    d, w, d1, w1 = res[0][("gram", name)]
    np.testing.assert_array_equal(w, w1)
    np.testing.assert_array_equal(d, d1)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", sorted(COORDWISE_RULES))
@pytest.mark.parametrize("R", WORLDS)
def test_coordwise_rules_bit_identical(R, name, masked, worlds):
    res = worlds(R)
    _same_on_every_rank(res, ("coord", name, masked))
    d, d1 = res[0][("coord", name, masked)]
    np.testing.assert_array_equal(d, d1)


@pytest.mark.parametrize("R", WORLDS)
def test_gram_and_sketch_stride_match_jax_shard_views(R, worlds, trees):
    """The summed Gram equals JAX's single-device tree_gram; with
    sketch_stride 4 it equals the sum over the shards of JAX's tree_gram
    of each shard's ``_to_view`` blocks (each shard samples its own
    chunk stream)."""
    import jax.numpy as jnp
    from repro.dist.aggregation import tree_gram as jtree_gram
    from repro.dist.sharded import _to_view
    res = worlds(R)
    _same_on_every_rank(res, "gram1")
    _same_on_every_rank(res, "gram4")
    leaves = [jnp.asarray(l) for l in trees["stride"]]
    np.testing.assert_allclose(res[0]["gram1"],
                               np.asarray(jtree_gram(leaves)),
                               rtol=1e-6, atol=5e-4)
    views = [_to_view(l, R)[0] for l in leaves]
    want = sum(np.asarray(jtree_gram([v[:, s] for v in views], 4))
               for s in range(R))
    np.testing.assert_allclose(res[0]["gram4"], want, rtol=1e-6, atol=5e-4)


@pytest.mark.parametrize("R", WORLDS)
def test_countsketch_gram_feed(R, worlds):
    """Each rank sketches its columns with the leaves' maps; the reduced
    payload's Gram weights the exact combine: as the unsharded bridge,
    with the same comm_bits."""
    res = worlds(R)
    _same_on_every_rank(res, "sketch")
    d, w, bits, d1, w1, bits1 = res[0]["sketch"]
    assert bits == bits1
    np.testing.assert_allclose(w, w1, rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(d, d1, rtol=2e-4, atol=2e-4)


def test_sharded_true_without_mesh_raises(trees):
    X = _stack(trees["rule"])
    with pytest.raises(ValueError, match="needs an active mesh"):
        aggregate_tree(X, _cfg("flag"), sharded=True, leaf_sizes=SIZES)


def test_sharded_decoding_codecs_raise(trees):
    from repro_torch.launch.mesh import Mesh
    X = _stack(trees["rule"])
    layout = layout_of({"a": torch.empty(SHAPES[0]),
                        "b": {"c": torch.empty(SHAPES[1]),
                              "d": torch.empty(SHAPES[2])}})
    for codec, name in (("signsgd", "flag"), ("topk", "mean"),
                        ("countsketch", "bulyan"), ("identity", "flag")):
        with pytest.raises(NotImplementedError, match="ROADMAP.md"):
            compressed_aggregate(X, _cfg(name), CommConfig(codec=codec),
                                 layout=layout,
                                 sharded=Mesh((1, 1), ("data", "model")))
