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

The codec routes of ``compressed_aggregate(sharded=)`` (CODEC_CASES:
signSGD with error feedback under every rule, signSGD without it, top-k
and identity with and without it, CountSketch decoded under Bulyan and
the median and with ``error_feedback=True`` under flag; each with and
without the ACTIVE mask; f = 1, ``_codec_cfg``) are held against the
JAX package's unsharded ``compressed_aggregate`` from a nonzero EF
memory, CountSketch on JAX's maps (computed here and handed to the
ranks), at ``tests/test_torch_comm.py``'s tolerances: d rtol 5e-3 / atol
5e-4 of max |d| and the FA-family weights rtol 5e-3 / atol 5e-4 (the
decoded estimates differ from JAX's in their last bits, which the FA
solve amplifies), the selections' weights exactly, the new EF memory
exactly for top-k and identity and within atol 1e-6 of its largest entry
otherwise, ``comm_bits`` rtol 1e-6 (JAX counts in float32).  Against the
port's own unsharded path on the same rank: top-k's and identity's
decoded shard and EF shard bit for bit (and d wherever the rule is
coordinate-wise), signSGD's on every trailing row one shard holds whole,
``comm_bits`` equal.  On data rounded to 0.1 (k through a tie) the
sharded top-k decodes exactly JAX's ``lax.top_k`` set at every world
size.
"""

from __future__ import annotations

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.comm import CommConfig, get_codec
from repro_torch.core.flag import FlagConfig
from repro_torch.dist.aggregation import (COORDWISE_RULES, GRAM_RULES,
                                          AggregatorConfig, aggregate_tree,
                                          compressed_aggregate, tree_gram)
from repro_torch.dist.sharded import (coord_shards, gather_flat,
                                      shard_index, sharded_tree_gram)
from repro_torch.dist.sharding import CoordShards, use_sharding
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
         "sketch": 20, "codec": 21, "ef": 22, "ties": 23}
# (codec, CommConfig.error_feedback, rule) of compressed_aggregate(sharded=)
CODEC_CASES = tuple(("signsgd", None, r) for r in RULES) + (
    ("signsgd", False, "flag"), ("topk", None, "multi_krum"),
    ("topk", False, "mean"), ("topk", None, "median"),
    ("identity", None, "krum"), ("identity", True, "trimmed_mean"),
    ("countsketch", None, "bulyan"), ("countsketch", None, "median"),
    ("countsketch", True, "flag"))
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


def _codec_cfg(name):
    # f = 1: at f = 2 the masked Bulyan (6 active) keeps 1 of its 2 picks
    # a coordinate, the one nearer their midpoint -- a tie in real
    # arithmetic that fp32 rounding decides, and a decoded estimate
    # differs from JAX's in its last bits (signSGD's scale, a sketch
    # bucket's sum)
    return AggregatorConfig(name=name, f=1,
                            flag=FlagConfig(lam=2.0, m=3, tol=0.0))


def _layout():
    return layout_of({"a": torch.empty(SHAPES[0]),
                      "b": {"c": torch.empty(SHAPES[1]),
                            "d": torch.empty(SHAPES[2])}})


def _comm(codec, ef):
    return CommConfig(codec=codec, error_feedback=ef)


def _port_codec(codec, ef, maps):
    """The port's codec; CountSketch on JAX's maps (``maps[i]``: leaf i's
    bucket and sign as numpy arrays)."""
    c = get_codec(_comm(codec, ef))
    if codec == "countsketch":
        c._maps = lambda n, i: (torch.from_numpy(maps[i][0]),
                                torch.from_numpy(maps[i][1]))
    return c


def _codec_cases(X, E, Xt, shards, s, mask, maps, mesh):
    """Every CODEC_CASES case sharded (d gathered from the ranks'
    blocks) and on the whole stack (each rank runs both), and top-k on the
    tie-laden stack ``Xt``."""
    layout, out = _layout(), {}
    for codec, ef, name in CODEC_CASES:
        comm = _comm(codec, ef)
        for masked in (False, True):
            m = mask if masked else None
            Xs, X1 = shards.local(X, s), X.clone()
            efs = shards.local(E, s) if comm.wants_ef else None
            ef1 = E.clone() if comm.wants_ef else None
            d, aux, new = compressed_aggregate(
                Xs, _codec_cfg(name), comm, efs, layout=layout, mask=m,
                codec=_port_codec(codec, ef, maps), sharded=True)
            d = gather_flat(d, shards, mesh)
            d1, aux1, _ = compressed_aggregate(
                X1, _codec_cfg(name), comm, ef1, layout=layout, mask=m,
                codec=_port_codec(codec, ef, maps))
            assert new is efs
            out[("codec", codec, ef, name, masked)] = {
                "d": d.numpy(), "w": aux["weights"].numpy(),
                "bits": float(aux["comm_bits"]), "dec": Xs.numpy(),
                "ef": None if efs is None else efs.numpy(),
                "d1": d1.numpy(), "w1": aux1["weights"].numpy(),
                "bits1": float(aux1["comm_bits"]),
                "dec1": shards.local(X1, s).numpy(),
                "ef1": None if ef1 is None else shards.local(ef1, s).numpy()}
    Xs = shards.local(Xt, s)
    compressed_aggregate(Xs, _cfg("median"), _comm("topk", False),
                         layout=layout, sharded=True)
    out["ties"] = Xs.numpy()
    return out


def _rank(rank, trees, maps):
    """One rank of a world: every case on its coordinate shards, each
    sharded d gathered from the ranks' blocks."""
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
                    d = gather_flat(d, shards, mesh)
                    out[("rule", name, masked)] = (d.numpy(),
                                                   aux["weights"].numpy())
            K = tree_gram(X["gram"])
            for name in sorted(GRAM_RULES) + ["bulyan"]:
                d, aux = aggregate_tree(Xs["gram"].clone(), _cfg(name),
                                        gram=K, sharded=mesh,
                                        leaf_sizes=SIZES)
                d = gather_flat(d, shards, mesh)
                d1, aux1 = aggregate_tree(X["gram"].clone(), _cfg(name),
                                          gram=K)
                out[("gram", name)] = (d.numpy(), aux["weights"].numpy(),
                                       d1.numpy(), aux1["weights"].numpy())
            for name in sorted(COORDWISE_RULES):
                for m in (None, mask):
                    d, _ = aggregate_tree(Xs["coord"].clone(), _cfg(name),
                                          mask=m, sharded=True,
                                          leaf_sizes=SIZES)
                    d = gather_flat(d, shards, mesh)
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
            d = gather_flat(d, shards, mesh)
            d1, aux1, _ = compressed_aggregate(X["sketch"].clone(),
                                               _cfg("flag"), comm,
                                               layout=layout)
            out["sketch"] = (d.numpy(), aux["weights"].numpy(),
                             float(aux["comm_bits"]), d1.numpy(),
                             aux1["weights"].numpy(),
                             float(aux1["comm_bits"]))
            out.update(_codec_cases(X["codec"], X["ef"], X["ties"], shards, s,
                                    mask, maps, mesh))
        return out
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def trees():
    out = {k: _leaves(seed) for k, seed in SEEDS.items()}
    # a nonzero EF memory at a twentieth of the gradients' scale, and
    # gradients rounded to 0.1 (top-k's k-th |g| falls in a tie)
    out["ef"] = [0.05 * l for l in out["ef"]]
    out["ties"] = [np.round(l, 1) for l in out["ties"]]
    return out


@pytest.fixture(scope="module")
def sketch_maps():
    """JAX's CountSketch maps of the three leaves, as numpy arrays."""
    from repro.comm import compressors as jcomp
    jcodec = jcomp.get_codec(jcomp.CommConfig(codec="countsketch"))
    return [tuple(np.array(x) for x in jcodec._maps(n, i))
            for i, n in enumerate(SIZES)]


@pytest.fixture(scope="module")
def worlds(trees, sketch_maps):
    """R -> the ranks' results, each world started at its first use."""
    cache = {}

    def get(R):
        if R not in cache:
            cache[R] = spawn(_rank, R, trees, sketch_maps,
                             timeout=SPAWN_TIMEOUT)
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


@pytest.fixture(scope="module")
def jax_codec_refs(trees):
    """JAX's unsharded compressed_aggregate of every CODEC_CASES case
    (its own CountSketch maps, which the ranks carry): flat d, weights,
    the new EF memory (flat, (W, N)) and comm_bits."""
    import jax.numpy as jnp
    from repro.comm import compressors as jcomp
    from repro.core.flag import FlagConfig as JFlag
    from repro.dist.aggregation import (AggregatorConfig as JCfg,
                                        compressed_aggregate as jcomp_agg)
    tree, ef_tree = _jax_tree(trees["codec"]), _jax_tree(trees["ef"])
    refs = {}
    for codec, ef, name in CODEC_CASES:
        jcomm = jcomp.CommConfig(codec=codec, error_feedback=ef)
        cfg = JCfg(name=name, f=1, flag=JFlag(lam=2.0, m=3, tol=0.0))
        for masked in (False, True):
            d, aux, new = jcomp_agg(
                tree, cfg, jcomm, ef_tree if jcomm.wants_ef else None,
                mask=jnp.asarray(ACTIVE, jnp.float32) if masked else None)
            refs[(codec, ef, name, masked)] = (
                _flat(d), np.asarray(aux["weights"]),
                None if new is None else _stack(
                    [np.asarray(x) for x in
                     (new["a"], new["b"]["c"], new["b"]["d"])]).numpy(),
                float(aux["comm_bits"]))
    return refs


def _whole_rows(R: int, s: int) -> np.ndarray:
    """(width,) bool: the local columns of shard s whose trailing row the
    shard holds whole (signSGD's scale there has the one-device bits)."""
    shards = CoordShards(SIZES, R)
    out = np.zeros(shards.width, bool)
    for (i, off, lo, hi), shape in zip(shards.cols(s), SHAPES):
        last = shape[-1]
        g = np.arange(lo, hi)
        whole = (g // last * last >= lo) & ((g // last + 1) * last <= hi)
        out[off:off + hi - lo] = whole
    return out


CASE_IDS = [f"{c}-{'ef' if _comm(c, e).wants_ef else 'noef'}-{n}"
            for c, e, n in CODEC_CASES]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", CODEC_CASES, ids=CASE_IDS)
@pytest.mark.parametrize("R", WORLDS)
def test_codec_route_matches_jax(R, case, masked, worlds, jax_codec_refs):
    """The sharded codec route against JAX's unsharded one: d, weights,
    the new EF memory (the ranks' shards put back in canonical order) and
    comm_bits; absent workers weigh 0 and keep their EF rows."""
    codec, ef, name = case
    key = ("codec", codec, ef, name, masked)
    res = worlds(R)
    for r in res[1:]:
        for f in ("d", "w"):
            np.testing.assert_array_equal(r[key][f], res[0][key][f])
    got = res[0][key]
    d_j, w_j, ef_j, bits_j = jax_codec_refs[(codec, ef, name, masked)]
    assert got["d"].shape == (sum(SIZES),)
    if masked:
        assert np.all(got["w"][~ACTIVE] == 0.0)
    # test_torch_comm.py's tolerances: the decoded estimates differ from
    # JAX's in their last bits (signSGD's scale, a bucket's sum), which
    # the FA solve amplifies; picks are exact
    exact_w = name not in ("flag", "pca", "geomed", "mean")
    np.testing.assert_allclose(got["w"], w_j, rtol=0 if exact_w else 5e-3,
                               atol=0 if exact_w else 5e-4)
    scale = np.abs(d_j).max()
    np.testing.assert_allclose(got["d"] / scale, d_j / scale, rtol=5e-3,
                               atol=5e-4)
    assert got["bits"] == pytest.approx(bits_j, rel=1e-6)
    assert (got["ef"] is None) == (ef_j is None)
    if ef_j is None:
        return
    shards = CoordShards(SIZES, R)
    W = ef_j.shape[0]
    new = np.stack([shards.gather(torch.from_numpy(
        np.stack([r[key]["ef"][w] for r in res])),
        torch.empty(sum(SIZES))).numpy() for w in range(W)])
    exact = codec in ("topk", "identity")
    np.testing.assert_allclose(new, ef_j, rtol=0,
                               atol=0 if exact else 1e-6 * np.abs(ef_j).max())
    if masked:
        E = _stack(_leaves(SEEDS["ef"])).numpy() * np.float32(0.05)
        np.testing.assert_array_equal(new[~ACTIVE], E[~ACTIVE])


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("case", CODEC_CASES, ids=CASE_IDS)
@pytest.mark.parametrize("R", WORLDS)
def test_codec_route_matches_port_unsharded(R, case, masked, worlds):
    """Each rank's decoded shard and EF shard against the same columns of
    the port's unsharded round: top-k and identity bit for bit (and d
    under a coordinate-wise rule), signSGD on every row a shard holds
    whole (a cut row's scale sums its parts over the ranks) and within
    rtol 1e-6 elsewhere, CountSketch within atol 1e-6 of the largest
    entry (a bucket sums its ranks' parts); comm_bits equal."""
    codec, ef, name = case
    for s, r in enumerate(worlds(R)):
        got = r[("codec", codec, ef, name, masked)]
        assert got["bits"] == got["bits1"]
        pairs = [(got["dec"], got["dec1"])]
        if got["ef"] is not None:
            pairs.append((got["ef"], got["ef1"]))
        for j, (a, b) in enumerate(pairs):
            if codec in ("topk", "identity"):
                np.testing.assert_array_equal(a, b)
            elif codec == "signsgd":
                whole = _whole_rows(R, s)
                np.testing.assert_array_equal(a[:, whole], b[:, whole])
                # the decoded: a cut row's scale; the EF: h less it
                np.testing.assert_allclose(
                    a, b, rtol=1e-6 if j == 0 else 0,
                    atol=0 if j == 0 else 1e-6 * np.abs(b).max())
            else:
                np.testing.assert_allclose(a, b, rtol=0,
                                           atol=1e-6 * np.abs(b).max())
        if codec in ("topk", "identity") and name in COORDWISE_RULES:
            np.testing.assert_array_equal(got["d"], got["d1"])


@pytest.mark.parametrize("R", WORLDS)
def test_sharded_topk_keeps_lax_top_k_set_on_ties(R, worlds, trees):
    """Gradients rounded to 0.1: every leaf row's k-th |g| is tied, and
    each rank's decoded columns are those of JAX's decode (lax.top_k's
    set, lowest index first among the ties), at every world size."""
    from repro.comm import compressors as jcomp
    import jax.numpy as jnp
    jcodec = jcomp.get_codec(jcomp.CommConfig(codec="topk"))
    tree = [jnp.asarray(l) for l in trees["ties"]]
    want = _stack([np.asarray(x) for x in
                   jcodec.decode(jcodec.encode(tree), tree)])
    a = np.abs(trees["ties"][0].reshape(9, -1))
    t = -np.sort(-a, axis=1)[:, 255:256]
    # k = 256 cuts through the tie at the k-th |g| in 8 of the 9 rows
    assert ((a > t).sum(1) < 256).all() and ((a >= t).sum(1) > 256).sum() == 8
    shards = CoordShards(SIZES, R)
    for s, r in enumerate(worlds(R)):
        np.testing.assert_array_equal(r["ties"],
                                      shards.local(want, s).numpy())
