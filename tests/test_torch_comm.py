"""Port parity for the worker->server codecs (``repro_torch.comm``) and
``compressed_aggregate``'s three routes, against ``repro.comm`` and
``repro.dist.aggregation`` on identical gradients.

Gradients are numpy arrays from explicit seeds, laid out as the port's
(W, N) buffer (columns in leaf order) and as JAX's list of (W, *shape)
leaves, for two leaf layouts: the reduced smollm-360m (20 leaves,
1,315,072 coordinates a worker) and the paper's CNN (8 leaves, 67,642; its
bias leaves of 8 and 10 coordinates keep k = round(0.5) = 0 -> 1 and
round(0.625) = 1 of them).  CountSketch runs with JAX's maps carried
across (the port draws its own from a CPU generator, which cannot match
``jax.random``'s): the tests patch the port codec's ``_maps``.

Tolerances, each from what differs between the two packages:
- signSGD's signs and top-k's kept indices and values are exact (the same
  h in, the same comparisons); signSGD's scale is a mean taken in another
  summation order, rtol 1e-6 (a few ulps of a sum of at most 512 terms);
- a CountSketch bucket sums ~16 signed coordinates in another order:
  atol 1e-6 of the sketch's largest bucket;
- ``compressed_aggregate``'s d and weights carry the FA tolerance, rtol
  5e-3 / atol 5e-4 of max |d| (``tests/test_properties.py:114``; the
  eigensolvers differ); the selections' picks are exact;
- ``comm_bits`` is exact in the port (float64) and float32 in JAX: rtol
  1e-6.

Top-k keeps ``lax.top_k``'s set even where |g| ties at the k-th place
(lowest index first): ``test_topk_keeps_lax_top_k_set_on_ties`` holds it
on data rounded to a grid.
"""

from __future__ import annotations

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import compressors as jcomp
from repro.comm.error_feedback import ef_encode_decode as jax_ef_round
from repro.core.flag import FlagConfig as JFlagConfig
from repro.dist.aggregation import AggregatorConfig as JAggregatorConfig
from repro.dist.aggregation import compressed_aggregate as jax_compressed
from repro_torch.comm import (CODECS, CommConfig, dense_bits,
                              ef_encode_decode, get_codec, init_ef,
                              majority_vote)
from repro_torch.comm import compressors as tcomp
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.flag import FlagConfig
from repro_torch.dist.aggregation import AggregatorConfig, compressed_aggregate
from repro_torch.models.cnn import cnn_init
from repro_torch.models.transformer import param_shapes_tree
from repro_torch.weights import Layout, layout_of

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def _layout(which: str) -> Layout:
    if which == "cnn":
        return layout_of(cnn_init(torch.Generator().manual_seed(0)))
    return layout_of(param_shapes_tree(reduce_for_smoke(
        get_config("smollm-360m"))))


LAYOUTS = {w: _layout(w) for w in ("smollm", "cnn")}


def _grads(seed: int, W: int, layout: Layout, f: int = 0) -> np.ndarray:
    """(W, N) fp32: per leaf a shared signal plus worker noise at a
    leaf-specific scale; the first f rows uniform in +-8 (Byzantine)."""
    rng = np.random.default_rng(seed)
    cols = []
    for n in layout.sizes:
        s = 10.0 ** rng.uniform(-3, 0)
        mu = rng.normal(size=n)
        x = s * (mu[None] + 0.5 * rng.normal(size=(W, n)))
        x[:f] = rng.uniform(-8.0, 8.0, size=(f, n))
        cols.append(x)
    return np.concatenate(cols, axis=1).astype(np.float32)


def _jax_tree(G: np.ndarray, layout: Layout) -> list:
    W = G.shape[0]
    return [jnp.asarray(G[:, o:o + n].reshape((W,) + shape))
            for o, n, shape in zip(layout.offsets, layout.sizes,
                                   layout.shapes)]


def _flat(tree) -> np.ndarray:
    leaves = jax.tree.leaves(tree)
    W = leaves[0].shape[0]
    return np.concatenate([np.asarray(x).reshape(W, -1) for x in leaves],
                          axis=1)


def _port_codec(name: str, jcodec=None):
    """The port's codec; CountSketch with the JAX codec's maps carried."""
    codec = get_codec(CommConfig(codec=name))
    if name == "countsketch":
        def jax_maps(n, i):
            b, s = jcodec._maps(n, i)
            return (torch.from_numpy(np.asarray(b)),
                    torch.from_numpy(np.asarray(s)))
        codec._maps = jax_maps
    return codec


def _close(got, want, rtol=0.0, atol_of_max=0.0, what=""):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=atol_of_max * np.abs(want).max(),
                               err_msg=what)


# ---------------------------------------------------------------------------
# codecs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", CODECS)
@pytest.mark.parametrize("which", ["smollm", "cnn"])
def test_codec_matches_jax(name, which):
    """encode, decode and bits against repro.comm on identical leaves."""
    layout = LAYOUTS[which]
    W = 3 if which == "smollm" else 6
    G = _grads(1, W, layout)
    tree = _jax_tree(G, layout)
    jcodec = jcomp.get_codec(jcomp.CommConfig(codec=name))
    codec = _port_codec(name, jcodec)
    X = torch.from_numpy(G.copy())
    payload, jpayload = codec.encode(X, layout), jcodec.encode(tree)
    for i, (p, jp) in enumerate(zip(payload, jpayload)):
        what = f"{name} leaf {i}"
        if name == "identity":
            np.testing.assert_array_equal(p.numpy().reshape(W, -1),
                                          np.asarray(jp).reshape(W, -1))
        elif name == "signsgd":
            np.testing.assert_array_equal(p["sign"].numpy(), np.asarray(
                jp["sign"]).reshape(W, -1), err_msg=what)
            _close(p["scale"].numpy(), np.asarray(jp["scale"]).reshape(W, -1),
                   rtol=1e-6, what=what)
        elif name == "topk":
            order = np.argsort(p["idx"].numpy(), axis=1)
            jorder = np.argsort(np.asarray(jp["idx"]), axis=1)
            idx = np.take_along_axis(p["idx"].numpy(), order, 1)
            np.testing.assert_array_equal(idx, np.take_along_axis(
                np.asarray(jp["idx"]), jorder, 1), err_msg=what)
            np.testing.assert_array_equal(
                np.take_along_axis(p["val"].numpy(), order, 1),
                np.take_along_axis(np.asarray(jp["val"]), jorder, 1))
        else:
            _close(p.numpy(), jp, atol_of_max=1e-6, what=what)
    out = codec.decode(payload, layout, torch.empty_like(X))
    want = _flat(jcodec.decode(jpayload, tree))
    if name in ("identity", "topk"):
        np.testing.assert_array_equal(out.numpy(), want)
    elif name == "signsgd":
        _close(out.numpy(), want, rtol=1e-6)
    else:
        _close(out.numpy(), want, atol_of_max=1e-6)
    assert codec.bits(layout, W) == jcodec.bits(tree)
    assert dense_bits(layout, W) == jcomp.dense_bits(tree)


def _lax_top_k_sets(G: np.ndarray, k: int) -> list:
    _, idx = jax.lax.top_k(jnp.abs(jnp.asarray(G)), k)
    return [sorted(r) for r in np.asarray(idx).tolist()]


def test_topk_keeps_lax_top_k_set_on_ties():
    """Exactly equal |g| at the k-th place: the kept set is lax.top_k's
    (every |g| above the k-th largest, then the ties lowest index first)
    in the payload and in the decode; a tie of +a and -a decodes to
    different values, so the decode shows a wrong choice.  The row
    [0.1, -0.5, 0.2, 0.5, 0.5, -0.5, 0.3, 0.5] at k = 2 keeps {1, 3};
    4 x 4096 normals rounded to 0.1 at k = 256 cut through a tie in every
    row."""
    row = np.array([[0.1, -0.5, 0.2, 0.5, 0.5, -0.5, 0.3, 0.5]], np.float32)
    codec = get_codec(CommConfig(codec="topk", topk_density=0.25))
    p = codec.encode_leaf(torch.from_numpy(row), 0, (8,))
    assert p["idx"].tolist() == [[1, 3]] == _lax_top_k_sets(row, 2)
    G = np.round(np.random.default_rng(31).normal(size=(4, 4096)), 1
                 ).astype(np.float32)
    layout = Layout(0, ((0,),), ((4096,),))
    codec = get_codec(CommConfig(codec="topk"))
    k = codec._k(4096)
    assert k == 256
    a = np.abs(G)
    t = -np.sort(-a, axis=1)[:, k - 1:k]
    # the k-th largest |g| is tied and only part of the tie is kept
    assert ((a > t).sum(1) < k).all() and ((a >= t).sum(1) > k).all()
    p = codec.encode(torch.from_numpy(G), layout)[0]
    assert [sorted(r) for r in p["idx"].tolist()] == _lax_top_k_sets(G, k)
    jcodec = jcomp.get_codec(jcomp.CommConfig(codec="topk"))
    tree = [jnp.asarray(G)]
    want = np.asarray(jcodec.decode(jcodec.encode(tree), tree)[0])
    X, _ = ef_encode_decode(codec, torch.from_numpy(G.copy()), layout)
    np.testing.assert_array_equal(X.numpy(), want)


class _ThreadSum:
    """``reduce(t, kind)`` over R threads standing for R ranks: every
    thread gets the sum of the R tensors, added in rank order."""

    def __init__(self, R: int):
        self.parts, self.barrier = [None] * R, threading.Barrier(R)

    def reduce_of(self, r: int):
        def reduce(t, kind):
            self.parts[r] = t.clone()
            self.barrier.wait(timeout=60)
            total = sum(self.parts[1:], self.parts[0])
            self.barrier.wait(timeout=60)
            return t.copy_(total)
        return reduce


@pytest.mark.parametrize("n,k", [(5, 2), (130, 8), (4096, 256),
                                 (4096, 4096)])
@pytest.mark.parametrize("R", [1, 2, 3, 8])
def test_topk_threshold_over_ranges_keeps_lax_top_k_set(R, n, k):
    """topk_threshold on the contiguous ranges of R simulated ranks (one
    thread each; at n = 5 and R = 8 three ranks hold nothing), on rows
    rounded to 0.5 (ties at the k-th |g| in most rows) and on one all-zero
    row: the ranks' kept sets together are lax.top_k's."""
    G = np.round(2 * np.random.default_rng(n + R).normal(size=(6, n))) / 2
    G[5] = 0.0
    G = G.astype(np.float32)
    chunk = -(-n // R)
    kept = [None] * R
    sums = _ThreadSum(R)

    def rank(r):
        lo, hi = min(r * chunk, n), min((r + 1) * chunk, n)
        h = torch.from_numpy(G[:, lo:hi])
        t, cut = tcomp.topk_threshold(h, k, n, lo, sums.reduce_of(r))
        kept[r] = tcomp.topk_kept(h, t, cut, lo).numpy()
    threads = [threading.Thread(target=rank, args=(r,)) for r in range(R)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=120)
    assert not any(th.is_alive() for th in threads)
    got = [sorted(np.nonzero(row)[0].tolist())
           for row in np.concatenate(kept, axis=1)]
    assert got == _lax_top_k_sets(G, k)


@pytest.mark.parametrize("name", ["topk", "countsketch"])
def test_k_rounds_half_to_even_as_jax(name):
    """k = max(1, min(n, round(ratio n))) with Python's round: n = 8 at
    1/16 keeps 1 (round(0.5) = 0), n = 40 keeps 2 (round(2.5) = 2, where
    floor(x + 0.5) would keep 3)."""
    codec = get_codec(CommConfig(codec=name))
    jcodec = jcomp.get_codec(jcomp.CommConfig(codec=name))
    assert [codec._k(n) for n in range(1, 400)] == \
        [jcodec._k(n) for n in range(1, 400)]
    assert codec._k(8) == 1 and codec._k(40) == 2 and codec._k(24) == 2


def test_countsketch_maps_are_fixed_by_seed_and_leaf():
    """The port's own maps: drawn on the CPU from (seed, leaf), the same
    at every call, in range, +-1 signs; another leaf or seed differs."""
    a = get_codec(CommConfig(codec="countsketch", seed=3))
    b = get_codec(CommConfig(codec="countsketch", seed=3))
    c = get_codec(CommConfig(codec="countsketch", seed=4))
    n = 50_000
    ba, sa = a.maps(n, 2, "cpu")
    bb, sb = b._maps(n, 2)
    assert torch.equal(ba, bb) and torch.equal(sa, sb)
    assert ba.dtype == torch.int32 and sa.dtype == torch.int8
    assert int(ba.min()) >= 0 and int(ba.max()) == a._k(n) - 1
    assert set(sa.unique().tolist()) == {-1, 1}
    assert a.maps(n, 2, "cpu")[0] is ba            # drawn once
    assert not torch.equal(a._maps(n, 3)[0], ba)
    assert not torch.equal(c._maps(n, 2)[0], ba)


def test_countsketch_inner_products_are_unbiased():
    """E<Sg, Sg'> = <g, g'>: over 200 seeds the mean sketch Gram is
    within 3 standard errors of the exact one (the property the Gram feed
    rests on)."""
    layout = Layout(0, ((0,),), ((4096,),))
    G = torch.from_numpy(_grads(2, 3, layout))
    K = G @ G.T
    Ks = torch.stack([
        (lambda P: P @ P.T)(get_codec(CommConfig(
            codec="countsketch", seed=s)).sketch(G, layout))
        for s in range(200)])
    se = Ks.std(0) / 200 ** 0.5
    assert bool(((Ks.mean(0) - K).abs() <= 3 * se + 1e-4).all())


@pytest.mark.parametrize("which", ["smollm", "cnn"])
def test_majority_vote_matches_jax(which):
    layout = LAYOUTS[which]
    G = _grads(3, 5, layout, f=1)
    tree = _jax_tree(G, layout)
    codec = get_codec(CommConfig(codec="signsgd"))
    jcodec = jcomp.get_codec(jcomp.CommConfig(codec="signsgd"))
    got = majority_vote(codec.encode(torch.from_numpy(G), layout), layout)
    want = np.concatenate([np.asarray(x).reshape(-1) for x in
                           jcomp.majority_vote(jcodec.encode(tree), tree)])
    _close(got.numpy(), want, rtol=1e-6)


def test_unknown_codec_and_bad_ratios_raise():
    with pytest.raises(KeyError, match="unknown codec"):
        get_codec(CommConfig(codec="zstd"))
    with pytest.raises(ValueError, match="density"):
        get_codec(CommConfig(codec="topk", topk_density=0.0))
    with pytest.raises(ValueError, match="ratio"):
        get_codec(CommConfig(codec="countsketch", sketch_ratio=1.5))


@pytest.mark.parametrize("name", ["none"] + list(CODECS))
@pytest.mark.parametrize("ef", [None, True, False])
def test_wants_ef_resolves_as_jax(name, ef):
    got = CommConfig(codec=name, error_feedback=ef).wants_ef
    assert got == jcomp.CommConfig(codec=name, error_feedback=ef).wants_ef


# ---------------------------------------------------------------------------
# error feedback
# ---------------------------------------------------------------------------

def test_init_ef_is_zero_per_worker_memory():
    ef = init_ef(torch.ones(7), 3)
    assert ef.shape == (3, 7) and ef.dtype == torch.float32
    assert not bool(ef.any())


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", CODECS)
def test_ef_round_matches_jax(name, masked):
    """One EF round, in place, from the same gradients and the same
    nonzero memory: the decoded buffer and the new memory as JAX's; under
    a mask the absent workers' memory is bit-equal to the old."""
    layout = LAYOUTS["cnn"]
    W = 6
    G = _grads(4, W, layout)
    E = (0.1 * np.random.default_rng(5).normal(size=G.shape)
         * np.abs(G).max(0, keepdims=True)).astype(np.float32)
    mask = np.array([1, 0, 1, 1, 0, 1], np.float32) if masked else None
    jcodec = jcomp.get_codec(jcomp.CommConfig(codec=name))
    codec = _port_codec(name, jcodec)
    X, ef = torch.from_numpy(G.copy()), torch.from_numpy(E.copy())
    out, new_ef = ef_encode_decode(
        codec, X, layout, ef,
        mask=None if mask is None else torch.from_numpy(mask))
    assert out is X and new_ef is ef
    jdec, _, jef = jax_ef_round(
        jcodec, _jax_tree(G, layout), _jax_tree(E, layout),
        mask=None if mask is None else jnp.asarray(mask))
    exact = name in ("identity", "topk")
    _close(X.numpy(), _flat(jdec), rtol=0 if exact else 1e-6,
           atol_of_max=0 if exact else 1e-6, what="decoded")
    _close(ef.numpy(), _flat(jef), atol_of_max=0 if exact else 1e-6,
           what="memory")
    if masked:
        off = mask == 0
        np.testing.assert_array_equal(ef.numpy()[off], E[off])
        assert not np.array_equal(ef.numpy()[~off], E[~off])


@pytest.mark.parametrize("name", CODECS)
def test_ef_none_runs_the_codec_alone(name):
    layout = LAYOUTS["cnn"]
    G = torch.from_numpy(_grads(6, 4, layout))
    codec = get_codec(CommConfig(codec=name))
    want = codec.decode(codec.encode(G.clone(), layout), layout,
                        torch.empty_like(G))
    X, ef = ef_encode_decode(codec, G.clone(), layout, None)
    assert ef is None
    np.testing.assert_array_equal(X.numpy(), want.numpy())


# tests/test_comm.py:195's generative case space (workers 3..8, coordinates
# 40..400, signSGD or top-k), at fixed draws
@pytest.mark.parametrize("w,n,name", [(3, 40, "signsgd"), (8, 400, "topk"),
                                      (5, 123, "signsgd"), (4, 257, "topk"),
                                      (8, 64, "signsgd"), (3, 399, "topk")])
def test_ef_mean_recovery(w, n, name):
    """EF telescopes: the running mean of the decoded messages of a fixed
    gradient converges to it at rate ||e_T|| / T (tests/test_comm.py:195,
    the same bounds)."""
    layout = Layout(0, ((0,),), ((n,),))
    codec = get_codec(CommConfig(codec=name))
    g = torch.from_numpy(np.random.default_rng(1000 * w + n).normal(
        size=(w, n)).astype(np.float32))
    ef = init_ef(torch.zeros(n), w)
    acc = torch.zeros_like(g)
    errs = {}
    for t in range(1, 65):
        dec, ef = ef_encode_decode(codec, g.clone(), layout, ef)
        acc += dec
        if t in (8, 64):
            errs[t] = float(torch.linalg.vector_norm(acc / t - g)
                            / torch.linalg.vector_norm(g))
    assert errs[64] < 0.2, errs
    assert errs[64] < errs[8], errs


# ---------------------------------------------------------------------------
# compressed_aggregate: the three routes
# ---------------------------------------------------------------------------

W_AGG, F_AGG = 8, 1
AGG_RULES = ["flag", "multi_krum", "median", "bulyan"]
# (codec, error_feedback): none; identity; signSGD and top-k with EF (their
# default) and without; CountSketch without EF (the Gram feed for flag and
# multi_krum, a decode for median and bulyan) and with EF (a decode)
ROUTES = [("none", None), ("identity", None), ("signsgd", None),
          ("signsgd", False), ("topk", None), ("topk", False),
          ("countsketch", None), ("countsketch", True)]
AGG_MASK = np.array([1, 1, 0, 1, 1, 1, 0, 1], np.float32)


def _agg_cfgs(rule: str):
    return (AggregatorConfig(name=rule, f=F_AGG,
                             flag=FlagConfig(lam=float(W_AGG))),
            JAggregatorConfig(name=rule, f=F_AGG,
                              flag=JFlagConfig(lam=float(W_AGG)),
                              impl="xla"))


@pytest.mark.parametrize("codec,ef_flag", ROUTES)
@pytest.mark.parametrize("rule", AGG_RULES)
def test_compressed_aggregate_matches_jax(rule, codec, ef_flag):
    layout = LAYOUTS["cnn"]
    G = _grads(7, W_AGG, layout, f=F_AGG)
    tree = _jax_tree(G, layout)
    comm = CommConfig(codec=codec, error_feedback=ef_flag)
    jcomm = jcomp.CommConfig(codec=codec, error_feedback=ef_flag)
    jcodec = jcomp.get_codec(jcomm)
    tcodec = _port_codec(codec, jcodec) if codec != "none" else None
    E = (0.05 * np.random.default_rng(8).normal(size=G.shape)
         * np.abs(G).max(0, keepdims=True)).astype(np.float32)
    use_ef = comm.wants_ef
    cfg, jcfg = _agg_cfgs(rule)
    ef = torch.from_numpy(E.copy()) if use_ef else None
    d, aux, new_ef = compressed_aggregate(
        torch.from_numpy(G.copy()), cfg, comm, ef, layout=layout,
        codec=tcodec)
    jd, jaux, jef = jax_compressed(tree, jcfg, jcomm,
                                   _jax_tree(E, layout) if use_ef else None)
    want = np.concatenate([np.asarray(x).reshape(-1)
                           for x in jax.tree.leaves(jd)])
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(d.numpy() / scale, want / scale, rtol=5e-3,
                               atol=5e-4)
    np.testing.assert_allclose(aux["weights"].numpy(),
                               np.asarray(jaux["weights"]),
                               rtol=0 if rule != "flag" else 5e-3,
                               atol=0 if rule != "flag" else 5e-4)
    assert float(aux["comm_bits"]) == pytest.approx(
        float(jaux["comm_bits"]), rel=1e-6)
    assert float(aux["comm_ratio"]) == pytest.approx(
        float(jaux["comm_ratio"]), rel=1e-6)
    bits = (tcodec.bits(layout, W_AGG) if tcodec
            else dense_bits(layout, W_AGG))
    assert float(aux["comm_bits"]) == bits
    if use_ef:
        assert new_ef is ef
        _close(ef.numpy(), _flat(jef), atol_of_max=1e-6, what="memory")
    else:
        assert new_ef is None and jef is None


@pytest.mark.parametrize("rule", AGG_RULES)
@pytest.mark.parametrize("codec", ["signsgd", "countsketch"])
def test_compressed_aggregate_under_a_mask_matches_jax(rule, codec):
    """Absent workers ship no bits (comm_bits x 6 / 8), get weight 0 and
    keep their EF memory."""
    layout = LAYOUTS["cnn"]
    G = _grads(9, W_AGG, layout, f=F_AGG)
    E = (0.05 * np.random.default_rng(10).normal(size=G.shape)).astype(
        np.float32)
    comm, jcomm = (CommConfig(codec=codec),
                   jcomp.CommConfig(codec=codec))
    use_ef = comm.wants_ef
    jcodec = jcomp.get_codec(jcomm)
    cfg, jcfg = _agg_cfgs(rule)
    ef = torch.from_numpy(E.copy()) if use_ef else None
    d, aux, _ = compressed_aggregate(
        torch.from_numpy(G.copy()), cfg, comm, ef, layout=layout,
        mask=torch.from_numpy(AGG_MASK), codec=_port_codec(codec, jcodec))
    jd, jaux, jef = jax_compressed(
        _jax_tree(G, layout), jcfg, jcomm,
        _jax_tree(E, layout) if use_ef else None,
        mask=jnp.asarray(AGG_MASK))
    want = np.concatenate([np.asarray(x).reshape(-1)
                           for x in jax.tree.leaves(jd)])
    scale = np.abs(want).max() + 1e-12
    np.testing.assert_allclose(d.numpy() / scale, want / scale, rtol=5e-3,
                               atol=5e-4)
    np.testing.assert_allclose(aux["weights"].numpy(),
                               np.asarray(jaux["weights"]), rtol=5e-3,
                               atol=5e-4)
    assert (aux["weights"].numpy()[AGG_MASK == 0] == 0).all()
    assert float(aux["comm_bits"]) == pytest.approx(
        float(jaux["comm_bits"]), rel=1e-6)
    assert float(aux["comm_bits"]) == \
        get_codec(comm).bits(layout, W_AGG) * 6 / 8
    if use_ef:
        off = AGG_MASK == 0
        np.testing.assert_array_equal(ef.numpy()[off], E[off])
        _close(ef.numpy(), _flat(jef), atol_of_max=1e-6, what="memory")


def test_gram_feed_never_decodes(monkeypatch):
    """CountSketch under a Gram rule without EF: the sketch feeds the
    Gram, the exact gradients are combined, nothing is decoded and X is
    left as it was.  Under Bulyan (not a Gram rule) it decodes."""
    layout = LAYOUTS["cnn"]
    G = torch.from_numpy(_grads(11, W_AGG, layout, f=F_AGG))

    def boom(*a, **k):
        raise AssertionError("decode called on the Gram-feed route")
    monkeypatch.setattr(tcomp.CountSketchCodec, "decode_leaf", boom)
    monkeypatch.setattr(tcomp.CountSketchCodec, "decode", boom)
    monkeypatch.setattr(tcomp.CountSketchCodec, "decode_range", boom)
    comm = CommConfig(codec="countsketch")
    for rule in ("flag", "multi_krum", "mean", "krum", "pca", "geomed"):
        X = G.clone()
        d, aux, _ = compressed_aggregate(
            X, AggregatorConfig(name=rule, f=F_AGG), comm, layout=layout)
        assert torch.equal(X, G)
        c = aux["weights"]
        np.testing.assert_allclose(d.numpy(), (c @ G).numpy(), rtol=1e-4,
                                   atol=1e-5 * float(G.abs().max()))
    with pytest.raises(AssertionError, match="decode called"):
        compressed_aggregate(G.clone(), AggregatorConfig(name="bulyan",
                                                         f=F_AGG),
                             comm, layout=layout)


def test_missing_ef_raises():
    layout = LAYOUTS["cnn"]
    X = torch.from_numpy(_grads(12, 4, layout))
    with pytest.raises(ValueError, match="error feedback"):
        compressed_aggregate(X, AggregatorConfig(name="mean"),
                             CommConfig(codec="signsgd"), None,
                             layout=layout)
    d, _, ef = compressed_aggregate(
        X, AggregatorConfig(name="mean"),
        CommConfig(codec="signsgd", error_feedback=False), None,
        layout=layout)
    assert ef is None and d.shape == (layout.numel,)
