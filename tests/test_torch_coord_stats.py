"""Port parity: the coordinate-statistics and selection kernels' plain
versions against the JAX package: its references
(``repro.kernels.coord_stats.ref``, ``repro.core.aggregators``) and, at a
tiny size, its Pallas kernels run in the interpreter (as
tests/test_kernels_interpret.py runs them).  Inputs are numpy arrays from
each test's own seed.

Tolerances: the median is held exactly (both sides take the same two
sorted values and the same ``(a + b) * 0.5``); the means at rtol 1e-5 /
atol 1e-5, tests/test_coord_stats.py's own tolerance (fp32 sums in another
order).  Selections (picks, argmin, rank) are held exactly.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.kernels.coord_stats import ref as jref
from repro.kernels.coord_stats.kernel import (bulyan_select_pallas,
                                              coord_stats_pallas,
                                              krum_scores_pallas)
from repro_torch.core import aggregators as tagg
from repro_torch.kernels.coord_stats import ref as tref
from repro_torch.kernels.coord_stats.kernel import (bulyan_select_cuda,
                                                    coord_stats_cuda,
                                                    krum_scores_cuda)
from repro_torch.kernels.coord_stats.ops import (bulyan_select, coord_stat,
                                                 krum_scores)

OPS = tref.COORD_OPS
JREF = {"median": lambda G, f: jref.median_ref(G),
        "trimmed_mean": jref.trimmed_mean_ref,
        "meamed": jref.meamed_ref, "phocas": jref.phocas_ref}


def _data(seed: int, W: int, n: int, kind: str) -> np.ndarray:
    """``normal`` data, or ``ties``: small integers with a repeated row,
    so sorted values and distances to the center tie exactly."""
    rng = np.random.default_rng(seed)
    if kind == "normal":
        return rng.normal(size=(W, n)).astype(np.float32)
    X = rng.integers(-3, 4, size=(W, n)).astype(np.float32)
    if W > 2:
        X[W - 1] = X[0]
    return X


def _check(op, got, want):
    if op == "median":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("W", [1, 2, 3, 8, 15])
@pytest.mark.parametrize("f", [0, 3, 20])
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_coord_stat_plain_matches_jax_ref(op, W, f, kind):
    X = _data(100 * W + f, W, 257, kind)
    got = tref.coord_stat_plain(torch.from_numpy(X), op, f).numpy()
    _check(op, got, np.asarray(JREF[op](jnp.asarray(X), f)))


def _mask(kind: str, W: int, seed: int) -> np.ndarray:
    m = np.zeros(W, np.float32)
    if kind == "one":
        m[seed % W] = 1.0
    elif kind == "random":
        rng = np.random.default_rng(seed)
        m[rng.choice(W, rng.integers(1, W + 1), replace=False)] = 1.0
    return m


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("W", [3, 8, 15])
@pytest.mark.parametrize("mkind", ["none_active", "one", "random"])
@pytest.mark.parametrize("kind", ["normal", "ties"])
def test_masked_coord_stat_plain_matches_jax(op, W, mkind, kind):
    f = 1 if W < 8 else 3
    X = _data(7 * W + len(mkind), W, 131, kind)
    m = _mask(mkind, W, W + 3)
    got = tref.coord_stat_plain(torch.from_numpy(X), op, f,
                                mask=torch.from_numpy(m)).numpy()
    want = jagg.MASKED_COORDWISE[op](jnp.asarray(X), jnp.asarray(m), f=f)
    _check(op, got, np.asarray(want))
    port = tagg.MASKED_COORDWISE[op](torch.from_numpy(X),
                                     torch.from_numpy(m), f=f).numpy()
    np.testing.assert_array_equal(port, got)


@pytest.mark.parametrize("k", [1, 4, 9])
def test_masked_mean_around_matches_jax(k):
    X = _data(k, 9, 131, "ties")
    m = _mask("random", 9, 2)
    center = np.median(X, axis=0).astype(np.float32) + 0.25
    got = tagg.masked_mean_around(torch.from_numpy(X),
                                  torch.from_numpy(center), k,
                                  torch.from_numpy(m)).numpy()
    want = jagg.masked_mean_around(jnp.asarray(X), jnp.asarray(center),
                                   jnp.asarray(k), jnp.asarray(m))
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("masked", [False, True])
def test_rows_read_the_picked_rows_in_order(op, masked):
    """rows= equals the statistic of X[rows] (JAX on the gathered copy)."""
    X = _data(5, 12, 301, "ties" if masked else "normal")
    rows = np.array([7, 2, 11, 0, 5, 9, 3], np.int32)
    m = _mask("random", rows.size, 4) if masked else None
    got = coord_stat(torch.from_numpy(X), op, 2,
                     rows=torch.from_numpy(rows),
                     mask=None if m is None else torch.from_numpy(m))
    S = jnp.asarray(X[rows])
    want = (JREF[op](S, 2) if m is None
            else jagg.MASKED_COORDWISE[op](S, jnp.asarray(m), f=2))
    _check(op, got.numpy(), np.asarray(want))


def test_plain_walks_columns_in_chunks(monkeypatch):
    """The chunked walk gives the one-chunk result (ragged last chunk)."""
    X = torch.from_numpy(_data(9, 6, 1000, "normal"))
    whole = {op: tref.coord_stat_plain(X, op, 1) for op in OPS}
    monkeypatch.setattr(tref, "CHUNK", 97)
    for op in OPS:
        np.testing.assert_array_equal(tref.coord_stat_plain(X, op, 1).numpy(),
                                      whole[op].numpy())


def test_bf16_computes_in_fp32_and_returns_bf16():
    X = _data(3, 5, 200, "normal")
    Xb = torch.from_numpy(X).to(torch.bfloat16)
    got = coord_stat(Xb, "phocas", 1)
    assert got.dtype == torch.bfloat16
    want = tref.coord_stat_plain(Xb.float(), "phocas", 1).to(torch.bfloat16)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the TPU kernels themselves (Pallas interpreter, tiny sizes)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_coord_stat_plain_matches_pallas_kernel(masked):
    W, f = 6, 1
    X = _data(31, W, 300, "ties")
    m = _mask("random", W, 8) if masked else None
    for op in OPS:
        want = coord_stats_pallas(jnp.asarray(X),
                                  None if m is None else jnp.asarray(m),
                                  op=op, f=f, block_n=128, interpret=True)
        got = tref.coord_stat_plain(torch.from_numpy(X), op, f,
                                    mask=None if m is None
                                    else torch.from_numpy(m))
        _check(op, got.numpy(), np.asarray(want))


def _d2(seed: int, W: int, dup: int = 0) -> np.ndarray:
    """Squared distances of W random points, the first ``dup`` identical
    (as the zero attack makes them): exact score ties."""
    rng = np.random.default_rng(seed)
    P = rng.normal(size=(W, 6)).astype(np.float32)
    P[:dup] = 0.0
    D = ((P[:, None, :] - P[None, :, :]) ** 2).sum(-1).astype(np.float32)
    np.fill_diagonal(D, 0.0)
    return D


def test_selection_plain_matches_pallas_kernels():
    D = _d2(4, 7, dup=2)
    for f in (0, 1, 2):
        np.testing.assert_allclose(
            tref.krum_scores_plain(torch.from_numpy(D), f).numpy(),
            np.asarray(krum_scores_pallas(jnp.asarray(D), f=f,
                                          interpret=True)), rtol=1e-6)
    D = _d2(5, 8, dup=3)
    for f in (1, 2):
        np.testing.assert_array_equal(
            tref.bulyan_select_plain(torch.from_numpy(D), f).numpy(),
            np.asarray(bulyan_select_pallas(jnp.asarray(D), f=f,
                                            interpret=True)))


# ---------------------------------------------------------------------------
# selections against repro.core.aggregators
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("W", [1, 3, 4, 8, 15])
@pytest.mark.parametrize("f", [0, 1, 3])
@pytest.mark.parametrize("dup", [0, 3])
def test_krum_and_bulyan_plain_match_jax(W, f, dup):
    D = _d2(10 * W + f, W, dup=min(dup, W))
    Dt = torch.from_numpy(D)
    s = krum_scores(Dt, f)
    js = np.asarray(jagg.krum_scores(jnp.asarray(D), f))
    np.testing.assert_allclose(s.numpy(), js, rtol=1e-6)
    assert int(torch.argmin(s)) == int(np.argmin(js))
    q = max(W - f - 2, 1)
    np.testing.assert_array_equal(
        torch.argsort(s, stable=True)[:q].numpy(),
        np.argsort(js, kind="stable")[:q])
    picks = bulyan_select(Dt, f)
    assert picks.dtype == torch.int32
    np.testing.assert_array_equal(
        picks.numpy(), np.asarray(jagg.bulyan_select(jnp.asarray(D), f)))


@pytest.mark.parametrize("W", [3, 8, 15])
@pytest.mark.parametrize("mkind", ["none_active", "one", "random"])
def test_masked_selection_matches_jax(W, mkind):
    f = 1 if W < 8 else 2
    D = _d2(3 * W, W, dup=3)
    m = _mask(mkind, W, W + 1)
    Dt, mt = torch.from_numpy(D), torch.from_numpy(m)
    Dj, mj = jnp.asarray(D), jnp.asarray(m)
    np.testing.assert_allclose(
        tagg.masked_krum_scores(Dt, f, mt).numpy(),
        np.asarray(jagg.masked_krum_scores(Dj, f, mj)), rtol=1e-6)
    for name in ("krum", "multi_krum"):
        np.testing.assert_array_equal(
            tagg.masked_selection_weights(Dt, name, f, mt).numpy(),
            np.asarray(jagg.masked_selection_weights(Dj, name, f, mj)))
    sel, theta = tagg.masked_bulyan_select(Dt, f, mt)
    jsel, jtheta = jagg.masked_bulyan_select(Dj, f, mj)
    np.testing.assert_array_equal(sel.numpy(), np.asarray(jsel))
    assert int(theta) == int(jtheta)


@pytest.mark.parametrize("name", sorted(jagg.AGGREGATORS))
def test_flat_baselines_match_jax(name):
    rng = np.random.default_rng(17)
    G = (rng.normal(size=(1, 200)) + 0.5 * rng.normal(size=(9, 200))
         ).astype(np.float32)
    G[:2] = rng.uniform(-6.0, 6.0, size=(2, 200))
    got = tagg.get_aggregator(name)(torch.from_numpy(G), f=2).numpy()
    want = np.asarray(jagg.get_aggregator(name)(jnp.asarray(G), f=2))
    scale = np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, rtol=5e-3,
                               atol=5e-4)


def test_unknown_op_and_aggregator_raise():
    with pytest.raises(ValueError, match="unknown op"):
        coord_stat(torch.zeros((3, 4)), "mode")
    with pytest.raises(KeyError, match="unknown aggregator"):
        tagg.get_aggregator("nope")


@pytest.mark.parametrize("fn", ["coord_stats", "krum_scores",
                                "bulyan_select"])
def test_kernel_wrappers_refuse_cpu_tensors(fn):
    """The CUDA wrappers launch on CUDA tensors only; they never hand a
    tensor to the plain version themselves."""
    with pytest.raises(ValueError, match="CUDA"):
        if fn == "coord_stats":
            coord_stats_cuda(torch.zeros((3, 64)), "median")
        elif fn == "krum_scores":
            krum_scores_cuda(torch.zeros((3, 3)))
        else:
            bulyan_select_cuda(torch.zeros((3, 3)))
