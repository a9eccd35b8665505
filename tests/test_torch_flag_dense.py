"""Port parity for the dense Flag Aggregator (``flag_subspace``,
``flag_aggregate``) and the Gram-space ``qspace`` oracle, each against the
JAX package on the same numpy gradients.

Y is never compared: SVD and eigh return bases with other signs and
rotations.  Compared are the update d (or the weights c), the explained
variances and the IRLS iterations.  Tolerances: d and c carry the FA
tolerance, rtol 5e-3 / atol 5e-4 of the vector normalised by its norm
(``tests/test_properties.py:114``: two eigen- or SVD solvers); the
explained variances lie in [0, 1] and are held to atol 2e-3, the
tolerance ``tests/test_gram_solvers.py`` holds the JAX solvers to against
each other.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.flag import FlagConfig as JFlagConfig
from repro.core.flag import flag_aggregate as jflag_aggregate
from repro.core.gram import fa_weights_from_gram as jfa_weights
from repro.core.gram import flag_aggregate_gram as jflag_aggregate_gram
from repro_torch.core.flag import FlagConfig, flag_aggregate, flag_subspace
from repro_torch.core.gram import (fa_weights_from_gram, flag_aggregate_gram,
                                   gram_matrix)

REGS = ("pairwise", "l1", "none")
MODES = ("raw", "clip", "unit")


def _grads(p: int, n: int, seed: int) -> np.ndarray:
    """(n, p): an honest mean plus noise, worker 0 sign-flipped x10."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=n)
    G = mu[:, None] + 0.7 * rng.normal(size=(n, p))
    G[:, 0] *= -10.0
    return G.astype(np.float32)


def _close_fa(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.linalg.norm(want) + 1e-6
    np.testing.assert_allclose(got / scale, want / scale, rtol=5e-3,
                               atol=5e-4)


def _cfgs(p, reg, mode):
    kw = dict(lam=float(p) if reg != "l1" else 1.0, regularizer=reg,
              norm_mode=mode)
    return FlagConfig(**kw), JFlagConfig(**kw)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("reg", REGS)
@pytest.mark.parametrize("p", [4, 7])
def test_dense_flag_aggregate_matches_jax(p, reg, mode):
    G = _grads(p, 240, seed=10 * p + REGS.index(reg))
    cfg, jcfg = _cfgs(p, reg, mode)
    d, aux = flag_aggregate(torch.from_numpy(G), cfg)
    jd, jaux = jflag_aggregate(jnp.asarray(G), jcfg)
    assert d.shape == (240,) and d.dtype == torch.float32
    _close_fa(d.numpy(), jd)
    np.testing.assert_allclose(aux["explained_variance"].numpy(),
                               np.asarray(jaux["explained_variance"]),
                               atol=2e-3)
    assert aux["iterations"] == int(jaux["iterations"])
    assert aux["m"] == jaux["m"]
    assert float(aux["objective"]) == pytest.approx(
        float(jaux["objective"]), rel=1e-3, abs=1e-3)


def test_flag_subspace_is_orthonormal_and_stops_early():
    G = torch.from_numpy(_grads(5, 100, seed=3))
    Y, aux = flag_subspace(G, FlagConfig(lam=5.0, n_iter=50, tol=1e-6))
    assert Y.shape == (100, 3)
    torch.testing.assert_close(Y.T @ Y, torch.eye(3), atol=1e-5, rtol=0)
    assert 1 <= aux["iterations"] < 50
    with pytest.raises(ValueError, match="subspace dim"):
        flag_subspace(G, FlagConfig(m=6))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("reg", ("pairwise", "none"))
@pytest.mark.parametrize("p", [4, 7])
def test_qspace_matches_jax(p, reg, mode):
    G = _grads(p, 300, seed=100 + 10 * p + REGS.index(reg))
    cfg, jcfg = _cfgs(p, reg, mode)
    K = gram_matrix(torch.from_numpy(G))
    c, aux = fa_weights_from_gram(K, cfg, solver="qspace")
    jc, jaux = jfa_weights(jnp.asarray(K.numpy()), jcfg, solver="qspace")
    _close_fa(c.numpy(), jc)
    np.testing.assert_allclose(aux["explained_variance"].numpy(),
                               np.asarray(jaux["explained_variance"]),
                               atol=2e-3)
    assert int(aux["iterations"]) == int(jaux["iterations"])


def _solver_gradients(p: int, n: int = 300, seed: int = 0) -> np.ndarray:
    """(n, p) as ``tests/test_gram_solvers.py::_gradients`` builds them:
    a unit honest mean plus noise 0.3, f = max(1, p // 5) uniform
    Byzantine columns in [-20, 20]."""
    rng = np.random.default_rng(seed + 97 * p)
    f = max(1, p // 5)
    mu = rng.normal(size=n)
    mu /= np.linalg.norm(mu)
    honest = mu[None, :] + 0.3 * rng.normal(size=(p - f, n))
    byz = rng.uniform(-20.0, 20.0, size=(f, n))
    return np.concatenate([byz, honest], axis=0).astype(np.float32).T


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("p", [2, 3, 5, 8, 16])
def test_qspace_and_rank_p_agree_in_the_port(p, mode):
    """The port's two solvers and its dense reference against each other,
    as ``tests/test_gram_solvers.py`` holds the JAX ones (lambda = p; c and
    the explained variances to atol 2e-3, the dense d to 5e-3 of its
    largest entry).  With the regularizer off, at small p the two Gram
    solvers differ by more: the top-m subspace is then near-degenerate
    (eigenvalues 0.27, 0.30, 0.32 at p = 4 in ``_grads``), which is why the
    reference states this agreement with lambda = p only."""
    G = torch.from_numpy(_solver_gradients(p))
    cfg = FlagConfig(lam=float(p), norm_mode=mode)
    K = gram_matrix(G)
    cq, aq = fa_weights_from_gram(K, cfg, solver="qspace")
    cr, ar = fa_weights_from_gram(K, cfg)
    np.testing.assert_allclose(cr.numpy(), cq.numpy(), atol=2e-3)
    np.testing.assert_allclose(ar["explained_variance"].numpy(),
                               aq["explained_variance"].numpy(), atol=2e-3)
    dd, _ = flag_aggregate(G, cfg)
    want = G @ cr
    assert float((dd - want).abs().max()) < 5e-3 * float(want.abs().max())


@pytest.mark.parametrize("renormalize", [False, True])
def test_qspace_under_a_mask_matches_jax(renormalize):
    G = _grads(7, 200, seed=5)
    mask = np.array([1, 1, 0, 1, 1, 0, 1], np.float32)
    kw = dict(lam=7.0, norm_mode="clip", renormalize=renormalize)
    K = gram_matrix(torch.from_numpy(G))
    c, _ = fa_weights_from_gram(K, FlagConfig(**kw), solver="qspace",
                                mask=torch.from_numpy(mask))
    jc, _ = jfa_weights(jnp.asarray(K.numpy()), JFlagConfig(**kw),
                        solver="qspace", mask=jnp.asarray(mask))
    _close_fa(c.numpy(), jc)
    assert (c.numpy()[mask == 0] == 0).all()


@pytest.mark.parametrize("solver", ["rank_p", "qspace"])
def test_flag_aggregate_gram_matches_jax_and_dense(solver):
    G = _grads(6, 150, seed=9)
    cfg, jcfg = _cfgs(6, "pairwise", "clip")
    d, _ = flag_aggregate_gram(torch.from_numpy(G), cfg, solver=solver)
    jd, _ = jflag_aggregate_gram(jnp.asarray(G), jcfg, solver=solver)
    _close_fa(d.numpy(), jd)
    dd, _ = flag_aggregate(torch.from_numpy(G), cfg)
    _close_fa(d.numpy(), dd.numpy())


def test_unknown_solver_raises():
    K = gram_matrix(torch.from_numpy(_grads(4, 20, seed=1)))
    with pytest.raises(ValueError, match="unknown solver"):
        fa_weights_from_gram(K, FlagConfig(), solver="dense")


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_non_finite_gradients_give_nan_as_jax(bad):
    """A diverged run's gradients: JAX's solvers return NaN and the run
    goes on; the port's return NaN too (LAPACK would have it raise)."""
    G = _grads(5, 60, seed=2)
    G[3, 1] = bad
    cfg, jcfg = _cfgs(5, "pairwise", "clip")
    K = gram_matrix(torch.from_numpy(G))
    for solver in ("rank_p", "qspace"):
        c, _ = fa_weights_from_gram(K, cfg, solver=solver)
        jc, _ = jfa_weights(jnp.asarray(K.numpy()), jcfg, solver=solver)
        assert np.isnan(np.asarray(jc)).all(), solver
        assert torch.isnan(c).all(), solver
    d, _ = flag_aggregate(torch.from_numpy(G), cfg)
    jd, _ = jflag_aggregate(jnp.asarray(G), jcfg)
    assert np.isnan(np.asarray(jd)).all() and torch.isnan(d).all()
