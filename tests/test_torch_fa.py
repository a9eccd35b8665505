"""Port parity: the Gram-space FA solver and the Beta-MLE pieces against the
JAX package on seeded numpy inputs.

Tolerance: rtol 5e-3 / atol 5e-4, the tolerance of the reference's own FA
checks (tests/test_properties.py); the two packages run the same fp32
algorithm with different eigensolvers (LAPACK through XLA vs PyTorch's),
whose eigenvectors may differ in sign and order -- so c, the explained
variances, the objective and the iteration count are compared, never Q.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import beta_mle as jbeta
from repro.core.flag import FlagConfig as JFlagConfig
from repro.core.gram import fa_weights_from_gram as jax_fa
from repro_torch.core import beta_mle as tbeta
from repro_torch.core.flag import FlagConfig, effective_norms
from repro_torch.core.gram import fa_weights_from_gram

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

RTOL, ATOL = 5e-3, 5e-4


def _gradients(seed: int, p: int, f: int, n: int = 400) -> np.ndarray:
    """Worker-major (p, n): f Byzantine (uniform random, large) rows, the
    rest a shared unit direction plus per-worker noise -- the construction
    of tests/conftest.py::make_gradient_matrix, from this test's seed."""
    rng = np.random.default_rng(seed)
    mu = rng.normal(size=n)
    mu /= np.linalg.norm(mu)
    honest = mu[None, :] + 0.3 * rng.normal(size=(p - f, n))
    byz = rng.uniform(-20.0, 20.0, size=(f, n))
    return np.concatenate([byz, honest], axis=0).astype(np.float32)


def _gram(seed: int, p: int, f: int) -> np.ndarray:
    G = _gradients(seed, p, f).astype(np.float64)
    return (G @ G.T).astype(np.float32)


def _compare(K: np.ndarray, kw: dict, mask: np.ndarray | None = None):
    c_t, aux_t = fa_weights_from_gram(
        torch.from_numpy(K), FlagConfig(**kw),
        mask=None if mask is None else torch.from_numpy(mask))
    c_j, aux_j = jax_fa(jnp.asarray(K), JFlagConfig(**kw),
                        mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(c_t.numpy(), np.asarray(c_j),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(aux_t["explained_variance"].numpy(),
                               np.asarray(aux_j["explained_variance"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(float(aux_t["objective"]),
                               float(aux_j["objective"]), rtol=RTOL,
                               atol=ATOL)
    assert int(aux_t["iterations"]) == int(aux_j["iterations"])
    assert aux_t["m"] == aux_j["m"]
    return c_t.numpy()


@pytest.mark.parametrize("p", [6, 15])
@pytest.mark.parametrize("lam_is_p", [False, True])
@pytest.mark.parametrize("norm_mode", ["raw", "clip", "unit"])
def test_fa_weights_match_jax(p, lam_is_p, norm_mode):
    f = 2 if p == 6 else 3
    K = _gram(100 + p, p, f)
    lam = float(p) if lam_is_p else 0.0
    c = _compare(K, dict(lam=lam, regularizer="pairwise" if lam else "none",
                         norm_mode=norm_mode))
    # the Byzantine workers are suppressed in every configuration
    assert np.abs(c[:f]).max() < np.abs(c[f:]).mean()


@pytest.mark.parametrize("p", [6, 15])
def test_fa_weights_renormalize_match_jax(p):
    K = _gram(200 + p, p, 2)
    c = _compare(K, dict(lam=float(p), renormalize=True))
    np.testing.assert_allclose(c.sum(), 1.0, rtol=1e-4)


@pytest.mark.parametrize("lam", [0.0, 15.0])
def test_fa_weights_masked_match_jax(lam):
    p = 15
    K = _gram(300, p, 3)
    mask = np.ones(p, np.float32)
    mask[[4, 9, 13]] = 0.0
    c = _compare(K, dict(lam=lam, regularizer="pairwise" if lam else "none"),
                 mask=mask)
    assert (c[mask == 0] == 0).all()


def test_fa_weights_few_iterations_and_explicit_m():
    """A non-default m and an iteration cap that binds before convergence."""
    K = _gram(400, 8, 2)
    _compare(K, dict(lam=2.0, m=3, n_iter=2))


def test_fa_weights_rejects_m_above_p():
    with pytest.raises(ValueError, match="m=7"):
        fa_weights_from_gram(torch.eye(4), FlagConfig(m=7))


@pytest.mark.parametrize("mode", ["raw", "clip", "unit"])
@pytest.mark.parametrize("masked", [False, True])
def test_effective_norms_match_jax(mode, masked):
    from repro.core.flag import effective_norms as jax_eff
    rng = np.random.default_rng(9)
    norms = rng.uniform(0.5, 3.0, size=10).astype(np.float32)
    mask = (rng.uniform(size=10) > 0.3).astype(np.float32) if masked else None
    got = effective_norms(torch.from_numpy(norms), mode,
                          None if mask is None else torch.from_numpy(mask))
    want = jax_eff(jnp.asarray(norms), mode,
                   None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("alpha,beta,a", [(1.0, 0.5, 2.0), (2.0, 0.5, 3.0),
                                          (0.5, 1.0, 2.0)])
def test_beta_mle_matches_jax(alpha, beta, a):
    rng = np.random.default_rng(17)
    v = np.concatenate([rng.uniform(size=50), [0.0, 1.0, 1e-13, 1 - 1e-13]]
                       ).astype(np.float32)
    coef = rng.uniform(0.5, 2.0, size=v.shape).astype(np.float32)
    kw = dict(alpha=alpha, beta=beta, a=a)
    vt, vj = torch.from_numpy(v), jnp.asarray(v)
    np.testing.assert_allclose(tbeta.beta_nll_terms(vt, **kw).numpy(),
                               np.asarray(jbeta.beta_nll_terms(vj, **kw)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tbeta.irls_weights(vt, torch.from_numpy(coef), **kw).numpy(),
        np.asarray(jbeta.irls_weights(vj, jnp.asarray(coef), **kw)),
        rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tbeta.taylor_log(vt + 0.5, a).numpy(),
                               np.asarray(jbeta.taylor_log(vj + 0.5, a)),
                               rtol=1e-5, atol=1e-6)
