"""Port parity for the RG-LRU block (``repro_torch.models.rglru``): the
log-depth scan, ``rglru_apply`` with and without a carried state, the
block with JAX's weights carried across (sequence, then decode steps from
its state), the Lambda init law, each against ``repro.models.rglru`` on
the same numpy inputs (fp32).

Tolerance 1e-5, the reference's own (``tests/test_models.py``): the
associative scan combines the same products in another order (JAX's
odd-even tree against the port's Hillis-Steele rounds), fp32, |h| ~ 1.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs import reduce_for_smoke as jax_reduce
from repro.models import rglru as jrglru
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import rglru
from repro_torch.weights import map_tree

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TOL = 1e-5


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("S", [1, 2, 7, 33, 64])
def test_linear_scan_matches_a_step_loop(S):
    """Every round count (S = 1 takes none) against h_t = a_t h_{t-1} +
    b_t step by step in float64; a_cum against the running product."""
    rng = np.random.default_rng(S)
    a = rng.uniform(0.5, 1.0, size=(2, S, 5))
    b = rng.normal(size=(2, S, 5))
    h, prod, hs, ps = np.zeros((2, 5)), np.ones((2, 5)), [], []
    for t in range(S):
        h = a[:, t] * h + b[:, t]
        prod = prod * a[:, t]
        hs.append(h)
        ps.append(prod)
    a_cum, got = rglru.linear_scan(_t(a), _t(b))
    _close(got, np.stack(hs, 1))
    _close(a_cum, np.stack(ps, 1))


@pytest.fixture(scope="module")
def lru_params():
    return jax.tree.map(np.asarray,
                        jrglru.rglru_init(jax.random.PRNGKey(1), 16))


@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_apply_matches_jax(lru_params, with_h0):
    """S = 33 (not a power of two: the scan's last round is partial), with
    and without a carried h0 folded in as h + a_cum h0."""
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 33, 16)).astype(np.float32)
    h0 = rng.normal(size=(2, 16)).astype(np.float32) if with_h0 else None
    want, want_last = jrglru.rglru_apply(
        lru_params, jnp.asarray(x), None if h0 is None else jnp.asarray(h0))
    y, last = rglru.rglru_apply(map_tree(_t, lru_params), _t(x),
                                None if h0 is None else _t(h0))
    _close(y, want)
    _close(last, want_last)


def test_rglru_apply_carries_state(lru_params):
    """Two calls (20 + 13 steps) with h carried equal one over 33."""
    x = _t(np.random.default_rng(3).normal(size=(1, 33, 16)))
    p = map_tree(_t, lru_params)
    full, _ = rglru.rglru_apply(p, x)
    y1, h1 = rglru.rglru_apply(p, x[:, :20])
    y2, _ = rglru.rglru_apply(p, x[:, 20:], h1)
    _close(torch.cat([y1, y2], 1), full.numpy())


def test_rglru_block_apply_matches_jax():
    """The block over 17 tokens, then 3 decode steps from its (h, conv)
    state, with JAX's weights."""
    jcfg = jax_reduce(jax_get_config("recurrentgemma-9b"))
    tcfg = reduce_for_smoke(get_config("recurrentgemma-9b"))
    jp = jax.tree.map(np.asarray,
                      jrglru.rglru_block_init(jax.random.PRNGKey(4), jcfg))
    tp = map_tree(_t, jp)
    x = np.random.default_rng(5).normal(size=(2, 20, 256)).astype(np.float32)
    want, jst = jrglru.rglru_block_apply(jp, jnp.asarray(x[:, :17]), jcfg)
    y, st = rglru.rglru_block_apply(tp, _t(x[:, :17]), tcfg)
    _close(y, want)
    for t in range(17, 20):
        want, jst = jrglru.rglru_block_apply(jp, jnp.asarray(x[:, t:t + 1]),
                                             jcfg, jst)
        y, st = rglru.rglru_block_apply(tp, _t(x[:, t:t + 1]), tcfg, st)
        _close(y, want)
    for a, b in zip(st, jst, strict=True):
        _close(a, b)


def test_rglru_block_shapes_match_jax_init():
    """``rglru_block_shapes`` has ``rglru_block_init``'s leaves and shapes
    (full width and reduced)."""
    for jcfg, tcfg in ((jax_get_config("recurrentgemma-9b"),
                        get_config("recurrentgemma-9b")),
                       (jax_reduce(jax_get_config("recurrentgemma-9b")),
                        reduce_for_smoke(get_config("recurrentgemma-9b")))):
        want = jax.eval_shape(lambda k: jrglru.rglru_block_init(k, jcfg),
                              jax.random.PRNGKey(0))
        got = map_tree(lambda t: jax.ShapeDtypeStruct(tuple(t.shape),
                                                      jnp.float32),
                       rglru.rglru_block_shapes(tcfg))
        assert [(jax.tree_util.keystr(p), x.shape) for p, x in
                jax.tree_util.tree_flatten_with_path(got)[0]] == \
            [(jax.tree_util.keystr(p), x.shape) for p, x in
             jax.tree_util.tree_flatten_with_path(want)[0]]


def test_lam_init_law_matches_jax():
    """Lambda = log(expm1(-log u)), u ~ U(0.9, 0.999): both packages'
    draws lie in the image of [0.9, 0.999], exp(-softplus(Lambda))
    recovers u, and over 4,096 draws each package's mean of u is 0.9495
    within 4 standard errors (0.0286 / sqrt(4096))."""
    lo = float(np.log(np.expm1(-np.log(0.999))))
    hi = float(np.log(np.expm1(-np.log(0.9))))
    jl = np.asarray(jrglru.rglru_init(jax.random.PRNGKey(6), 4096)["lam"])
    t = torch.empty(4096)
    rglru.lam_init_(t, torch.Generator().manual_seed(6))
    for lam in (jl, t.numpy()):
        assert lam.min() >= lo - 1e-5 and lam.max() <= hi + 1e-5
        u = np.exp(-np.log1p(np.exp(lam.astype(np.float64))))
        assert abs(u.mean() - 0.9495) < 4 * 0.0286 / 64
