"""Port parity for the xLSTM blocks (``repro_torch.models.ssm``): the
short causal conv, the mLSTM cell (chunkwise and stepwise), the sLSTM cell
loop, and the mLSTM / sLSTM blocks with JAX's weights carried across,
each against ``repro.models.ssm`` on the same numpy inputs (fp32).

Tolerances are the reference's own (``tests/test_models.py``), each with
its reason next to the test: 2e-4 for mLSTM outputs and 2e-3 for its
(C, n, m) state (exp-gated sums taken in another order; C and n carry
values up to ~1e2 here), 1e-5 for the conv (four products a value).
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
from repro.models import ssm as jssm
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.models import ssm
from repro_torch.weights import map_tree

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

MLSTM_H_TOL = 2e-4      # tests/test_models.py: mLSTM outputs
MLSTM_STATE_TOL = 2e-3  # tests/test_models.py: mLSTM state


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=tol, atol=tol, err_msg=what)


def _tree_close(got, want, tol):
    gl = [x for x in jax.tree.leaves(map_tree(lambda t: t.detach().numpy(),
                                              got))]
    for a, b in zip(gl, jax.tree.leaves(want), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), rtol=tol, atol=tol)


def _cfgs():
    return (jax_reduce(jax_get_config("xlstm-1.3b")),
            reduce_for_smoke(get_config("xlstm-1.3b")))


# ---------------------------------------------------------------------------
# conv
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
def test_conv_apply_matches_jax(with_state):
    """y and the new state, with and without a carried state; 1e-5 as the
    reference holds its own split (four products a value, fp32)."""
    rng = np.random.default_rng(0)
    B, S, d, width = 2, 11, 16, 4
    p = jax.tree.map(np.asarray, jssm.conv_init(jax.random.PRNGKey(1),
                                                width, d))
    p["b"] = rng.normal(size=d).astype(np.float32)
    x = rng.normal(size=(B, S, d)).astype(np.float32)
    st = rng.normal(size=(B, width - 1, d)).astype(np.float32) \
        if with_state else None
    want_y, want_st = jssm.conv_apply(p, jnp.asarray(x),
                                      None if st is None else jnp.asarray(st))
    y, new = ssm.conv_apply(map_tree(_t, p), _t(x),
                            None if st is None else _t(st))
    _close(y, want_y, 1e-5)
    np.testing.assert_array_equal(new.numpy(), np.asarray(want_st))


def test_conv_state_takes_the_promoted_dtype():
    """A bf16 cached state and an fp32 input give fp32 output and state,
    as ``jnp.concatenate`` promotes them."""
    rng = np.random.default_rng(2)
    p = {"w": _t(rng.normal(size=(4, 8))), "b": torch.zeros(8)}
    st = torch.zeros((1, 3, 8), dtype=torch.bfloat16)
    y, new = ssm.conv_apply(p, _t(rng.normal(size=(1, 1, 8))), st)
    assert y.dtype == new.dtype == torch.float32


# ---------------------------------------------------------------------------
# mLSTM cell
# ---------------------------------------------------------------------------

def _mlstm_inputs(seed, B=2, H=2, S=19, dk=8):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(B, H, S, dk)).astype(np.float32)
               for _ in range(3))
    li = rng.normal(size=(B, H, S)).astype(np.float32)
    lf = np.log(1 / (1 + np.exp(-(rng.normal(size=(B, H, S)) + 2.0)))
                ).astype(np.float32)
    return q, k, v, li, lf


@pytest.mark.parametrize("chunk", [4, 8, 19])
def test_mlstm_parallel_matches_jax(chunk):
    """S = 19 is no multiple of 4 or 8 (the padded tail: li = NEG, lf = 0)
    and chunk 19 is the whole sequence in one chunk.  h to MLSTM_H_TOL,
    the final (C, n, m) to MLSTM_STATE_TOL."""
    q, k, v, li, lf = _mlstm_inputs(3)
    B, H, S, dk = q.shape
    jst = jssm.mlstm_state_init(B, H, dk, dk)
    want_h, want_st = jssm.mlstm_parallel(*map(jnp.asarray,
                                               (q, k, v, li, lf)),
                                          jst, chunk=chunk)
    h, st = ssm.mlstm_parallel(*map(_t, (q, k, v, li, lf)),
                               ssm.mlstm_state_init(B, H, dk, dk),
                               chunk=chunk)
    _close(h, want_h, MLSTM_H_TOL)
    _tree_close(st, want_st, MLSTM_STATE_TOL)


def test_mlstm_parallel_carries_state_across_calls():
    """Two calls (11 + 8 steps, chunk 4) with the state carried equal one
    call over 19 steps, and JAX's two calls (MLSTM_H_TOL)."""
    q, k, v, li, lf = _mlstm_inputs(4)
    B, H, S, dk = q.shape
    full, _ = ssm.mlstm_parallel(*map(_t, (q, k, v, li, lf)),
                                 ssm.mlstm_state_init(B, H, dk, dk), chunk=4)
    st = ssm.mlstm_state_init(B, H, dk, dk)
    jst = jssm.mlstm_state_init(B, H, dk, dk)
    parts, jparts = [], []
    for sl in (slice(0, 11), slice(11, 19)):
        xs = [x[:, :, sl] for x in (q, k, v)] + [x[..., sl] for x in (li, lf)]
        h, st = ssm.mlstm_parallel(*map(_t, xs), st, chunk=4)
        jh, jst = jssm.mlstm_parallel(*map(jnp.asarray, xs), jst, chunk=4)
        parts.append(h)
        jparts.append(np.asarray(jh))
    _close(torch.cat(parts, 2), full, MLSTM_H_TOL)
    _close(torch.cat(parts, 2), np.concatenate(jparts, 2), MLSTM_H_TOL)
    _tree_close(st, jst, MLSTM_STATE_TOL)


def test_mlstm_sequential_matches_jax_and_the_chunked_form():
    """The stepwise oracle against JAX's, and the chunked form against it
    (the reference's own equivalence test, at its tolerances)."""
    q, k, v, li, lf = _mlstm_inputs(5, S=13)
    B, H, S, dk = q.shape
    want_h, want_st = jssm.mlstm_sequential(
        *map(jnp.asarray, (q, k, v, li, lf)), jssm.mlstm_state_init(
            B, H, dk, dk))
    h, st = ssm.mlstm_sequential(*map(_t, (q, k, v, li, lf)),
                                 ssm.mlstm_state_init(B, H, dk, dk))
    _close(h, want_h, MLSTM_H_TOL)
    _tree_close(st, want_st, MLSTM_STATE_TOL)
    hc, stc = ssm.mlstm_parallel(*map(_t, (q, k, v, li, lf)),
                                 ssm.mlstm_state_init(B, H, dk, dk), chunk=4)
    _close(hc, h, MLSTM_H_TOL)
    _tree_close(stc, map_tree(lambda t: t.numpy(), st), MLSTM_STATE_TOL)


def test_mlstm_state_init_matches_jax():
    jst = jssm.mlstm_state_init(2, 3, 4, 5)
    st = ssm.mlstm_state_init(2, 3, 4, 5, lead=(2,))
    for a, b in zip(st, jst, strict=True):
        assert a.shape == (2,) + b.shape and a.dtype == torch.float32
        np.testing.assert_array_equal(a[1].numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# sLSTM cell
# ---------------------------------------------------------------------------

def test_slstm_cell_scan_matches_jax():
    """gx (B, S, 4, H, dh) and r with JAX's init law (fan-in 4: std 0.5),
    from a carried non-trivial state.  1e-5: fp32 gates a step; over 12
    steps the recurrence's gain (~0.5 sqrt(dh) = 1.4 here) does not yet
    amplify the rounding past it."""
    rng = np.random.default_rng(6)
    B, S, H, dh = 2, 12, 2, 8
    gx = rng.normal(size=(B, S, 4, H, dh)).astype(np.float32)
    r = np.asarray(jax.random.truncated_normal(
        jax.random.PRNGKey(7), -2.0, 2.0, (4, H, dh, dh)) * 0.5, np.float32)
    st = tuple(np.asarray(x) for x in jssm.slstm_state_init(B, H, dh))
    st = (rng.normal(size=st[0].shape).astype(np.float32), st[1] + 0.5,
          np.full_like(st[2], 0.3), rng.normal(size=st[3].shape).astype(
              np.float32) * 0.1)
    want_h, want_st = jssm.slstm_cell_scan(jnp.asarray(gx), jnp.asarray(r),
                                           tuple(map(jnp.asarray, st)))
    h, new = ssm.slstm_cell_scan(_t(gx), _t(r), tuple(map(_t, st)))
    _close(h, want_h, 1e-5)
    _tree_close(new, want_st, 1e-5)


def test_slstm_state_init_matches_jax():
    jst = jssm.slstm_state_init(2, 3, 4)
    st = ssm.slstm_state_init(2, 3, 4)
    for a, b in zip(st, jst, strict=True):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# blocks, JAX's weights carried across
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def block_weights():
    jcfg, _ = _cfgs()
    return {"mlstm": jax.tree.map(np.asarray, jssm.mlstm_block_init(
                jax.random.PRNGKey(8), jcfg)),
            "slstm": jax.tree.map(np.asarray, jssm.slstm_block_init(
                jax.random.PRNGKey(9), jcfg))}


def _x(seed, S, d=256):
    return np.random.default_rng(seed).normal(size=(2, S, d)).astype(
        np.float32)


def test_mlstm_block_apply_matches_jax(block_weights):
    """The block over 21 tokens (chunk 8), then 3 decode steps
    (``mlstm_block_decode``, chunk 1) from its state; outputs to MLSTM_H_TOL (they are down-projected mLSTM
    outputs), states to MLSTM_STATE_TOL."""
    jcfg, tcfg = _cfgs()
    jp = block_weights["mlstm"]
    tp = map_tree(_t, jp)
    x = _x(10, 24)
    want, jst = jssm.mlstm_block_apply(jp, jnp.asarray(x[:, :21]), jcfg,
                                       chunk=8)
    y, st = ssm.mlstm_block_apply(tp, _t(x[:, :21]), tcfg, chunk=8)
    _close(y, want, MLSTM_H_TOL)
    _tree_close(st, jst, MLSTM_STATE_TOL)
    for t in range(21, 24):
        want, jst = jssm.mlstm_block_decode(jp, jnp.asarray(x[:, t:t + 1]),
                                            jcfg, jst)
        y, st = ssm.mlstm_block_decode(tp, _t(x[:, t:t + 1]), tcfg, st)
        _close(y, want, MLSTM_H_TOL)
    _tree_close(st, jst, MLSTM_STATE_TOL)


def test_slstm_block_apply_matches_jax(block_weights):
    """The block over 10 tokens, then 2 steps from its state (1e-5, as the
    cell)."""
    jcfg, tcfg = _cfgs()
    jp = block_weights["slstm"]
    tp = map_tree(_t, jp)
    x = _x(11, 12)
    want, jst = jssm.slstm_block_apply(jp, jnp.asarray(x[:, :10]), jcfg)
    y, st = ssm.slstm_block_apply(tp, _t(x[:, :10]), tcfg)
    _close(y, want, 1e-5)
    for t in (10, 11):
        want, jst = jssm.slstm_block_apply(jp, jnp.asarray(x[:, t:t + 1]),
                                           jcfg, jst)
        y, st = ssm.slstm_block_apply(tp, _t(x[:, t:t + 1]), tcfg, st)
        _close(y, want, 1e-5)
    _tree_close(st, jst, 1e-5)


@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_block_shapes_match_jax_init(kind):
    """``*_block_shapes`` has ``*_block_init``'s leaves, paths and shapes,
    at the full width and at the reduced one."""
    for jcfg, tcfg in ((jax_get_config("xlstm-1.3b"),
                        get_config("xlstm-1.3b")), _cfgs()):
        init = getattr(jssm, f"{kind}_block_init")
        want = jax.eval_shape(lambda k: init(k, jcfg), jax.random.PRNGKey(0))
        got = getattr(ssm, f"{kind}_block_shapes")(tcfg)
        wl = jax.tree_util.tree_flatten_with_path(want)[0]
        gl = jax.tree_util.tree_flatten_with_path(
            map_tree(lambda t: jax.ShapeDtypeStruct(tuple(t.shape),
                                                    jnp.float32), got))[0]
        assert [(jax.tree_util.keystr(p), x.shape) for p, x in gl] == \
            [(jax.tree_util.keystr(p), x.shape) for p, x in wl]
