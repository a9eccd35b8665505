"""The coordinate-statistics kernel's algorithm, replayed on the CPU.

``csrc/coord_stats.cu`` sorts each column's keys with a generated network
(inactive workers are +inf and are never read), takes the center from the
sorted keys, and for MeaMed / Phocas keeps ``ka = max(W_a - f, 1)`` values
as a window ``s[lo .. lo + ka)`` of the sorted column: ``lo`` is the
number of leading positions i whose window end lies nearer the center,
``s[i + ka] - c < c - s[i]``.  When the window's farthest value inside is
exactly as far as its nearest value outside (and not at distance 0), the
worker indices decide which of those are kept: the kernel then reads the
column again in worker order, keeps every value nearer than that distance
and the tied ones of lowest worker index, sorts the kept keys with the
same network and sums the first ka.  Either way the kept values are summed
in ascending order, sequentially in fp32, then divided once by ka.

``replay`` repeats that in numpy fp32, column-vectorised, and the tests
hold it bit for bit against ``coord_stat_plain`` (the kernel's plain
version, held bit-equal to the kernel on the card by ``chip_smoke.py``)
and against the JAX references (median exactly, the means at rtol / atol
1e-5, tests/test_coord_stats.py's tolerance): exhaustively over every
column of R <= 6 values from {-2, ..., 2}, every mask of R bits (all
inactive included), f in {0, 1, 2, 5} and all four ops; and on random
columns at R = 9, 15 (the paper's W and Bulyan's theta) and 33 (a padded
width), on normal data, on bf16-rounded data (many exact duplicates) and
on small integers (exact distance ties).  ``replay_bulyan_warp`` repeats
``csrc/krum_select.cu``'s one-warp Bulyan selection (W <= 32) and is held
against the plain version and the JAX package, picks equal.  Inputs are
numpy arrays from each case's own seed.
"""

from __future__ import annotations

import itertools
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aggregators as jagg
from repro.kernels.coord_stats import ref as jref
from repro_torch.kernels.coord_stats import networks
from repro_torch.kernels.coord_stats.ref import COORD_OPS, coord_stat_plain

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

INF = np.float32(np.inf)
JREF = {"median": lambda G, f: jref.median_ref(G),
        "trimmed_mean": jref.trimmed_mean_ref,
        "meamed": jref.meamed_ref, "phocas": jref.phocas_ref}


def _sort(keys: np.ndarray) -> np.ndarray:
    """The kernel's network over the rows of keys (P, n), P its width."""
    k = keys.copy()
    for i, j in networks.merge_exchange(k.shape[0]):
        lo, hi = np.minimum(k[i], k[j]), np.maximum(k[i], k[j])
        k[i], k[j] = lo, hi
    return k


def _seq_sum(rows, take) -> np.ndarray:
    """sum of rows[i] where take[i], sequential fp32 in ascending i."""
    acc = np.zeros(rows.shape[1], np.float32)
    for r, t in zip(rows, take):
        acc = np.where(t, acc + r, acc).astype(np.float32)
    return acc


def replay(X: np.ndarray, act: np.ndarray, op: str, f: int,
           stats: dict | None = None) -> np.ndarray:
    """The kernel's statistic of X (R, n) fp32 over the workers ``act``
    (R,) bool marks active; (n,) fp32."""
    R, n = X.shape
    P = networks.width_for(R)
    keys = np.full((P, n), INF, np.float32)
    keys[:R][act] = X[act]
    s = _sort(keys)
    wa_true = int(act.sum())
    wa = max(wa_true, 1)
    if op in ("median", "meamed"):
        c = ((s[(wa - 1) // 2] + s[wa // 2]) * np.float32(0.5))
    else:
        kt = min(f, (wa - 1) // 2)
        idx = np.arange(P)[:, None]
        c = _seq_sum(s, (idx >= kt) & (idx < wa - kt)) / np.float32(
            max(wa - 2 * kt, 1))
    c = c.astype(np.float32)
    if op in ("median", "trimmed_mean"):
        return c
    ka = max(wa - f, 1)
    if wa_true == 0:                      # the stable argsort keeps worker 0
        return X[0].copy()
    with np.errstate(invalid="ignore"):
        lo = np.zeros(n, np.int64)
        run = np.ones(n, bool)
        for i in range(P - ka):
            run &= (s[i + ka] - c) < (c - s[i])
            lo += run
        cols = np.arange(n)
        far_in = np.maximum(np.abs(s[lo, cols] - c),
                            np.abs(s[lo + ka - 1, cols] - c))
        out_lo = np.where(lo > 0, s[np.maximum(lo - 1, 0), cols], INF)
        out_hi = np.where(lo + ka < P, s[np.minimum(lo + ka, P - 1), cols],
                          INF)
        near_out = np.minimum(np.abs(out_lo - c), np.abs(out_hi - c))
    idx = np.arange(P)[:, None]
    out = _seq_sum(s, (idx >= lo) & (idx < lo + ka)) / np.float32(ka)
    slow = ~((far_in < near_out) | (far_in == 0))
    if stats is not None:
        stats["tie_columns"] = stats.get("tie_columns", 0) + int(slow.sum())
    if slow.any():
        g, cc, D = X[:, slow], c[slow], far_in[slow]
        dist = np.where(act[:, None], np.abs(g - cc), INF)
        need = ka - (dist < D).sum(0)
        seen = np.zeros(g.shape[1], np.int64)
        kept = np.full((P, g.shape[1]), INF, np.float32)
        for w in range(R):
            tied = act[w] & (dist[w] == D)
            kept[w] = np.where((dist[w] < D) | (tied & (seen < need)), g[w],
                               INF)
            seen += tied
        out[slow] = _seq_sum(_sort(kept), idx < ka) / np.float32(ka)
    return out.astype(np.float32)


def _plain(X, act, op, f):
    return coord_stat_plain(torch.from_numpy(X), op, f,
                            mask=torch.from_numpy(act.astype(np.float32))
                            ).numpy()


def _jax(X, act, op, f):
    if act.all():
        return np.asarray(JREF[op](jnp.asarray(X), f))
    return np.asarray(jagg.MASKED_COORDWISE[op](
        jnp.asarray(X), jnp.asarray(act.astype(np.float32)), f=f))


def _close(op, got, want):
    if op == "median":
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("R", [1, 2, 3, 4, 5, 6])
@pytest.mark.parametrize("op", COORD_OPS)
def test_replay_exhaustive_small_columns(R, op):
    """Every column of R values from {-2..2}, every mask, f in 0, 1, 2, 5:
    bit-equal to the plain version; and to the JAX references within
    their tolerance under the masks with none, one, all but one and all
    workers active (the plain version meets the JAX references under
    every mask in tests/test_torch_coord_stats.py)."""
    X = np.array(list(itertools.product(range(-2, 3), repeat=R)),
                 np.float32).T.copy()
    full = (1 << R) - 1
    for bits in range(1 << R):
        act = np.array([(bits >> w) & 1 for w in range(R)], bool)
        for f in (0, 1, 2, 5):
            got = replay(X, act, op, f)
            np.testing.assert_array_equal(got, _plain(X, act, op, f),
                                          err_msg=f"mask {act} f={f}")
            if bits in (0, 1 << (R // 2), full ^ 1, full):
                _close(op, got, _jax(X, act, op, f))


def _random(kind: str, R: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "ties":
        X = rng.integers(-3, 4, size=(R, n)).astype(np.float32)
        X[R - 1] = X[0]
        return X
    X = rng.normal(size=(R, n)).astype(np.float32)
    if kind == "bf16":
        X = torch.from_numpy(X).bfloat16().float().numpy()
    return X


@pytest.mark.parametrize("R", [9, 15, 33])
@pytest.mark.parametrize("kind", ["normal", "bf16", "ties"])
@pytest.mark.parametrize("op", COORD_OPS)
def test_replay_random_columns(R, kind, op):
    X = _random(kind, R, 4000, 100 * R + len(kind))
    rng = np.random.default_rng(R)
    masks = [np.ones(R, bool), np.zeros(R, bool), rng.random(R) < 0.6]
    stats: dict = {}
    for act in masks:
        for f in (0, 1, 3, 6, 40):
            got = replay(X, act, op, f, stats)
            np.testing.assert_array_equal(got, _plain(X, act, op, f),
                                          err_msg=f"mask {act} f={f}")
            _close(op, got, _jax(X, act, op, f))
    if op in ("meamed", "phocas") and kind == "ties":
        assert stats["tie_columns"] > 0     # the worker-order path ran


def test_replay_ties_are_rare_on_normal_data():
    """On normal fp32 data the worker-order path is the exception: it runs
    only where a kept and a dropped value lie exactly equally far from the
    center."""
    X = _random("normal", 15, 20_000, 5)
    stats: dict = {}
    replay(X, np.ones(15, bool), "meamed", 3, stats)
    replay(X, np.ones(15, bool), "phocas", 3, stats)
    assert stats["tie_columns"] <= 4


# ---------------------------------------------------------------------------
# Bulyan's selection on one warp (csrc/krum_select.cu, bulyan_select_warp)
# ---------------------------------------------------------------------------

def replay_bulyan_warp(D: np.ndarray, f: int) -> list[int]:
    """``bulyan_select_warp`` in numpy fp32: lane i holds row i (self +inf),
    picked workers count as big; each round a lane sorts its row with the
    network at width 16 or 32 (+inf padding), sums its first k in
    ascending order, and the argmin over (score, lane) takes the lowest
    lane on ties."""
    w = D.shape[0]
    nw = 16 if w <= 16 else 32
    k, theta = max(w - f - 2, 1), max(w - 2 * f, 1)
    rows = np.full((nw, 32), INF, np.float32)
    off = ~np.eye(w, dtype=bool)
    rows[:w, :w] = np.where(off, D, INF).T      # column l is lane l's row
    m = np.float32(max(0.0, float(D[off].max()) if w > 1 else 0.0))
    big = np.float32(np.float32(4.0) * m + np.float32(1.0))
    avail = np.zeros(32, bool)
    avail[:w] = True
    lane = np.arange(32)
    picks = []
    for _ in range(theta):
        v = rows.copy()
        picked = np.zeros((nw, 32), bool)
        picked[:w, :w] = ~avail[:w, None] & off
        v[picked] = big
        s = _sort(v)
        score = _seq_sum(s, np.arange(nw)[:, None] < k)
        score = np.where(avail & (lane < w), score, INF)
        pick = int(np.lexsort((lane, score))[0])
        picks.append(pick)
        avail[pick] = False
    return picks


@pytest.mark.parametrize("W", [1, 2, 3, 8, 15, 16, 17, 32])
@pytest.mark.parametrize("dup", [0, 3])
def test_bulyan_warp_replay_matches_plain_and_jax(W, dup):
    from repro_torch.kernels.coord_stats.ref import bulyan_select_plain
    rng = np.random.default_rng(W + 100 * dup)
    P = rng.normal(size=(W, 6)).astype(np.float32)
    P[:min(dup, W)] = 0.0
    D = ((P[:, None, :] - P[None, :, :]) ** 2).sum(-1).astype(np.float32)
    np.fill_diagonal(D, 0.0)
    for f in sorted({0, 1, 3, W // 2}):
        got = replay_bulyan_warp(D, f)
        assert got == bulyan_select_plain(torch.from_numpy(D), f).tolist()
        assert got == np.asarray(jagg.bulyan_select(jnp.asarray(D),
                                                    f)).tolist()

