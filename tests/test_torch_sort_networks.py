"""The generated sorting networks of the coordinate-statistics and selection
kernels, checked on the CPU.

``repro_torch.kernels.coord_stats.networks`` generates Batcher's
merge-exchange networks and writes ``csrc/sort_networks.cuh``, which
``csrc/coord_stats.cu`` and ``csrc/krum_select.cu`` include.  A network
that sorts every 0/1 input sorts every input (the 0/1 principle, Knuth,
TAOCP vol. 3, section 5.3.4), so the exact widths 2..16 are proved over
all 2^n 0/1 inputs; the padded widths 32, 64 and 128 sort random columns
with ties.  The checked-in header must equal what the generator writes,
and the build must rebuild when the header changes.  The probe's source
patches (``launch/coord_probe.py``) must still match the shipped source.
``replay_krum_warp`` repeats ``csrc/krum_select.cu``'s one-warp Krum
scores (W <= 32) in numpy fp32 and must be bit-equal to the plain version.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.coord_stats import networks
from repro_torch.kernels.coord_stats.ref import krum_scores_plain
from repro_torch.launch import coord_probe


def _run(net, keys: np.ndarray) -> np.ndarray:
    """The network over the rows of keys (n, m), as min/max exchanges."""
    k = keys.copy()
    for i, j in net:
        lo, hi = np.minimum(k[i], k[j]), np.maximum(k[i], k[j])
        k[i], k[j] = lo, hi
    return k


@pytest.mark.parametrize("n", range(2, 17))
def test_exact_networks_sort_every_zero_one_input(n):
    bits = np.arange(1 << n)
    keys = ((bits[None, :] >> np.arange(n)[:, None]) & 1).astype(np.int8)
    got = _run(networks.merge_exchange(n), keys)
    assert (np.diff(got, axis=0) >= 0).all()
    np.testing.assert_array_equal(got.sum(0), keys.sum(0))


@pytest.mark.parametrize("n", networks.PADDED)
def test_padded_networks_sort_random_columns_with_ties(n):
    rng = np.random.default_rng(n)
    keys = rng.integers(-5, 6, size=(n, 10_000)).astype(np.float32)
    keys[:, ::3] = rng.normal(size=(n, keys[:, ::3].shape[1]))
    got = _run(networks.merge_exchange(n), keys)
    np.testing.assert_array_equal(got, np.sort(keys, axis=0))


def test_comparator_counts_and_widths():
    count = {n: len(networks.merge_exchange(n)) for n in (1, 9, 15, 16, 32)}
    assert count == {1: 0, 9: 26, 15: 59, 16: 63, 32: 191}
    assert all(i < j for n in (15, 128) for i, j in networks.merge_exchange(n))
    assert [networks.width_for(r) for r in (1, 9, 16, 17, 33, 65, 128)] == \
        [1, 9, 16, 32, 64, 128, 128]
    for r in (0, 129):
        with pytest.raises(ValueError):
            networks.width_for(r)


def test_checked_in_header_is_generated():
    assert networks.HEADER == _build.CSRC / "sort_networks.cuh"
    assert networks.HEADER.read_text() == networks.header_text()


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    for name in ("coord_stats.cu", "krum_select.cu", "sort_networks.cuh"):
        (tmp_path / name).write_text((_build.CSRC / name).read_text())
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert [p.name for p in _build._sources(tmp_path / "coord_stats.cu")] \
        == ["coord_stats.cu", "sort_networks.cuh"]
    before = {n: _build._target(n) for n in ("coord_stats", "krum_select")}
    header = tmp_path / "sort_networks.cuh"
    header.write_text(header.read_text() + "// edited\n")
    after = {n: _build._target(n) for n in ("coord_stats", "krum_select")}
    assert all(before[n] != after[n] for n in before)


@pytest.mark.parametrize("name", list(coord_probe.PATCHES))
def test_coord_probe_patches_match_the_source(name):
    source = (_build.CSRC / "coord_stats.cu").read_text()
    out = coord_probe.patched(name, source)
    assert (out == source) == (name == "shipped")


def replay_krum_warp(D: np.ndarray, f: int) -> np.ndarray:
    """``krum_scores_warp`` in numpy fp32: lane i holds row i of D with
    self and the padding +inf, at width 16 (W <= 16) or 32, sorts it with
    the generated network and sums its first k = max(W - f - 2, 1)
    sequentially in ascending order."""
    w = D.shape[0]
    nw = 16 if w <= 16 else 32
    k = max(w - f - 2, 1)
    rows = np.full((nw, w), np.inf, np.float32)     # column l: lane l's row
    rows[:w] = np.where(np.eye(w, dtype=bool), np.inf, D).T
    s = _run(networks.merge_exchange(nw), rows)
    acc = np.zeros(w, np.float32)
    for i in range(k):
        acc = (acc + s[i]).astype(np.float32)
    return acc


@pytest.mark.parametrize("W", [1, 2, 3, 15, 16, 17, 31, 32])
@pytest.mark.parametrize("dup", [0, 3])
def test_krum_warp_replay_is_bit_equal_to_plain(W, dup):
    """The warp body and the plain version sort the same multiset and sum
    the same k values in the same order, so the scores are bit-equal, the
    first ``dup`` workers' exact ties (the zero attack's) included; W = 1
    scores +inf."""
    rng = np.random.default_rng(W + 100 * dup)
    P = rng.normal(size=(W, 6)).astype(np.float32)
    P[:min(dup, W)] = 0.0
    D = ((P[:, None, :] - P[None, :, :]) ** 2).sum(-1).astype(np.float32)
    np.fill_diagonal(D, 0.0)
    for f in sorted({0, 1, 3, W // 2}):
        got = replay_krum_warp(D, f)
        want = krum_scores_plain(torch.from_numpy(D), f).numpy()
        np.testing.assert_array_equal(got, want)
        assert W > 1 or np.isposinf(got).all()
