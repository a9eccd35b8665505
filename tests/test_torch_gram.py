"""Port parity: the Gram and combine kernels' plain versions against the JAX
kernels (run in the Pallas interpreter, as tests/test_kernels_interpret.py
runs them) and their XLA references.  Inputs are numpy arrays from the
test's own seed."""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.gram import ref as jref
from repro.kernels.gram.kernel import gram_pallas, tree_gram_pallas
from repro.kernels.weighted_sum.kernel import weighted_sum_pallas
from repro_torch.kernels.gram import ref as tref
from repro_torch.kernels.gram.kernel import tree_gram_cuda
from repro_torch.kernels.gram.ops import tree_gram_fused
from repro_torch.kernels.weighted_sum.kernel import weighted_sum_cuda
from repro_torch.kernels.weighted_sum.ops import weighted_sum
from repro_torch.kernels.weighted_sum.ref import weighted_sum_plain

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

BLOCK_N = 128


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    """Values representable in bf16, so both packages see identical inputs."""
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("n", [1, 5, 127, 128, 129, 1000, 4097])
@pytest.mark.parametrize("block_n", [1, 64, 1024])
@pytest.mark.parametrize("stride", [1, 2, 3, 7])
def test_chunk_schedule_matches_jax(n, block_n, stride):
    assert tref.chunk_schedule(n, block_n, stride) == \
        jref.chunk_schedule(n, block_n, stride)


@pytest.mark.parametrize("sizes", [[1], [7, 300, 2], [128, 128, 5, 1000],
                                   [3] * 50])
@pytest.mark.parametrize("stride", [1, 3])
def test_piece_plan_matches_jax(sizes, stride):
    assert tref.piece_plan(sizes, 64, stride) == \
        jref.piece_plan(sizes, 64, stride)


# Tolerance: fp32 sums taken in another order (XLA / the interpreter vs
# torch's einsum) differ by a few ulp of the sum of |terms|, so rtol 1e-5
# with an atol of 1e-5 x the largest entry (off-diagonal entries may
# cancel far below the diagonal's scale).
@pytest.mark.parametrize("W", [3, 6, 15])
@pytest.mark.parametrize("n", [700, 1029])
@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tree_gram_plain_matches_jax_kernel(W, n, stride, dtype):
    rng = np.random.default_rng(1000 * W + 10 * stride + n)
    X = rng.normal(size=(W, n)).astype(np.float32)
    if dtype == "bfloat16":
        X = _bf16_exact(X)
    Xj = jnp.asarray(X, dtype)
    got = tref.tree_gram_plain(torch.from_numpy(X).to(getattr(torch, dtype)),
                               stride, BLOCK_N).numpy()
    want_kernel = np.asarray(tree_gram_pallas(
        Xj, sketch_stride=stride, block_n=BLOCK_N, interpret=True))
    want_ref = np.asarray(jref.tree_gram_chunk_ref(
        Xj, sketch_stride=stride, block_n=BLOCK_N))
    atol = 1e-5 * np.abs(want_ref).max()
    np.testing.assert_allclose(got, want_kernel, rtol=1e-5, atol=atol)
    np.testing.assert_allclose(got, want_ref, rtol=1e-5, atol=atol)


def test_tree_gram_bf16_gram_dtype_matches_jax():
    """gram_dtype='bfloat16' on an fp32 stack rounds before the products."""
    rng = np.random.default_rng(7)
    leaves = [rng.normal(size=(5, 40, 3)).astype(np.float32),
              rng.normal(size=(5, 333)).astype(np.float32)]
    X = np.concatenate([x.reshape(5, -1) for x in leaves], axis=1)
    from repro.kernels.gram.ops import tree_gram_fused as jax_fused
    want = np.asarray(jax_fused([jnp.asarray(x) for x in leaves],
                                sketch_stride=2, gram_dtype="bfloat16",
                                block_n=BLOCK_N))
    got = tree_gram_fused(torch.from_numpy(X), sketch_stride=2,
                          gram_dtype="bfloat16", block_n=BLOCK_N).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_tree_gram_plain_reads_row_strided_views():
    """A view of the rows of a wider buffer needs no copy and gives the
    same Gram as the contiguous stack."""
    rng = np.random.default_rng(3)
    big = torch.from_numpy(rng.normal(size=(4, 900)).astype(np.float32))
    view = big[:, 50:650]
    np.testing.assert_array_equal(
        tref.tree_gram_plain(view, 2, BLOCK_N).numpy(),
        tref.tree_gram_plain(view.contiguous(), 2, BLOCK_N).numpy())


def test_gram_plain_matches_jax_kernel():
    rng = np.random.default_rng(11)
    G = rng.normal(size=(300, 6)).astype(np.float32)
    got = tref.gram_plain(torch.from_numpy(G)).numpy()
    want = np.asarray(gram_pallas(jnp.asarray(G), block_n=BLOCK_N,
                                  interpret=True))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


# Tolerance: the JAX kernel sums g * c over the padded worker axis in
# XLA's order, the plain version in worker order; fp32, rtol 1e-5 and an
# atol of 1e-6 x sum_w |c_w| max|x|.
@pytest.mark.parametrize("W", [1, 3, 15])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weighted_sum_plain_matches_jax_kernel(W, dtype):
    rng = np.random.default_rng(50 + W)
    n = 2500
    X = rng.normal(size=(W, n)).astype(np.float32)
    if dtype == "bfloat16":
        X = _bf16_exact(X)
    c = rng.normal(size=(W,)).astype(np.float32)
    want = np.asarray(weighted_sum_pallas(
        jnp.asarray(X, dtype).T, jnp.asarray(c), block_n=512,
        interpret=True)).astype(np.float32)
    got = weighted_sum_plain(torch.from_numpy(X).to(getattr(torch, dtype)),
                             torch.from_numpy(c)).float().numpy()
    scale = np.abs(c).sum() * np.abs(X).max()
    if dtype == "bfloat16":
        # both round the same fp32 sum to bf16; a sum that lands within
        # an ulp of a rounding boundary may round either way
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-6 * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * scale)


def test_ops_dispatch_cpu_to_plain():
    rng = np.random.default_rng(5)
    X = torch.from_numpy(rng.normal(size=(4, 3000)).astype(np.float32))
    c = torch.from_numpy(rng.normal(size=(4,)).astype(np.float32))
    np.testing.assert_array_equal(
        tree_gram_fused(X, sketch_stride=3).numpy(),
        tref.tree_gram_plain(X, 3, 1024).numpy())
    np.testing.assert_array_equal(weighted_sum(X, c).numpy(),
                                  weighted_sum_plain(X, c).numpy())


@pytest.mark.parametrize("fn", ["gram", "combine"])
def test_kernel_wrappers_refuse_cpu_tensors(fn):
    """The CUDA wrappers launch on CUDA tensors only; they never hand a
    tensor to the plain version themselves."""
    X = torch.zeros((3, 64))
    with pytest.raises(ValueError, match="CUDA"):
        if fn == "gram":
            tree_gram_cuda(X)
        else:
            weighted_sum_cuda(X, torch.zeros(3))


def test_gram_dtype_validated():
    with pytest.raises(ValueError, match="gram_dtype"):
        tree_gram_fused(torch.zeros((2, 8)), gram_dtype="float16")
