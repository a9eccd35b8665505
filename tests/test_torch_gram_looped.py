"""Port parity for the per-matrix Gram and the looped tree Gram: ``gram``
(its plain version on CPU tensors) against the JAX kernel ``gram_pallas``
run in the Pallas interpreter and its reference ``gram_ref``, and
``tree_gram(fused=False)`` against the JAX package's looped path
``tree_gram(tree, fused=False, impl="pallas_interpret")``.  Inputs are
numpy arrays from each test's own seed; the worker-major buffer is packed
from the same leaves with ``weights.pack_workers``.

Tolerance: rtol 1e-5 with an atol of 1e-5 x the largest entry (as in
tests/test_torch_gram.py): fp32 sums taken in another order, and
off-diagonal entries may cancel far below the diagonal's scale.
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.dist.aggregation import tree_gram as jax_tree_gram
from repro.kernels.gram.kernel import gram_pallas
from repro.kernels.gram.ref import gram_ref
from repro_torch.dist.aggregation import tree_gram
from repro_torch.kernels.gram.kernel import gram_cuda
from repro_torch.kernels.gram.ops import gram
from repro_torch.kernels.gram.ref import gram_plain
from repro_torch.weights import pack_workers

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def _bf16_exact(a: np.ndarray) -> np.ndarray:
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


@pytest.mark.parametrize("n,p", [(64, 3), (1000, 15), (4096, 16), (777, 32),
                                 (2048, 60)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gram_matches_jax_kernel(n, p, dtype):
    rng = np.random.default_rng(n + p)
    G = rng.normal(size=(n, p)).astype(np.float32)
    if dtype == "bfloat16":
        G = _bf16_exact(G)
    Gj = jnp.asarray(G, dtype)
    got = gram(torch.from_numpy(G).to(getattr(torch, dtype))).numpy()
    _close(got, gram_pallas(Gj, interpret=True))
    _close(got, gram_ref(Gj))


def test_gram_bf16_gram_dtype_rounds_before_the_products():
    """gram_dtype='bfloat16' on fp32 G equals the Gram of G cast to bf16,
    which is what the JAX looped path feeds its kernel."""
    rng = np.random.default_rng(21)
    G = rng.normal(size=(1500, 7)).astype(np.float32)
    got = gram(torch.from_numpy(G), gram_dtype="bfloat16").numpy()
    _close(got, gram_pallas(jnp.asarray(G, jnp.bfloat16), interpret=True))
    with pytest.raises(ValueError, match="gram_dtype"):
        gram(torch.from_numpy(G), gram_dtype="float16")


@pytest.mark.parametrize("stride", [1, 2, 7])
def test_gram_plain_reads_strided_views_in_place(stride):
    """The transposed, strided view of a leaf of the (W, N) buffer that the
    looped path hands ``gram`` gives the Gram of its contiguous copy."""
    rng = np.random.default_rng(30 + stride)
    X = torch.from_numpy(rng.normal(size=(6, 5000)).astype(np.float32))
    G = X[:, 700:4900:stride].T                 # (n, 6), strides (s, 5000)
    assert G.stride() == (stride, 5000)
    _close(gram_plain(G).numpy(), gram_plain(G.contiguous()).numpy())
    _close(gram_plain(G).numpy(), (G.T @ G).numpy())


def _leaves(seed, W):
    rng = np.random.default_rng(seed)
    shapes = [(W, 40, 3), (W, 333), (W, 5), (W, 4, 250), (W, 1)]
    return {f"l{i}": rng.normal(size=s).astype(np.float32)
            for i, s in enumerate(shapes)}


# Stride 7 is wider than the 5- and 1-wide leaves: those stay exact.
@pytest.mark.parametrize("stride", [1, 2, 7, 400])
@pytest.mark.parametrize("gram_dtype", ["float32", "bfloat16"])
def test_looped_tree_gram_matches_jax(stride, gram_dtype):
    tree = _leaves(stride, 5)
    X, layout = pack_workers(tree)
    want = jax_tree_gram({k: jnp.asarray(v) for k, v in tree.items()},
                         stride, gram_dtype=gram_dtype,
                         impl="pallas_interpret", fused=False)
    got = tree_gram(X, stride, gram_dtype=gram_dtype, fused=False,
                    leaf_sizes=layout.sizes)
    assert got.dtype == torch.float32 and got.shape == (5, 5)
    _close(got.numpy(), want)


def test_looped_equals_fused_without_sketch():
    tree = _leaves(9, 7)
    X, layout = pack_workers(tree)
    _close(tree_gram(X, fused=False, leaf_sizes=layout.sizes).numpy(),
           tree_gram(X).numpy())


@pytest.mark.parametrize("sizes", [None, [10, 20], [1330, 0, 1]])
def test_looped_tree_gram_needs_leaf_sizes(sizes):
    X = torch.zeros((3, 1331))
    with pytest.raises(ValueError, match="leaf_sizes"):
        tree_gram(X, fused=False, leaf_sizes=sizes)


def test_gram_cuda_refuses_cpu_tensors():
    """No fallback: the CUDA wrapper raises on a CPU tensor."""
    with pytest.raises(ValueError, match="CUDA device"):
        gram_cuda(torch.zeros((10, 3)))
