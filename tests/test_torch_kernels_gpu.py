"""The port's CUDA kernels against their plain PyTorch versions on the card.

Marked ``gpu``; on a machine without a CUDA device every test skips (the
card is detected inside a fixture, never at import).  Run on the card with

    PYTHONPATH=src python -m pytest -m gpu tests/test_torch_kernels_gpu.py

This file imports no JAX (the card's machine has none), and replaces the
suite's module-teardown fixture, which clears JAX's caches, by a no-op.
"""

from __future__ import annotations

import pytest
import torch

from repro_torch.dist.aggregation import AggregatorConfig, aggregate_tree
from repro_torch.kernels.gram import kernel as gram_kernel
from repro_torch.kernels.gram.ops import tree_gram_fused
from repro_torch.kernels.gram.ref import tree_gram_plain
from repro_torch.kernels.weighted_sum import kernel as wsum_kernel
from repro_torch.kernels.weighted_sum.ops import weighted_sum
from repro_torch.kernels.weighted_sum.ref import weighted_sum_plain

pytestmark = pytest.mark.gpu

# Tolerances: both sides sum fp32 products, in different orders.
GRAM_TOL = 2e-5        # of sqrt(K_ii K_jj)
WSUM_TOL = 1e-5        # of sum_w |c_w x_w|
BF16_ULP = 2.0 ** -7   # one bf16 ulp (relative): the fp32 sums may
                       # straddle a rounding boundary


@pytest.fixture(scope="module", autouse=True)
def _drop_compile_caches():
    """Overrides tests/conftest.py's JAX cache clearing: no JAX here."""
    yield


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    from repro_torch.device import resolve_device
    return resolve_device("cuda")


def _data(seed, W, n, dtype, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    X = torch.randn((W, n), generator=g, device=device).to(dtype)
    c = torch.randn(W, generator=g, device=device)
    return X, c


def _gram_close(K, K_plain):
    d = torch.sqrt(torch.clamp(torch.diagonal(K_plain), min=1e-30))
    rel = ((K - K_plain).abs() / (d[:, None] * d[None, :])).max()
    assert float(rel) <= GRAM_TOL, float(rel)


@pytest.mark.parametrize("W", [1, 3, 15, 16, 17, 40])
@pytest.mark.parametrize("n", [1, 1000, 100_003])
@pytest.mark.parametrize("stride", [1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_tree_gram_kernel_matches_plain(cuda, W, n, stride, dtype):
    X, _ = _data(W * n + stride, W, n, dtype, cuda)
    before = gram_kernel.launches
    K = gram_kernel.tree_gram_cuda(X, sketch_stride=stride)
    K2 = gram_kernel.tree_gram_cuda(X, sketch_stride=stride)
    torch.cuda.synchronize()
    assert gram_kernel.launches == before + 2
    assert K.dtype == torch.float32 and K.shape == (W, W)
    assert torch.equal(K, K2) and torch.equal(K, K.T)
    _gram_close(K, tree_gram_plain(X, stride, 1024))


@pytest.mark.parametrize("block_n", [1, 100, 4096])
def test_tree_gram_kernel_block_sizes_and_row_views(cuda, block_n):
    X, _ = _data(5, 20, 70_001, torch.float32, cuda)
    view = X[3:18, 17:60_017]           # strided rows, unaligned start
    K = gram_kernel.tree_gram_cuda(view, sketch_stride=2, block_n=block_n)
    _gram_close(K, tree_gram_plain(view, 2, block_n))


def test_tree_gram_round_bf16(cuda):
    X, _ = _data(6, 9, 50_000, torch.float32, cuda)
    K = tree_gram_fused(X, gram_dtype="bfloat16")
    _gram_close(K, tree_gram_plain(X.to(torch.bfloat16), 1, 1024))


@pytest.mark.parametrize("W", [1, 3, 15, 100])
@pytest.mark.parametrize("n", [1, 3, 4, 1001, 100_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_weighted_sum_kernel_matches_plain(cuda, W, n, dtype):
    X, c = _data(W + n, W, n, dtype, cuda)
    before = wsum_kernel.launches
    d = wsum_kernel.weighted_sum_cuda(X, c)
    torch.cuda.synchronize()
    assert wsum_kernel.launches == before + 1
    assert d.dtype == dtype and d.shape == (n,)
    d_plain = weighted_sum_plain(X, c)
    bound = WSUM_TOL * weighted_sum_plain(X.float().abs(), c.abs())
    if dtype == torch.bfloat16:
        bound = bound + BF16_ULP * d_plain.float().abs()
    assert ((d.float() - d_plain.float()).abs() <= bound).all()


def test_weighted_sum_unaligned_views(cuda):
    """Views whose rows are not 16-byte aligned take the scalar path."""
    X, c = _data(8, 6, 9_999, torch.float32, cuda)
    view = X[:, 1:]
    d = wsum_kernel.weighted_sum_cuda(view, c)
    d_plain = weighted_sum_plain(view, c)
    bound = WSUM_TOL * weighted_sum_plain(view.abs(), c.abs())
    assert ((d - d_plain).abs() <= bound).all()


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    X = torch.zeros((3, 64), device=cuda)
    with pytest.raises(ValueError):
        gram_kernel.tree_gram_cuda(X.to(torch.float16))
    with pytest.raises(ValueError):
        gram_kernel.tree_gram_cuda(X.T)                 # column-strided
    with pytest.raises(ValueError):
        wsum_kernel.weighted_sum_cuda(X, torch.zeros(4, device=cuda))
    with pytest.raises(ValueError):
        wsum_kernel.weighted_sum_cuda(X, torch.zeros(3))  # c on the CPU


@pytest.mark.parametrize("name", ["flag", "mean", "geomed"])
def test_aggregate_tree_cuda_matches_cpu(cuda, name):
    """The whole aggregation on the card (kernels) against the CPU (plain
    versions), FA tolerance rtol 5e-3 / atol 5e-4."""
    X, _ = _data(11, 15, 200_001, torch.float32, "cpu")
    X[:3] *= -10.0
    cfg = AggregatorConfig(name=name, f=3)
    g0, w0 = gram_kernel.launches, wsum_kernel.launches
    d, aux = aggregate_tree(X.to(cuda), cfg)
    assert (gram_kernel.launches, wsum_kernel.launches) == (g0 + 1, w0 + 1)
    d_cpu, aux_cpu = aggregate_tree(X, cfg)
    torch.testing.assert_close(aux["weights"].cpu(), aux_cpu["weights"],
                               rtol=5e-3, atol=5e-4)
    scale = d_cpu.abs().max()
    torch.testing.assert_close(d.cpu() / scale, d_cpu / scale, rtol=5e-3,
                               atol=5e-4)
    assert weighted_sum(X.to(cuda), aux["weights"]).device.type == "cuda"
