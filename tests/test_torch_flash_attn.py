"""Port parity: flash attention's plain version (what ``flash_attention``
runs on CPU tensors) against the JAX kernel, run in the Pallas
interpreter as tests/test_kernels.py runs it, and against its XLA
reference.  Inputs are numpy arrays from each test's own seed; bf16 cases
use values exactly representable in bf16, so both packages see identical
inputs.

Tolerances are those of tests/test_kernels.py:157-159: rtol = atol = 2e-4
in fp32 (fp32 sums taken in another order, and the scale applied before
the product in the kernels but after it in the references), 4e-2 in bf16
(the output is rounded to bf16, 2^-8 relative, from fp32 sums that differ
in their last bits).
"""

from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.kernel import flash_attn_pallas
from repro.kernels.flash_attn.ref import attention_mask as jax_mask
from repro.kernels.flash_attn.ref import flash_attn_ref
from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda
from repro_torch.kernels.flash_attn.ops import flash_attention
from repro_torch.kernels.flash_attn.ref import attention_mask

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

TOL = {"float32": 2e-4, "bfloat16": 4e-2}


def _inputs(seed, q_shape, kv_shape, dtype="float32"):
    rng = np.random.default_rng(seed)
    arrs = [rng.normal(size=s).astype(np.float32)
            for s in (q_shape, kv_shape, kv_shape)]
    if dtype == "bfloat16":
        arrs = [np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))
                for a in arrs]
    return arrs


def _both(arrs, dtype):
    jx = [jnp.asarray(a, dtype) for a in arrs]
    th = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrs]
    return jx, th


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("b,h,sq,sk,d", [
    (1, 2, 128, 128, 64),     # square prefill
    (2, 1, 64, 64, 128),
    (1, 2, 1, 256, 64),       # decode: one query, long cache
    (1, 1, 100, 100, 64),     # not a multiple of a block
    (1, 1, 37, 256, 64),      # chunked prefill tail
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_matches_jax_kernel(b, h, sq, sk, d, dtype):
    arrs = _inputs(sq * 1000 + sk + d, (b, h, sq, d), (b, h, sk, d), dtype)
    (qj, kj, vj), (q, k, v) = _both(arrs, dtype)
    got = flash_attention(q, k, v, causal=True)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, flash_attn_pallas(qj, kj, vj, causal=True, block_q=64,
                                  block_k=64, interpret=True), dtype)
    _close(got, flash_attn_ref(qj, kj, vj, causal=True), dtype)


@pytest.mark.parametrize("window", [16, 64])
@pytest.mark.parametrize("causal", [True, False])
def test_sliding_window(window, causal):
    arrs = _inputs(window + causal, (1, 2, 128, 64), (1, 2, 128, 64))
    (qj, kj, vj), (q, k, v) = _both(arrs, "float32")
    got = flash_attention(q, k, v, causal=causal, window=window)
    _close(got, flash_attn_pallas(qj, kj, vj, causal=causal, window=window,
                                  block_q=64, block_k=64, interpret=True),
           "float32")
    _close(got, flash_attn_ref(qj, kj, vj, causal=causal, window=window),
           "float32")


def test_non_causal():
    arrs = _inputs(11, (1, 1, 64, 64), (1, 1, 96, 64))
    (qj, kj, vj), (q, k, v) = _both(arrs, "float32")
    got = flash_attention(q, k, v, causal=False)
    _close(got, flash_attn_pallas(qj, kj, vj, causal=False, block_q=64,
                                  block_k=64, interpret=True), "float32")


@pytest.mark.parametrize("causal", [True, False])
def test_more_queries_than_keys(causal):
    """sq > sk: under causal masking the first sq - sk rows see no key and
    must be exactly 0 (the p * mask rule), not NaN."""
    arrs = _inputs(12 + causal, (1, 2, 40, 64), (1, 2, 24, 64))
    (qj, kj, vj), (q, k, v) = _both(arrs, "float32")
    got = flash_attention(q, k, v, causal=causal)
    assert torch.isfinite(got).all()
    if causal:
        assert (got[:, :, :16] == 0).all()
    _close(got, flash_attn_pallas(qj, kj, vj, causal=causal, block_q=8,
                                  block_k=8, interpret=True), "float32")
    _close(got, flash_attn_ref(qj, kj, vj, causal=causal), "float32")


@pytest.mark.parametrize("heads,kv", [(6, 1), (6, 2), (6, 3), (15, 5)])
@pytest.mark.parametrize("window", [None, 16])
def test_gqa_equals_jax_on_repeated_kv(heads, kv, window):
    """KV < H heads: equal to the JAX kernel on k and v repeated H / KV
    times, which is what the JAX package's ``attend`` hands it."""
    arrs = _inputs(heads * 10 + kv, (2, heads, 48, 64), (2, kv, 48, 64))
    (qj, kj, vj), (q, k, v) = _both(arrs, "float32")
    rep = heads // kv
    got = flash_attention(q, k, v, causal=True, window=window)
    want = flash_attn_pallas(qj, jnp.repeat(kj, rep, axis=1),
                             jnp.repeat(vj, rep, axis=1), causal=True,
                             window=window, block_q=48, block_k=48,
                             interpret=True)
    _close(got, want, "float32")


def test_value_ones_gives_rows_of_ones():
    """v = ones => every output row is exactly ones (softmax sums to 1)."""
    arrs = _inputs(13, (1, 1, 64, 32), (1, 1, 64, 32))
    q, k = (torch.from_numpy(a) for a in arrs[:2])
    got = flash_attention(q, k, torch.ones((1, 1, 64, 32)), causal=True)
    np.testing.assert_allclose(got.numpy(), 1.0, rtol=1e-5)


def test_scale_argument():
    arrs = _inputs(14, (1, 2, 32, 64), (1, 2, 32, 64))
    (qj, kj, vj), (q, k, v) = _both(arrs, "float32")
    _close(flash_attention(q, k, v, causal=True, scale=0.3),
           flash_attn_ref(qj, kj, vj, causal=True, scale=0.3), "float32")


@pytest.mark.parametrize("sq,sk,causal,window", [
    (5, 5, True, None), (3, 9, True, 4), (9, 3, True, None),
    (6, 6, False, 2), (1, 7, True, 3)])
def test_attention_mask_matches_jax(sq, sk, causal, window):
    np.testing.assert_array_equal(
        attention_mask(sq, sk, causal=causal, window=window).numpy(),
        np.asarray(jax_mask(sq, sk, causal=causal, window=window)))


def test_dispatch_by_device():
    """A CPU tensor runs the plain version; the CUDA wrapper refuses it
    (there is no fallback), and an unknown device raises."""
    q = torch.zeros((1, 1, 4, 64))
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attn_cuda(q, q, q)
    meta = q.to("meta")
    with pytest.raises(ValueError, match="no implementation"):
        flash_attention(meta, meta, meta)
