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

from repro_torch.dist.aggregation import (AggregatorConfig, aggregate_tree,
                                          tree_gram)
from repro_torch.kernels.activations import kernel as act_kernel
from repro_torch.kernels.activations import ops as act_ops
from repro_torch.kernels.activations.ref import PLAIN as ACT_PLAIN
from repro_torch.kernels.activations.ref import gated_plain
from repro_torch.kernels.coord_stats import kernel as cs_kernel
from repro_torch.kernels.coord_stats.ref import (COORD_OPS,
                                                 bulyan_select_plain,
                                                 coord_stat_plain,
                                                 krum_scores_plain)
from repro_torch.kernels.flash_attn import kernel as flash_kernel
from repro_torch.kernels.flash_attn.ref import flash_attn_plain
from repro_torch.kernels.gram import kernel as gram_kernel
from repro_torch.kernels.gram.ops import tree_gram_fused
from repro_torch.kernels.gram.ref import gram_plain, tree_gram_plain
from repro_torch.kernels.weighted_sum import kernel as wsum_kernel
from repro_torch.kernels.weighted_sum.ops import weighted_sum
from repro_torch.kernels.weighted_sum.ref import weighted_sum_plain

pytestmark = pytest.mark.gpu

# Tolerances: both sides sum fp32 products, in different orders.
GRAM_TOL = 2e-5        # of sqrt(K_ii K_jj)
WSUM_TOL = 1e-5        # of sum_w |c_w x_w|
BF16_ULP = 2.0 ** -7   # one bf16 ulp (relative): the fp32 sums may
                       # straddle a rounding boundary
# flash attention against the plain version in fp32 on the same inputs:
# fp32 sums in another order (rtol = atol = 2e-4, the JAX kernel tests',
# tests/test_kernels.py:157-159), plus for bf16 the kernel's one rounding
# of its output to bf16 (at most 2^-8 relative)
FLASH_ATOL = 2e-4
FLASH_RTOL = {torch.float32: 2e-4, torch.bfloat16: 2e-4 + 2.0 ** -8}


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


# ---------------------------------------------------------------------------
# coordinate statistics and selections
# ---------------------------------------------------------------------------

# The kernel and the plain version sort alike and sum in the same order
# (ascending, sequential fp32, one division), so the median is held
# bit-equal and the means to fp32 summation noise (rtol/atol 1e-6).


def _coord_data(seed, W, n, ties, device):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    if ties:
        X = torch.randint(-3, 4, (W, n), generator=g).float()
        X[W // 2] = X[0]
    else:
        X = torch.randn((W, n), generator=g)
    return X.to(device)


def _mask_for(kind, W, device):
    m = torch.zeros(W)
    if kind == "one":
        m[W // 2] = 1.0
    elif kind == "random":
        m[torch.randperm(W, generator=torch.Generator().manual_seed(W))
          [: max(1, W // 2 + 1)]] = 1.0
    return None if kind == "none" else m.to(device)


@pytest.mark.parametrize("op", COORD_OPS)
@pytest.mark.parametrize("W", [1, 2, 3, 8, 9, 15, 16, 17, 64, 128])
@pytest.mark.parametrize("mkind", ["none", "all_inactive", "one", "random"])
@pytest.mark.parametrize("ties", [False, True])
def test_coord_stats_kernel_matches_plain(cuda, op, W, mkind, ties):
    X = _coord_data(W, W, 10_007, ties, cuda)
    m = _mask_for(mkind, W, cuda)
    f = 1 if W < 8 else 3
    before = cs_kernel.launches["coord_stats"]
    got = cs_kernel.coord_stats_cuda(X, op, f, mask=m)
    torch.cuda.synchronize()
    assert cs_kernel.launches["coord_stats"] == before + 1
    want = coord_stat_plain(X, op, f, mask=m)
    if op == "median":
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", COORD_OPS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_coord_stats_kernel_rows_views_and_dtypes(cuda, op, dtype):
    X = _coord_data(3, 20, 70_001, False, cuda).to(dtype)
    view = X[2:19, 5:60_005]                 # strided rows, unaligned start
    rows = torch.tensor([9, 0, 16, 4, 11, 3, 7], dtype=torch.int32,
                        device=cuda)
    for kw in ({}, {"rows": rows},
               {"rows": rows, "mask": _mask_for("random", 7, cuda)}):
        got = cs_kernel.coord_stats_cuda(view, op, 20, **kw)
        want = coord_stat_plain(view, op, 20, **kw)
        if op == "median":
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


def _d2_cuda(seed, W, dup, device):
    g = torch.Generator().manual_seed(seed)
    P = torch.randn((W, 6), generator=g)
    P[:dup] = 0.0
    D = ((P[:, None, :] - P[None, :, :]) ** 2).sum(-1)
    D.fill_diagonal_(0.0)
    return D.to(device)


@pytest.mark.parametrize("W", [1, 2, 3, 4, 8, 15, 16, 17, 31, 32, 33, 64])
@pytest.mark.parametrize("f", [0, 1, 3])
@pytest.mark.parametrize("dup", [0, 3])
def test_selection_kernels_match_plain(cuda, W, f, dup):
    D = _d2_cuda(W + 10 * f, W, min(dup, W), cuda)
    k0 = cs_kernel.launches["krum_scores"]
    b0 = cs_kernel.launches["bulyan_select"]
    s = cs_kernel.krum_scores_cuda(D, f)
    picks = cs_kernel.bulyan_select_cuda(D, f)
    torch.cuda.synchronize()
    assert (cs_kernel.launches["krum_scores"],
            cs_kernel.launches["bulyan_select"]) == (k0 + 1, b0 + 1)
    torch.testing.assert_close(s, krum_scores_plain(D, f), rtol=1e-6,
                               atol=0.0)
    assert torch.equal(picks, bulyan_select_plain(D, f))


def test_coord_and_selection_wrappers_refuse(cuda):
    X = torch.zeros((3, 64), device=cuda)
    with pytest.raises(ValueError, match="at most 128"):
        cs_kernel.coord_stats_cuda(torch.zeros((129, 8), device=cuda),
                                   "median")
    with pytest.raises(ValueError):
        cs_kernel.coord_stats_cuda(X, "median", mask=torch.ones(4,
                                                                device=cuda))
    with pytest.raises(ValueError):
        cs_kernel.coord_stats_cuda(X, "median",
                                   rows=torch.zeros(2, dtype=torch.int64,
                                                    device=cuda))
    with pytest.raises(ValueError):
        cs_kernel.krum_scores_cuda(torch.zeros((3, 4), device=cuda))


@pytest.mark.parametrize("name", ["krum", "multi_krum", "median",
                                  "trimmed_mean", "meamed", "phocas",
                                  "bulyan"])
@pytest.mark.parametrize("masked", [False, True])
def test_baseline_rules_cuda_match_cpu(cuda, name, masked):
    X, _ = _data(12, 15, 200_001, torch.float32, "cpu")
    X[:3] *= -10.0
    mask = (torch.tensor([1.0] * 12 + [0.0] * 3)[torch.randperm(
        15, generator=torch.Generator().manual_seed(1))] if masked else None)
    cfg = AggregatorConfig(name=name, f=3)
    d, aux = aggregate_tree(X.to(cuda), cfg,
                            mask=None if mask is None else mask.to(cuda))
    d_cpu, aux_cpu = aggregate_tree(X, cfg, mask=mask)
    torch.testing.assert_close(aux["weights"].cpu(), aux_cpu["weights"],
                               rtol=5e-3, atol=5e-4)
    scale = d_cpu.abs().max()
    torch.testing.assert_close(d.cpu() / scale, d_cpu / scale, rtol=5e-3,
                               atol=5e-4)


def _qkv(seed, b, H, KV, sq, sk, d, dtype, device):
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    q = torch.randn((b, H, sq, d), generator=g, device=device)
    k = torch.randn((b, KV, sk, d), generator=g, device=device)
    v = torch.randn((b, KV, sk, d), generator=g, device=device)
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _flash_close(o, q, k, v, **kw):
    want = flash_attn_plain(q.float(), k.float(), v.float(), **kw)
    assert o.dtype == q.dtype and o.shape == q.shape
    assert torch.isfinite(o.float()).all()
    torch.testing.assert_close(o.float(), want, rtol=FLASH_RTOL[q.dtype],
                               atol=FLASH_ATOL)


@pytest.mark.parametrize("sq,sk", [(128, 128), (1, 300), (100, 100),
                                   (37, 256), (77, 40), (200, 333)])
@pytest.mark.parametrize("d", [64, 96, 128, 256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_matches_plain(cuda, sq, sk, d, dtype):
    q, k, v = _qkv(sq + sk + d, 2, 6, 2, sq, sk, d, dtype, cuda)
    before = flash_kernel.launches
    o = flash_kernel.flash_attn_cuda(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_kernel.launches == before + 1
    _flash_close(o, q, k, v, causal=True)


@pytest.mark.parametrize("window", [None, 1, 16, 64])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("heads,kv", [(3, 3), (6, 2), (8, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_masks_and_groups(cuda, window, causal, heads, kv,
                                       dtype):
    q, k, v = _qkv(heads + kv, 2, heads, kv, 150, 190, 64, dtype, cuda)
    o = flash_kernel.flash_attn_cuda(q, k, v, causal=causal, window=window)
    _flash_close(o, q, k, v, causal=causal, window=window)


def test_flash_kernel_fully_masked_rows_are_zero(cuda):
    """sq > sk under causal masking: the first sq - sk rows see no key."""
    q, k, v = _qkv(3, 1, 2, 2, 90, 20, 64, torch.float32, cuda)
    o = flash_kernel.flash_attn_cuda(q, k, v, causal=True)
    assert (o[:, :, :70] == 0).all()
    _flash_close(o, q, k, v, causal=True)


def test_flash_kernel_reads_strided_views(cuda):
    """(B, S, H, d) projections transposed to (B, H, S, d) need no copy."""
    g = torch.Generator(device=cuda)
    g.manual_seed(4)
    x = torch.randn((2, 70, 10, 64), generator=g, device=cuda)
    q, k, v = x[:, :, :6].transpose(1, 2), x[:, :, 6:8].transpose(1, 2), \
        x[:, :, 8:].transpose(1, 2)
    o = flash_kernel.flash_attn_cuda(q, k, v, causal=True, scale=0.2)
    _flash_close(o, q, k, v, causal=True, scale=0.2)


@pytest.mark.parametrize("d", [64, 96])
def test_flash_kernel_reads_strided_bf16_views(cuda, d):
    """The bf16 body's TMA reads the prefill layouts in place: (B, S, H, d)
    projections transposed, and head slices offset by multiples of d."""
    g = torch.Generator(device=cuda)
    g.manual_seed(d)
    x = torch.randn((2, 70, 10, d), generator=g, device=cuda).bfloat16()
    q, k, v = x[:, :, :6].transpose(1, 2), x[:, :, 6:8].transpose(1, 2), \
        x[:, :, 8:].transpose(1, 2)
    o = flash_kernel.flash_attn_cuda(q, k, v, causal=True, scale=0.2)
    _flash_close(o, q, k, v, causal=True, scale=0.2)


def test_flash_kernel_refuses_misaligned_bf16_views(cuda):
    """TMA needs a 16-byte base and 16-byte strides: a bf16 view off by one
    element, or with a row of 65 elements, raises and launches nothing."""
    q, k, v = _qkv(6, 1, 2, 2, 8, 8, 64, torch.bfloat16, cuda)
    flat = torch.zeros(q.numel() + 1, dtype=torch.bfloat16, device=cuda)
    shifted = flat[1:].view(q.shape)
    wide = torch.zeros((1, 2, 8, 65), dtype=torch.bfloat16,
                       device=cuda)[..., :64]
    before = flash_kernel.launches
    for bad, args in [("q", (shifted, k, v)), ("k", (q, wide, v)),
                      ("v", (q, k, wide))]:
        with pytest.raises(ValueError, match=f"{bad} "):
            flash_kernel.flash_attn_cuda(*args)
    assert flash_kernel.launches == before


@pytest.mark.parametrize("d", [96, 256])
@pytest.mark.parametrize("window", [7, 40])
def test_flash_kernel_fp32_window_and_more_queries_than_keys(cuda, d,
                                                             window):
    """The fp32 body at d = 96 (4 warps of 32 rows, 32-key tiles) and 256
    (4 warps of 16 rows, 32-key tiles in two boxes) under a sliding window
    with sq > sk: its first sq - sk rows see no key and are 0.  The limit
    is FLASH_ATOL / FLASH_RTOL's fp32 one (sums in another order)."""
    q, k, v = _qkv(d + window, 2, 6, 2, 150, 90, d, torch.float32, cuda)
    before = flash_kernel.launches
    o = flash_kernel.flash_attn_cuda(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_kernel.launches == before + 1
    assert (o[:, :, :60] == 0).all()
    _flash_close(o, q, k, v, causal=True, window=window)


def test_flash_kernel_refuses_misaligned_fp32_views(cuda):
    """The fp32 body reads through TMA too: a view off by one element, or
    with a row of 66 elements (264 bytes), raises and launches nothing."""
    q, k, v = _qkv(8, 1, 2, 2, 8, 8, 64, torch.float32, cuda)
    flat = torch.zeros(q.numel() + 1, device=cuda)
    shifted = flat[1:].view(q.shape)
    wide = torch.zeros((1, 2, 8, 66), device=cuda)[..., :64]
    before = flash_kernel.launches
    for bad, args in [("q", (shifted, k, v)), ("k", (q, wide, v)),
                      ("v", (q, k, wide))]:
        with pytest.raises(ValueError, match=f"{bad} "):
            flash_kernel.flash_attn_cuda(*args)
    assert flash_kernel.launches == before


def test_flash_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    q, k, v = _qkv(5, 1, 4, 2, 8, 8, 64, torch.float32, cuda)
    for bad in [dict(q=q[..., :32], k=k[..., :32], v=v[..., :32]),   # d=32
                dict(q=q.half(), k=k.half(), v=v.half()),
                dict(q=q, k=k[:, :1].expand(1, 3, 8, 64).contiguous(),
                     v=v[:, :1].expand(1, 3, 8, 64).contiguous())]:  # 4 % 3
        with pytest.raises(ValueError):
            flash_kernel.flash_attn_cuda(bad["q"], bad["k"], bad["v"])
    with pytest.raises(ValueError, match="no backward"):
        flash_kernel.flash_attn_cuda(q.requires_grad_(), k, v)
    with pytest.raises(ValueError, match="window"):
        flash_kernel.flash_attn_cuda(q.detach(), k, v, window=0)


@pytest.mark.parametrize("p", [1, 2, 7, 15, 16, 33, 40])
@pytest.mark.parametrize("n", [1, 1000, 100_003])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gram_kernel_matches_plain(cuda, p, n, dtype):
    G, _ = _data(p * n, n, p, dtype, cuda)
    before = gram_kernel.gram_launches
    K = gram_kernel.gram_cuda(G)
    K2 = gram_kernel.gram_cuda(G)
    torch.cuda.synchronize()
    assert gram_kernel.gram_launches == before + 2
    assert K.dtype == torch.float32 and K.shape == (p, p)
    assert torch.equal(K, K2) and torch.equal(K, K.T)
    _gram_close(K, gram_plain(G))


@pytest.mark.parametrize("stride", [1, 2, 7])
def test_gram_kernel_reads_leaf_views_in_place(cuda, stride):
    """The looped tree Gram's operand: a leaf of the (W, N) buffer,
    column-sketched and transposed, strides (stride, N)."""
    X, _ = _data(7 + stride, 15, 300_001, torch.float32, cuda)
    G = X[:, 1_001:250_001:stride].T
    _gram_close(gram_kernel.gram_cuda(G), gram_plain(G))
    _gram_close(gram_kernel.gram_cuda(G, round_bf16=True),
                gram_plain(G.to(torch.bfloat16)))


@pytest.mark.parametrize("stride", [1, 2, 7])
@pytest.mark.parametrize("gram_dtype", ["float32", "bfloat16"])
def test_looped_tree_gram_cuda_matches_cpu(cuda, stride, gram_dtype):
    sizes = [40_000, 5, 1, 123_457, 3]
    X, _ = _data(stride, 9, sum(sizes), torch.float32, "cpu")
    before = gram_kernel.gram_launches
    K = tree_gram(X.to(cuda), stride, gram_dtype=gram_dtype, fused=False,
                  leaf_sizes=sizes)
    assert gram_kernel.gram_launches == before + len(sizes)
    _gram_close(K.cpu(), tree_gram(X, stride, gram_dtype=gram_dtype,
                                   fused=False, leaf_sizes=sizes))


@pytest.mark.parametrize("rule", ["flag", "krum", "bulyan"])
def test_byzantine_loop_card_matches_cpu(cuda, rule):
    """The CNN loop (launch/byzantine.py) on the card and on the CPU from
    the same weights and draws: equal accuracy trajectories within 2 of
    the 1,024 test images, parameters within 1 % of the largest change
    (chip_smoke.py's ``byzantine_check`` states the tolerances), and no
    kernel of the port launched."""
    from repro_torch.launch.byzantine import (ByzRunConfig,
                                              run_byzantine_training)
    cfg = ByzRunConfig(p=7, f=1, batch=8, steps=3, eval_every=1,
                       attack="sign_flip", aggregator=rule)
    thetas = {}
    before = dict(cs_kernel.launches)
    outs = {}
    for dev in (cuda, "cpu"):
        def hook(t, G, d, theta, dev=dev):
            thetas[str(dev), t] = theta.cpu().clone()
        outs[str(dev)] = run_byzantine_training(cfg, device=dev,
                                                on_step=hook)
    assert cs_kernel.launches == before
    g, c = outs[str(cuda)], outs["cpu"]
    for (sa, a), (sb, b) in zip(g["trajectory"], c["trajectory"]):
        assert sa == sb and abs(a - b) <= 2 / 1024
    from repro_torch.models.cnn import cnn_init
    from repro_torch.weights import pack
    theta0, _ = pack(cnn_init(torch.Generator().manual_seed(cfg.seed)))
    change = float((thetas["cpu", 2] - theta0).abs().max())
    for t in range(3):
        err = float((thetas[str(cuda), t] - thetas["cpu", t]).abs().max())
        assert err <= 0.01 * max(change, 1e-12), (t, err, change)


def _act_inputs(dtype, device):
    """Every bf16 bit pattern, or a seeded fp32 sample of 2^20 values with
    the specials; a seeded second factor and cotangent alike."""
    g = torch.Generator(device=device).manual_seed(11)
    if dtype == torch.bfloat16:
        x = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(
            torch.int16).view(torch.bfloat16).to(device)
    else:
        x = torch.cat([torch.randn((1 << 20) - 7, generator=g,
                                   device=device) * 8,
                       torch.tensor([0.0, -0.0, float("inf"), -float("inf"),
                                     float("nan"), 1e-40, -95.0],
                                    device=device)])
    up, cot = (torch.randn(x.shape, generator=g, device=device).to(dtype)
               for _ in range(2))
    return x, up, cot


def _act_outputs(fwd, gated, x, up, cot):
    a, u, b = (t.clone().requires_grad_(True) for t in (x, up, x))
    y = fwd(a)
    y.backward(cot)
    yg = gated(u, b)
    yg.backward(cot)
    return {"forward": y.detach(), "backward": a.grad, "gated": yg.detach(),
            "gated_d_up": u.grad, "gated_d_gate": b.grad}


@pytest.mark.parametrize("name", list(ACT_PLAIN))
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_activation_kernel_equals_composition(cuda, name, dtype):
    """The activation kernel against the eager composition on the card:
    every bf16 bit pattern (or 2^20 fp32 values), forward, backward with a
    seeded cotangent, and the gated form with both cotangents; no value
    differs (NaN equal to NaN)."""
    x, up, cot = _act_inputs(dtype, cuda)
    before = dict(act_kernel.launches)
    got = _act_outputs(lambda a: act_ops.act(name, a),
                       lambda u, b: act_ops.gated(name, u, b), x, up, cot)
    want = _act_outputs(ACT_PLAIN[name],
                        lambda u, b: gated_plain(name, u, b), x, up, cot)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    for k in got:
        differ = (got[k].view(bits) != want[k].view(bits)) & ~(
            got[k].isnan() & want[k].isnan())
        assert int(differ.sum()) == 0, (k, x[differ][:8].tolist())
    assert {k: act_kernel.launches[k] - before[k] for k in before} == {
        "act": 1, "act_gated": 1, "act_grad": 1, "act_gated_grad": 1}


def test_activation_kernel_strided_views(cuda):
    """The sLSTM's ``g[:, k]`` rows and the RG-LRU's chunks read in place,
    a transposed view through a copy, a ragged unaligned slice through
    the per-value path: each equal to the composition."""
    g = torch.Generator(device=cuda).manual_seed(12)
    z = torch.randn((4, 4, 8, 64), generator=g, device=cuda).bfloat16()
    lo, hi = torch.randn((4, 33, 512), generator=g,
                         device=cuda).bfloat16().chunk(2, dim=-1)
    r = torch.randn(1001, generator=g, device=cuda)[1:]
    for got, want in (
            (act_ops.act("log_sigmoid", z[:, 2]),
             ACT_PLAIN["log_sigmoid"](z[:, 2])),
            (act_ops.gated("gelu", lo, hi), gated_plain("gelu", lo, hi)),
            (act_ops.act("tanh", z[0].transpose(0, 1)),
             ACT_PLAIN["tanh"](z[0].transpose(0, 1))),
            (act_ops.act("silu", r), ACT_PLAIN["silu"](r))):
        assert got.is_contiguous() and torch.equal(got, want.contiguous())

