"""The bf16 flash-attention body's numerics, replayed on the CPU.

``csrc/flash_attn.cu``'s bf16 body (``flash_fwd_tc``) forms S = Q K^T from
bf16 operands into fp32, runs an online softmax over key tiles in fp32
(base 2: the scale times log2 e is applied to the scores), splits the
probabilities P into two bf16 values, P_hi = bf16(P) and P_lo =
bf16(P - P_hi), accumulates O += P_hi V + P_lo V in fp32, divides by the
fp32 row sum and rounds the output to bf16 once.  ``_emulate`` replays
those roundings in plain torch, key tile by key tile as the kernel walks
them, and the tests hold the result against ``flash_attn_plain`` in fp32
under ``chip_smoke.py``'s own limit, ``FLASH_ATOL + FLASH_RTOL["bfloat16"]
|want|``: the output's one rounding (2^-8 relative) and fp32 sums taken
in another order.

Rounding P once to bf16, as bf16 attention usually does (one tensor-core
product), exceeds that limit by several times on the sweep's shapes:
short causal rows whose few terms nearly cancel lose ~2^-9 of each term.
``test_rounding_p_once_exceeds_the_limit`` shows it on the same inputs;
that is why the kernel splits P.

The bf16 body reads q, k and v through TMA, whose layout rule
(``kernel.tma_layout_problem``) is pure Python and is tested here too, as
are the source patches of ``launch/flash_probe.py``.  Inputs are numpy
normals from each case's own seed.
"""

from __future__ import annotations

import importlib.util
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels._build import CSRC
from repro_torch.kernels.flash_attn.kernel import tma_layout_problem
from repro_torch.kernels.flash_attn.ref import (NEG, attention_mask,
                                                flash_attn_plain)
from repro_torch.launch import flash_probe

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)
ATOL = chip_smoke.FLASH_ATOL
RTOL = chip_smoke.FLASH_RTOL["bfloat16"]

SEQ = ((256, 256), (100, 100), (37, 1000), (300, 77), (1, 4096))
MASKS = ((True, None), (False, None), (True, 16))
LOG2E = 1.4426950408889634


def _qkv(seed, sq, sk, d, heads=2, kv=1):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, h, n, d))
                                .astype(np.float32)).to(torch.bfloat16)
               for h, n in ((heads, sq), (kv, sk), (kv, sk)))
    return q, k, v


def _emulate(q, k, v, *, causal, window, split_p=True):
    """The bf16 body's arithmetic in torch: key tiles of 64 (32 at d = 256),
    running max / sum / accumulator in fp32, P split (or rounded once)."""
    b, H, sq, d = q.shape
    KV, sk = k.shape[1], k.shape[2]
    bk = 64 if d <= 128 else 32
    kf = k.float().repeat_interleave(H // KV, dim=1)
    vf = v.float().repeat_interleave(H // KV, dim=1)
    c = d ** -0.5 * LOG2E
    mask = attention_mask(sq, sk, causal=causal, window=window)
    m = torch.full((b, H, sq, 1), NEG)
    l = torch.zeros((b, H, sq, 1))
    o = torch.zeros((b, H, sq, d))
    for k0 in range(0, sk, bk):
        keep = mask[:, k0:k0 + bk]
        s = q.float() @ kf[:, :, k0:k0 + bk].transpose(-1, -2)
        x = torch.where(keep, s * c, torch.full_like(s, NEG))
        m_cur = torch.maximum(m, x.amax(dim=-1, keepdim=True))
        alpha = torch.exp2(m - m_cur)
        p = torch.exp2(x - m_cur) * keep
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        p_hi = p.to(torch.bfloat16).float()
        vt = vf[:, :, k0:k0 + bk]
        o = o * alpha + p_hi @ vt
        if split_p:
            o = o + (p - p_hi).to(torch.bfloat16).float() @ vt
        m = m_cur
    o = torch.where(l > 0, o / torch.clamp(l, min=1e-30), torch.zeros_like(o))
    return o.to(torch.bfloat16)


def _share_of_limit(o, q, k, v, **kw):
    want = flash_attn_plain(q.float(), k.float(), v.float(), **kw)
    return float(((o.float() - want).abs() / (ATOL + RTOL * want.abs()))
                 .max())


@pytest.mark.parametrize("d", [64, 256])
@pytest.mark.parametrize("causal,window", MASKS)
@pytest.mark.parametrize("sq,sk", SEQ)
def test_split_p_stays_within_the_limit(sq, sk, causal, window, d):
    q, k, v = _qkv(7 * sq + sk + d, sq, sk, d)
    o = _emulate(q, k, v, causal=causal, window=window)
    assert o.shape == q.shape and bool(torch.isfinite(o.float()).all())
    assert _share_of_limit(o, q, k, v, causal=causal, window=window) <= 1
    if causal and sq > sk:              # rows that see no key are exactly 0
        assert bool((o[:, :, :sq - sk] == 0).all())


@pytest.mark.parametrize("d", [64, 256])
def test_rounding_p_once_exceeds_the_limit(d):
    """The same inputs with P rounded once to bf16: over the sweep's
    causal shapes the worst case exceeds the limit (several times on the
    square and ragged ones), while the split keeps every case within it."""
    once, split = [], []
    for sq, sk in SEQ:
        q, k, v = _qkv(7 * sq + sk + d, sq, sk, d)
        for split_p, out in ((False, once), (True, split)):
            o = _emulate(q, k, v, causal=True, window=None, split_p=split_p)
            out.append(_share_of_limit(o, q, k, v, causal=True))
    assert max(once) > 2, once
    assert max(split) <= 1, split


def _view(t: torch.Tensor, base: int = 4096):
    """(data_ptr, shape, strides, itemsize) of a CPU view as if its
    storage started at byte address ``base`` (a TMA-aligned allocation)."""
    ptr = base + t.storage_offset() * t.element_size()
    return ptr, tuple(t.shape), t.stride(), t.element_size()


def _accepted_layouts():
    bf = torch.bfloat16
    B, S, H, KV, hd = 2, 16, 15, 5, 64
    # the prefill projections: (B, S, n * hd) reshaped and transposed
    q = torch.zeros((B, S, H * hd), dtype=bf).reshape(B, S, H, hd)
    v = torch.zeros((B, S, KV * hd), dtype=bf).reshape(B, S, KV, hd)
    # test_flash_kernel_reads_strided_views: head slices of one buffer
    x = torch.zeros((2, 70, 10, 64), dtype=bf)
    # a dimension of size 1 whose stride TMA never reads
    one = torch.zeros((1, 3, 5, 64), dtype=bf).as_strided(
        (1, 3, 5, 64), (7, 320, 64, 1))
    return {"contiguous": torch.zeros((2, 3, 100, 96), dtype=bf),
            "q_transposed_960": q.transpose(1, 2),
            "v_transposed_320": v.transpose(1, 2),
            "head_slice": x[:, :, 6:8].transpose(1, 2),
            "size_one_dim": one}


@pytest.mark.parametrize("name", sorted(_accepted_layouts()))
def test_tma_rule_accepts_the_callers_layouts(name):
    t = _accepted_layouts()[name]
    assert tma_layout_problem(name, *_view(t)) is None


@pytest.mark.parametrize("case", ["odd_offset", "odd_row_stride",
                                  "row_stride_of_4_elements",
                                  "misaligned_base"])
def test_tma_rule_refuses_misaligned_views(case):
    bf = torch.bfloat16
    if case == "odd_offset":
        t = torch.zeros(2 * 4 * 64 + 1, dtype=bf)[1:].view(1, 2, 4, 64)
        args = _view(t)
    elif case == "odd_row_stride":
        t = torch.zeros((1, 2, 4, 65), dtype=bf)[..., :64]
        args = _view(t)
    elif case == "row_stride_of_4_elements":
        t = torch.zeros((1, 2, 4, 68), dtype=bf)[..., :64]
        args = _view(t)
    else:
        t = torch.zeros((1, 2, 4, 64), dtype=bf)
        args = _view(t, base=4096 + 8)
    problem = tma_layout_problem("k", *args)
    assert problem is not None and problem.startswith("k ")


@pytest.mark.parametrize("name", sorted(flash_probe.PATCHES))
def test_flash_probe_patches_match_the_source(name):
    """``launch/flash_probe.py`` builds its variants by patching the shipped
    source: every patch must still find its text exactly once."""
    source = (CSRC / "flash_attn.cu").read_text()
    out = flash_probe.patched(name, source)
    assert (out == source) == (name == "shipped")
    assert "flash_fwd_tc" in out and "flash_attn_launch" in out
