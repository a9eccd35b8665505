"""Binding of the Hopper flash-attention kernel (``csrc/flash_attn.cu``).

The kernel replaces ``repro/kernels/flash_attn/kernel.py::
flash_attn_pallas``; the source's header note gives its design and bound.
Two bodies, chosen by dtype: fp32 on the CUDA cores, bf16 on the tensor
cores, both fed by TMA, which needs the layout rule of
:func:`tma_layout_problem`.
``launches`` counts the calls of :func:`flash_attn_cuda` that launched the
kernel.  The kernel has no backward: it serves the prefill path, and the
training forward keeps the plain ``attend`` with autograd.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch
from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels._build import check, load_library

launches = 0
HEAD_DIMS = (64, 96, 128, 256)      # the attention head dims of the configs
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_GRID_LIMIT = 65535                 # gridDim.y (heads) and gridDim.z (batch)
_TMA_ALIGN = 16                     # bytes: TMA's base and stride granule
_TMA_STRIDE_LIMIT = 2 ** 40         # bytes: largest stride a tensor map takes
_lib = None


def tma_layout_problem(name: str, data_ptr: int, shape, strides,
                       itemsize: int = 2) -> str | None:
    """Why TMA cannot read tensor ``name`` in place, or None if it can.

    Both bodies load q, k and v through TMA tensor maps, which need a base
    address on a 16-byte boundary and every stride but the unit one (along
    d, the last dimension) a multiple of 16 bytes, below 2^40 bytes: a
    multiple of 8 elements for bf16 (``itemsize`` 2), of 4 for fp32
    (``itemsize`` 4).  The stride of a dimension of size 1 is never read,
    so it may be anything.  ``strides`` are in elements.
    """
    if data_ptr % _TMA_ALIGN:
        return (f"{name} starts at byte address {data_ptr}, not a multiple "
                f"of {_TMA_ALIGN}")
    for dim, (size, stride) in enumerate(zip(shape[:-1], strides[:-1])):
        nbytes = stride * itemsize
        if size > 1 and (nbytes % _TMA_ALIGN or nbytes >= _TMA_STRIDE_LIMIT):
            return (f"{name} has a stride of {stride} elements ({nbytes} "
                    f"bytes) along dim {dim}, not a multiple of {_TMA_ALIGN} "
                    f"bytes below 2^40")
    return None


def _library():
    global _lib
    if _lib is None:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _lib = load_library("flash_attn", {"flash_attn_launch": (
            [vp, vp, vp, vp, i32, i32, i32, i32, i32, i32, i32,
             *[i64] * 12, ctypes.c_float, i32, i32, i32, vp], ctypes.c_int)})
    return _lib


def flash_attn_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    scale: float | None = None) -> torch.Tensor:
    """Softmax attention on the card; (b, H, sq, d) in q's dtype.

    q: CUDA (b, H, sq, d); k, v: (b, KV, sk, d) with ``H % KV == 0``; one
    dtype, fp32 or bf16; unit stride along d (other strides are free, so
    transposed views need no copy); d in ``HEAD_DIMS``.  Inputs must also
    meet TMA's rule: base on a 16-byte boundary, every other stride a
    multiple of 16 bytes, 8 bf16 or 4 fp32 elements
    (:func:`tma_layout_problem`); a view that does not raises
    ``ValueError`` naming the tensor -- it is never copied.  ``window``
    >= 1 or None.  Raises if an input requires grad: there is no
    backward.  Launches on the current stream and does not synchronise.
    """
    if not (q.device.type == "cuda" and k.device == q.device
            and v.device == q.device):
        raise ValueError(f"flash_attn_cuda: q, k, v must be on one CUDA "
                         f"device, got {q.device}, {k.device}, {v.device}")
    if q.requires_grad or k.requires_grad or v.requires_grad:
        raise ValueError("flash_attn_cuda has no backward: call it on "
                         "tensors that do not require grad (the training "
                         "forward uses models.attention.attend)")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attn_cuda: q must be (b, H, sq, d) and k, v "
                         f"(b, KV, sk, d), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, H, sq, d = q.shape
    KV, sk = k.shape[1], k.shape[2]
    if k.shape[0] != b or k.shape[3] != d or KV < 1 or H % KV:
        raise ValueError(f"flash_attn_cuda: k/v {tuple(k.shape)} do not fit "
                         f"q {tuple(q.shape)} (same b and d, H % KV == 0)")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attn_cuda: head dim {d} not supported; "
                         f"have {HEAD_DIMS}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"flash_attn_cuda: q, k, v must share one dtype, "
                         f"float32 or bfloat16, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.stride(3) != 1 or k.stride(3) != 1 or v.stride(3) != 1:
        raise ValueError("flash_attn_cuda: q, k, v need unit stride along d")
    if window is not None and window < 1:
        raise ValueError(f"flash_attn_cuda: window must be >= 1, got "
                         f"{window}")
    if b > _GRID_LIMIT or H > _GRID_LIMIT or sq >= 2 ** 31 or sk >= 2 ** 31:
        raise ValueError(f"flash_attn_cuda: shape {tuple(q.shape)} / "
                         f"{tuple(k.shape)} exceeds the launch grid")
    scale = scale if scale is not None else d ** -0.5
    return flash_attn_op(q, k, v, bool(causal), window, float(scale))


@torch.library.custom_op("repro_torch::flash_attn", mutates_args=(),
                         device_types="cuda")
def flash_attn_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool, window: Optional[int],
                  scale: float) -> torch.Tensor:
    """The launch (the checks are :func:`flash_attn_cuda`'s, but the TMA
    rule, which reads the data pointers)."""
    global launches
    b, H, sq, d = q.shape
    KV, sk = k.shape[1], k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        problem = tma_layout_problem(name, t.data_ptr(), t.shape, t.stride(),
                                     t.element_size())
        if problem:
            raise ValueError(f"flash_attn_cuda: {problem} (the kernel reads "
                             f"it in place through TMA)")
    out = torch.empty((b, H, sq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    # A window wider than every row's history masks nothing; clamping it
    # keeps the kernel's int arithmetic in range without changing the mask.
    win = 0 if window is None else min(window, sk + 1)
    strides = [s for t in (q, k, v, out) for s in t.stride()[:3]]
    with torch.cuda.device(q.device):
        status = _library().flash_attn_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPES[q.dtype], d, b, H, H // KV, sq, sk, *strides,
            float(scale), int(causal), int(window is not None), win,
            torch.cuda.current_stream(q.device).cuda_stream)
    check(status, "flash_attn")
    launches += 1
    return out


@flash_attn_op.register_fake
def _flash_attn_fake(q, k, v, causal, window, scale):
    return q.new_empty(q.shape)


def band_pairs(sq: int, sk: int, causal: bool, window: int | None) -> int:
    """(query, key) pairs inside the band of
    ``ref.attention_mask(sq, sk, causal=, window=)``: query i at position
    ``i + sk - sq`` sees the keys ``j <= pos`` (causal) with ``pos - j <
    window``."""
    pos = np.arange(sq, dtype=np.int64) + (sk - sq)
    hi = np.minimum(pos, sk - 1) if causal else np.full(sq, sk - 1)
    lo = np.maximum(pos - window + 1, 0) if window is not None else 0
    return int(np.clip(hi - lo + 1, 0, None).sum())


@register_flop_formula(torch.ops.repro_torch.flash_attn)
def _flash_attn_flops(q_shape, k_shape, v_shape, causal, window, scale, *,
                      out_shape=None, **kw) -> int:
    b, H, sq, d = q_shape
    return 4 * d * b * H * band_pairs(sq, k_shape[2], causal, window)
