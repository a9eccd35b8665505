"""Bindings of the Hopper coordinate-statistics and selection kernels.

``coord_stats_cuda`` binds ``csrc/coord_stats.cu`` (replaces
``repro/kernels/coord_stats/kernel.py::coord_stats_pallas``);
``krum_scores_cuda`` and ``bulyan_select_cuda`` bind ``csrc/krum_select.cu``
(replace ``krum_scores_pallas`` and ``bulyan_select_pallas``).  The
sources' header notes give the designs and bounds.  ``launches`` counts,
per kernel, the wrapper calls that launched it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels._build import check, load_library
from repro_torch.kernels.coord_stats.ref import COORD_OPS

launches = {"coord_stats": 0, "krum_scores": 0, "bulyan_select": 0}
MAX_WORKERS = 128        # coord_stats: padded network width in registers
MAX_SELECT_WORKERS = 1024  # krum / bulyan: one thread per worker, one block
_libs: dict = {}


def _library(name: str):
    if name not in _libs:
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        sigs = {
            "coord_stats": {"coord_stats_launch": (
                [vp, i32, i64, vp, i32, i64, i32, i32, vp, vp, i32, vp],
                ctypes.c_int)},
            "krum_select": {
                "krum_scores_launch": ([vp, i32, i32, vp, vp], ctypes.c_int),
                "bulyan_select_launch": ([vp, i32, i32, vp, vp],
                                         ctypes.c_int)},
        }[name]
        _libs[name] = load_library(name, sigs)
    return _libs[name]


def _stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def coord_stats_cuda(X: torch.Tensor, op: str, f: int = 1, *,
                     mask: torch.Tensor | None = None,
                     rows: torch.Tensor | None = None) -> torch.Tensor:
    """Coordinate-wise statistic on the card; (N,) fp32.

    X: CUDA (W, N) fp32 or bf16 with unit column stride (rows may be
    strided).  ``mask``: CUDA contiguous fp32 (R,), 0 = inactive.
    ``rows``: CUDA contiguous int32 (R,) indices into X's rows, read in that
    order as workers 0..R-1 (values must lie in [0, W); they stay on the
    card and are not checked).  R = W without ``rows``; R <= 128.
    Launches on the current stream and does not synchronise.
    """
    if X.device.type != "cuda":
        raise ValueError(f"coord_stats_cuda: X must be on a CUDA device, got "
                         f"{X.device}")
    if X.dim() != 2 or X.shape[0] < 1 or X.shape[1] < 1:
        raise ValueError(f"coord_stats_cuda: X must be (W, N) with W, N >= 1,"
                         f" got {tuple(X.shape)}")
    if X.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"coord_stats_cuda: X must be float32 or bfloat16, "
                         f"got {X.dtype}")
    if X.stride(1) != 1 or (X.shape[0] > 1 and X.stride(0) < X.shape[1]):
        raise ValueError("coord_stats_cuda: X needs unit column stride and "
                         f"non-overlapping rows, got strides {X.stride()}")
    if op not in COORD_OPS:
        raise ValueError(f"coord_stats_cuda: unknown op {op!r}; have "
                         f"{COORD_OPS}")
    if f < 0:
        raise ValueError(f"coord_stats_cuda: f must be >= 0, got {f}")
    R = X.shape[0]
    if rows is not None:
        if (rows.device != X.device or rows.dtype != torch.int32
                or rows.dim() != 1 or not rows.is_contiguous()
                or rows.numel() < 1):
            raise ValueError("coord_stats_cuda: rows must be a non-empty "
                             "contiguous int32 vector on X's device, got "
                             f"{rows.dtype} {tuple(rows.shape)} on "
                             f"{rows.device}")
        R = rows.numel()
    if R > MAX_WORKERS:
        raise ValueError(f"coord_stats_cuda: at most {MAX_WORKERS} workers "
                         f"(the kernel sorts a column in registers), got {R}")
    if mask is not None and (mask.device != X.device
                             or mask.dtype != torch.float32
                             or mask.shape != (R,)
                             or not mask.is_contiguous()):
        raise ValueError(f"coord_stats_cuda: mask must be contiguous float32 "
                         f"({R},) on X's device, got {mask.dtype} "
                         f"{tuple(mask.shape)} on {mask.device}")
    n = X.shape[1]
    out = torch.empty(n, dtype=torch.float32, device=X.device)
    sms = torch.cuda.get_device_properties(X.device).multi_processor_count
    with torch.cuda.device(X.device):
        status = _library("coord_stats").coord_stats_launch(
            X.data_ptr(), 0 if X.dtype == torch.float32 else 1, X.stride(0),
            None if rows is None else rows.data_ptr(), R, n,
            COORD_OPS.index(op), f,
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            64 * sms, _stream(X))
    check(status, "coord_stats")
    launches["coord_stats"] += 1
    return out


def _check_d2(D2: torch.Tensor, who: str) -> None:
    if D2.device.type != "cuda":
        raise ValueError(f"{who}: D2 must be on a CUDA device, got "
                         f"{D2.device}")
    if (D2.dim() != 2 or D2.shape[0] != D2.shape[1] or D2.shape[0] < 1
            or D2.dtype != torch.float32 or not D2.is_contiguous()):
        raise ValueError(f"{who}: D2 must be a contiguous float32 (W, W), "
                         f"got {D2.dtype} {tuple(D2.shape)}")
    if D2.shape[0] > MAX_SELECT_WORKERS:
        raise ValueError(f"{who}: at most {MAX_SELECT_WORKERS} workers (one "
                         f"thread each), got {D2.shape[0]}")


def krum_scores_cuda(D2: torch.Tensor, f: int = 1) -> torch.Tensor:
    """Krum scores on the card: (W, W) fp32 -> (W,) fp32."""
    _check_d2(D2, "krum_scores_cuda")
    if f < 0:
        raise ValueError(f"krum_scores_cuda: f must be >= 0, got {f}")
    w = D2.shape[0]
    out = torch.empty(w, dtype=torch.float32, device=D2.device)
    with torch.cuda.device(D2.device):
        status = _library("krum_select").krum_scores_launch(
            D2.data_ptr(), w, f, out.data_ptr(), _stream(D2))
    check(status, "krum_scores")
    launches["krum_scores"] += 1
    return out


def bulyan_select_cuda(D2: torch.Tensor, f: int = 1) -> torch.Tensor:
    """Bulyan's picks on the card: (W, W) fp32 -> (theta,) int32 in
    selection order, theta = max(W - 2f, 1)."""
    _check_d2(D2, "bulyan_select_cuda")
    if f < 0:
        raise ValueError(f"bulyan_select_cuda: f must be >= 0, got {f}")
    w = D2.shape[0]
    picks = torch.empty(max(w - 2 * f, 1), dtype=torch.int32,
                        device=D2.device)
    with torch.cuda.device(D2.device):
        status = _library("krum_select").bulyan_select_launch(
            D2.data_ptr(), w, f, picks.data_ptr(), _stream(D2))
    check(status, "bulyan_select")
    launches["bulyan_select"] += 1
    return picks
