"""Device selection and numerics settings for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(name: str = "cuda") -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for ``cpu``.  Raises when a CUDA device is asked for and there is none;
    it never carries on quietly on the CPU.  On CUDA it also turns TF32 and
    cuBLAS's reduced-precision reductions off, so fp32 stays fp32 and
    bf16 products accumulate in fp32."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass --device cpu (or "
                "device='cpu') to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = \
            False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}: use cuda or cpu")
    return dev
