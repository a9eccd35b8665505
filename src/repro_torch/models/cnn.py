"""The paper's small CNN (two 3x3 convolutions, two fully connected layers).

Port of ``cnn_init``, ``cnn_logits`` and ``cnn_loss`` of
``benchmarks/common.py``, the model of every accuracy figure.  The params
dict keeps the JAX package's layout and keys, so its flat vector (keys in
sorted order: ``b1, b2, b3, b4, c1, c2, f1, f2``) holds the same
coordinates in both packages:

  c1 (3, 3, ch, w) and c2 (3, 3, w, 2w): conv kernels in HWIO;
  f1 (8 * 8 * 2w, 64) and f2 (64, classes): fc weights (in, out);
  b1 .. b4: biases.

Images come in NHWC, as in JAX.  A convolution runs as ``F.conv2d`` on the
NCHW view with the kernel permuted to OIHW ("SAME" at 3x3 and stride 1 is
padding 1); the 2x2 / 2 "VALID" max pool is ``F.max_pool2d``.  Before
``f1`` the activations go back to NHWC, because f1's rows are ordered
(h, w, c) in JAX's flatten.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["cnn_init", "cnn_logits", "cnn_loss"]


def cnn_init(gen: torch.Generator, *, channels: int = 3,
             num_classes: int = 10, width: int = 8, device="cpu"):
    """Random weights: a normal truncated to [-2, 2] times fan^-1/2 from
    ``gen`` (cannot match ``jax.random``'s values), zero biases."""

    def init(shape, fan):
        t = torch.empty(shape, dtype=torch.float32)
        torch.nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
        return (t * fan ** -0.5).to(device)

    def zeros(n):
        return torch.zeros(n, dtype=torch.float32, device=device)
    return {
        "c1": init((3, 3, channels, width), 9 * channels),
        "c2": init((3, 3, width, 2 * width), 9 * width),
        "f1": init((8 * 8 * 2 * width, 64), 8 * 8 * 2 * width),
        "f2": init((64, num_classes), 64),
        "b1": zeros(width), "b2": zeros(2 * width),
        "b3": zeros(64), "b4": zeros(num_classes),
    }


def _conv_relu_pool(y: torch.Tensor, w: torch.Tensor,
                    b: torch.Tensor) -> torch.Tensor:
    """NCHW in, NCHW out: 3x3 "SAME" conv (HWIO kernel), bias, ReLU, 2x2
    max pool."""
    y = F.conv2d(y, w.permute(3, 2, 0, 1), padding=1)
    y = F.relu(y + b[None, :, None, None])
    return F.max_pool2d(y, 2)


def cnn_logits(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x: (B, 32, 32, ch) NHWC -> logits (B, classes)."""
    y = x.permute(0, 3, 1, 2)
    y = _conv_relu_pool(y, p["c1"], p["b1"])
    y = _conv_relu_pool(y, p["c2"], p["b2"])
    y = y.permute(0, 2, 3, 1).reshape(y.shape[0], -1)   # (h, w, c) order
    y = F.relu(y @ p["f1"] + p["b3"])
    return y @ p["f2"] + p["b4"]


def cnn_loss(p: dict, x: torch.Tensor, yl: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy of the logits against integer labels ``yl``."""
    lg = F.log_softmax(cnn_logits(p, x), dim=-1)
    return -lg.gather(1, yl.long()[:, None]).mean()
