"""The paper's nonlinear data augmentations (Sec. 3.1), port of
``repro/data/augment.py``.

* **Lotka-Volterra**: (x, y) -> (alpha x - beta x y, delta x y - gamma y)
  with (alpha, beta, gamma, delta) = (2/3, 4/3, -1, -1), integrated with
  fixed-step RK4 on the channel pairs (0, 1), (2, 3), ... of an image taken
  as the (x, y) state (offset by +0.5 to keep it away from 0); an odd last
  channel passes through.
* **Arnold's cat map**: (x, y) -> ((2x + y) mod N, (x + y) mod N) on pixel
  coordinates, and the paper's smooth approximation (the mod replaced by a
  sigmoid of m log a, m = 0.95) with bilinear resampling.
* Gaussian noise on top, drawn from a ``torch.Generator``.

Images are (..., H, W, ch) in [0, 1] on any device; every function keeps
the JAX package's order of operations.
"""

from __future__ import annotations

import torch

__all__ = ["LV_PARAMS", "rk4", "lotka_volterra", "cat_map", "smooth_cat_map",
           "augment_batch"]

LV_PARAMS = (2.0 / 3.0, 4.0 / 3.0, -1.0, -1.0)   # alpha, beta, gamma, delta


def _lv_field(state, params=LV_PARAMS):
    alpha, beta, gamma, delta = params
    x, y = state
    return (alpha * x - beta * x * y, delta * x * y - gamma * y)


def rk4(field, state: tuple, dt: float, steps: int) -> tuple:
    """Fixed-step RK4 for a tuple-of-tensors state."""
    def axpy(s, k, h):
        return tuple(si + h * ki for si, ki in zip(s, k))
    for _ in range(steps):
        k1 = field(state)
        k2 = field(axpy(state, k1, 0.5 * dt))
        k3 = field(axpy(state, k2, 0.5 * dt))
        k4 = field(axpy(state, k3, dt))
        state = tuple(s + dt / 6.0 * (a + 2 * b + 2 * c + d)
                      for s, a, b, c, d in zip(state, k1, k2, k3, k4))
    return state


def lotka_volterra(images: torch.Tensor, *, t: float = 1.0,
                   steps: int = 16) -> torch.Tensor:
    """Channel pairs (0, 1), (2, 3), ... evolve under the LV flow for time
    ``t``; an odd last channel is left unchanged; clipped to [0, 1]."""
    ch = images.shape[-1]
    npair = ch // 2
    x = images[..., 0:2 * npair:2] + 0.5
    y = images[..., 1:2 * npair:2] + 0.5
    xs, ys = rk4(_lv_field, (x, y), t / steps, steps)
    out = torch.stack([xs - 0.5, ys - 0.5], dim=-1)
    out = out.reshape(*images.shape[:-1], 2 * npair)
    if ch % 2:
        out = torch.cat([out, images[..., -1:]], dim=-1)
    return torch.clamp(out, 0.0, 1.0)


def _grid(H: int, W: int, device):
    yy = torch.arange(H, device=device)[:, None].expand(H, W)
    xx = torch.arange(W, device=device)[None, :].expand(H, W)
    return yy, xx


def cat_map(images: torch.Tensor, *, iterations: int = 1) -> torch.Tensor:
    """The exact cat map on pixel coordinates (square images): a gather at
    integer coordinates."""
    H, W = images.shape[-3], images.shape[-2]
    if H != W:
        raise ValueError(f"cat map needs square images, got {H} x {W}")
    yy, xx = _grid(H, W, images.device)
    for _ in range(iterations):
        xx, yy = (2 * xx + yy) % W, (xx + yy) % H
    return images[..., yy, xx, :]


def _bilinear(img: torch.Tensor, xf: torch.Tensor,
              yf: torch.Tensor) -> torch.Tensor:
    """img (..., H, W, ch) sampled at float coordinates xf / yf (H, W).
    The weights come from the clipped corners (``wx = xf - x0`` after the
    clip), as in the JAX package, even where that makes a weight above 1."""
    H, W = img.shape[-3], img.shape[-2]
    x0 = torch.clamp(torch.floor(xf).to(torch.int32), 0, W - 1).long()
    y0 = torch.clamp(torch.floor(yf).to(torch.int32), 0, H - 1).long()
    x1 = torch.clamp(x0 + 1, max=W - 1)
    y1 = torch.clamp(y0 + 1, max=H - 1)
    wx = (xf - x0)[..., None]
    wy = (yf - y0)[..., None]
    return ((1 - wy) * ((1 - wx) * img[..., y0, x0, :]
                        + wx * img[..., y0, x1, :])
            + wy * ((1 - wx) * img[..., y1, x0, :]
                    + wx * img[..., y1, x1, :]))


def smooth_cat_map(images: torch.Tensor, *, m: float = 0.95) -> torch.Tensor:
    """The paper's smooth cat map: mod replaced by 1 / (1 + exp(-m log a))
    and the image resampled bilinearly there."""
    H, W = images.shape[-3], images.shape[-2]
    yy, xx = _grid(H, W, images.device)
    a1 = (2 * xx + yy).to(torch.float32) / W + 1e-6
    a2 = (xx + yy).to(torch.float32) / H + 1e-6
    sx = W * torch.sigmoid(m * torch.log(a1))
    sy = H * torch.sigmoid(m * torch.log(a2))
    return _bilinear(images, sx, sy)


def augment_batch(gen: torch.Generator, images: torch.Tensor, *, scheme: str,
                  gaussian_sigma: float = 0.05) -> torch.Tensor:
    """Apply ``scheme`` ('none', 'lotka_volterra', 'cat_map',
    'smooth_cat_map'), then Gaussian noise drawn from ``gen`` on its own
    device (so a CPU generator gives the same noise to every device);
    clipped to [0, 1]."""
    if scheme == "lotka_volterra":
        images = lotka_volterra(images)
    elif scheme == "cat_map":
        images = cat_map(images)
    elif scheme == "smooth_cat_map":
        images = smooth_cat_map(images)
    elif scheme != "none":
        raise ValueError(f"unknown augmentation {scheme!r}")
    if gaussian_sigma:
        noise = torch.randn(images.shape, generator=gen, device=gen.device)
        images = images + gaussian_sigma * noise.to(images.device)
    return torch.clamp(images, 0.0, 1.0)
