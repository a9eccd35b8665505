"""Deterministic synthetic tasks (port of ``repro/data/synthetic.py``).

``SyntheticImages`` is the CIFAR-10-shaped stand-in of the paper's accuracy
experiments: one template per class, built from low-frequency Fourier
patterns with ``numpy.random.default_rng(seed)`` exactly as the JAX
package builds it (the templates are byte-equal in both), plus Gaussian
pixel noise per sample, clipped to [0, 1].  Labels and noise come from a
``torch.Generator`` and cannot match ``jax.random``'s draws.

``SyntheticLM`` is a Markov-chain token stream: each token's successors
come from a hashed table ``ctx -> branch`` tokens.  The hash is computed in
**int32 with wraparound**, as the JAX package computes it (JAX runs with
64-bit types off), so the successor table is the same in both packages.
The random start tokens and successor picks come from a
``torch.Generator`` and cannot match ``jax.random``'s draws.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class SyntheticLM:
    """Markov-chain token stream: learnable structure, deterministic."""
    vocab_size: int = 512
    order: int = 2
    seed: int = 0
    branch: int = 4   # successors per context

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._a = int(rng.integers(1, 2**31 - 1))
        self._b = int(rng.integers(1, 2**31 - 1))

    def _succ(self, ctx: torch.Tensor) -> torch.Tensor:
        """ctx int32 (...) -> successor tokens int32 (..., branch)."""
        ctx = ctx.to(torch.int32)
        h = (ctx * self._a + self._b) % (2**31 - 1)
        k = torch.arange(1, self.branch + 1, dtype=torch.int32,
                         device=ctx.device)
        return (h[..., None] * k) % self.vocab_size

    def sample(self, gen: torch.Generator, batch: int, seq_len: int,
               lead: tuple = ()) -> torch.Tensor:
        """-> tokens (*lead, B, S+1) int32 on the generator's device; use
        [..., :-1] as inputs and [..., 1:] as labels."""
        dev = gen.device
        tok = torch.randint(0, self.vocab_size, (*lead, batch),
                            generator=gen, device=dev, dtype=torch.int32)
        picks = torch.randint(0, self.branch, (*lead, batch, seq_len),
                              generator=gen, device=dev)
        toks = [tok]
        for t in range(seq_len):
            tok = torch.gather(self._succ(tok), -1,
                               picks[..., t:t + 1])[..., 0]
            toks.append(tok)
        return torch.stack(toks, dim=-1)

    def batch(self, gen: torch.Generator, batch: int, seq_len: int,
              lead: tuple = ()):
        toks = self.sample(gen, batch, seq_len, lead)
        return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


@dataclass
class SyntheticImages:
    """C class templates (H, W, ch) in [0, 1] plus per-sample noise."""
    num_classes: int = 10
    height: int = 32
    width: int = 32
    channels: int = 3
    noise: float = 0.25
    seed: int = 0

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        yy, xx = np.mgrid[0:self.height, 0:self.width].astype(np.float32)
        yy, xx = yy / self.height, xx / self.width
        templates = []
        for _ in range(self.num_classes):
            t = np.zeros((self.height, self.width, self.channels), np.float32)
            for c in range(self.channels):
                for _ in range(3):  # 3 low-frequency components
                    fy, fx = rng.integers(1, 4, size=2)
                    ph = rng.uniform(0, 2 * np.pi, size=2)
                    t[:, :, c] += rng.uniform(0.3, 1.0) * (
                        np.sin(2 * np.pi * fy * yy + ph[0])
                        * np.sin(2 * np.pi * fx * xx + ph[1]))
            t = (t - t.min()) / max(t.max() - t.min(), 1e-6)
            templates.append(t)
        self.templates = torch.from_numpy(np.stack(templates))

    def sample(self, gen: torch.Generator, batch: int, lead: tuple = ()):
        """-> (images (*lead, B, H, W, ch) fp32 in [0, 1], labels
        (*lead, B) int64), on the generator's device."""
        dev = gen.device
        y = torch.randint(0, self.num_classes, (*lead, batch), generator=gen,
                          device=dev)
        x = self.templates.to(dev)[y]
        x = x + self.noise * torch.randn(x.shape, generator=gen, device=dev)
        return torch.clamp(x, 0.0, 1.0), y

    def test_set(self, n: int = 2048, seed: int = 999):
        """n samples from a CPU generator seeded with ``seed``."""
        return self.sample(torch.Generator().manual_seed(seed), n)


def make_image_task(seed: int = 0, **kw) -> SyntheticImages:
    return SyntheticImages(seed=seed, **kw)


def make_lm_task(vocab_size: int, seed: int = 0, **kw) -> SyntheticLM:
    return SyntheticLM(vocab_size=vocab_size, seed=seed, **kw)
