"""Deterministic synthetic LM task (port of ``SyntheticLM`` in
``repro/data/synthetic.py``).

A Markov-chain token stream: each token's successors come from a hashed
table ``ctx -> branch`` tokens.  The hash is computed in **int32 with
wraparound**, as the JAX package computes it (JAX runs with 64-bit types
off), so the successor table is the same in both packages.  The random
start tokens and successor picks come from a ``torch.Generator`` and
cannot match ``jax.random``'s draws.
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
