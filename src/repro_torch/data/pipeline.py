"""Per-worker LM batches (port of ``lm_worker_batches`` in
``repro/data/pipeline.py``): worker-major ``{tokens, labels}`` of shape
(W, B, S), the layout the train step consumes."""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.data.synthetic import SyntheticLM


@dataclass
class WorkerDataConfig:
    workers: int
    per_worker_batch: int


def lm_worker_batches(task: SyntheticLM, cfg: WorkerDataConfig, step: int,
                      seq_len: int, seed: int = 0, device="cpu"):
    """-> {tokens: (W, B, S), labels: (W, B, S)} int32 on ``device``.

    The tokens are drawn on the CPU from a generator seeded by
    ``(seed, step)``, so a run on the card and one on the CPU see the same
    data; only the finished batch moves to ``device``.
    """
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed) * 1_000_003 + int(step))
    b = task.batch(gen, cfg.per_worker_batch, seq_len, lead=(cfg.workers,))
    return {k: v.to(device) for k, v in b.items()}
