"""Per-worker batches (port of ``repro/data/pipeline.py``): worker-major
LM batches ``{tokens, labels}`` of shape (W, B, S) and image batches
(W, B, H, W, ch) with labels (W, B), the layouts the train steps consume.

Every batch is drawn on the CPU from a generator seeded by ``(seed,
step)`` (:func:`step_generator`), so a run on the card and one on the CPU
see the same data; only the finished batch moves to ``device``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.data import augment
from repro_torch.data.synthetic import SyntheticImages, SyntheticLM


@dataclass
class WorkerDataConfig:
    workers: int
    per_worker_batch: int
    augment_workers: int = 0          # first k workers augment their data
    augment_scheme: str = "none"
    gaussian_sigma: float = 0.0


def step_generator(seed: int, step: int) -> torch.Generator:
    """The CPU generator of one step's draws."""
    gen = torch.Generator(device="cpu")
    gen.manual_seed(int(seed) * 1_000_003 + int(step))
    return gen


def lm_worker_batches(task: SyntheticLM, cfg: WorkerDataConfig, step: int,
                      seq_len: int, seed: int = 0, device="cpu"):
    """-> {tokens: (W, B, S), labels: (W, B, S)} int32 on ``device``."""
    b = task.batch(step_generator(seed, step), cfg.per_worker_batch, seq_len,
                   lead=(cfg.workers,))
    return {k: v.to(device) for k, v in b.items()}


def image_worker_batches(task: SyntheticImages, cfg: WorkerDataConfig,
                         step: int, seed: int = 0, device="cpu"):
    """-> (images (W, B, H, W, ch) fp32, labels (W, B) int64) on
    ``device``; the first ``augment_workers`` workers' images go through
    ``augment_scheme`` and Gaussian noise (drawn after the samples, from
    the same generator)."""
    gen = step_generator(seed, step)
    x, y = task.sample(gen, cfg.per_worker_batch, lead=(cfg.workers,))
    x, y = x.to(device), y.to(device)
    k = min(cfg.augment_workers, cfg.workers)
    if cfg.augment_scheme != "none" and k > 0:
        x[:k] = augment.augment_batch(gen, x[:k], scheme=cfg.augment_scheme,
                                      gaussian_sigma=cfg.gaussian_sigma)
    return x, y
