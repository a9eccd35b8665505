"""Data substrate: the deterministic synthetic LM task and the per-worker
batch pipeline."""

from repro_torch.data.pipeline import WorkerDataConfig, lm_worker_batches
from repro_torch.data.synthetic import SyntheticLM

__all__ = ["SyntheticLM", "WorkerDataConfig", "lm_worker_batches"]
