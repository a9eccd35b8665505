"""Data substrate: the deterministic synthetic LM and image tasks, the
paper's nonlinear augmentations and the per-worker batch pipeline."""

from repro_torch.data.pipeline import (WorkerDataConfig, image_worker_batches,
                                       lm_worker_batches, step_generator)
from repro_torch.data.synthetic import (SyntheticImages, SyntheticLM,
                                        make_image_task, make_lm_task)

__all__ = ["SyntheticImages", "SyntheticLM", "WorkerDataConfig",
           "image_worker_batches", "lm_worker_batches", "make_image_task",
           "make_lm_task", "step_generator"]
