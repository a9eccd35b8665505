"""Checkpoints of the port: crash-safe tensor-tree save / restore (format
v2, the JAX package's file layout and leaf keys; see ``checkpoint.py``)."""

from repro_torch.checkpoint.checkpoint import (checkpoint_meta, latest_step,
                                               leaf_keys, load_checkpoint,
                                               save_checkpoint)

__all__ = ["save_checkpoint", "load_checkpoint", "latest_step",
           "checkpoint_meta", "leaf_keys"]
