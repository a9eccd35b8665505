"""The four assigned input shapes and their input specs (port of
``repro/configs/shapes.py``).

Where the JAX package describes an input by a ``jax.ShapeDtypeStruct``,
the port gives a tensor on the ``meta`` device: the same shape and dtype
(``int32`` tokens and labels, ``bfloat16`` prefix embeddings), no
storage.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.config import ModelConfig

__all__ = ["InputShape", "SHAPES", "get_shape", "token_batch_specs",
           "input_specs"]


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def get_shape(name: str) -> InputShape:
    return SHAPES[name]


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def token_batch_specs(cfg: ModelConfig, batch: int, seq: int,
                      *, with_labels: bool) -> dict:
    """Meta-tensor stand-ins for one model batch (no allocation); a
    frontend's prefix takes ``num_prefix_embeds`` of the ``seq``
    positions."""
    S_tok = seq - (cfg.num_prefix_embeds if cfg.frontend else 0)
    spec = {"tokens": _spec((batch, S_tok), torch.int32)}
    if with_labels:
        spec["labels"] = _spec((batch, S_tok), torch.int32)
    if cfg.frontend is not None:
        spec["prefix_embeds"] = _spec(
            (batch, cfg.num_prefix_embeds, cfg.d_frontend), torch.bfloat16)
    return spec


def input_specs(cfg: ModelConfig, shape: InputShape, *,
                workers: int | None = None) -> dict:
    """Input specs for (arch x shape).

    train: per-worker batches with a leading worker axis (the FA worker
    dimension), {tokens, labels[, prefix_embeds]}.
    prefill: a request batch {tokens[, prefix_embeds]}.
    decode: one new token per sequence + the decode step counter; the KV /
    recurrent-state caches are supplied separately.
    """
    if shape.kind == "train":
        if not workers:
            raise ValueError("training specs need the worker count")
        if shape.global_batch % workers:
            raise ValueError(f"{workers} workers do not divide the global "
                             f"batch {shape.global_batch}")
        per = shape.global_batch // workers
        leaf = token_batch_specs(cfg, per, shape.seq_len, with_labels=True)
        return {k: _spec((workers,) + tuple(v.shape), v.dtype)
                for k, v in leaf.items()}
    if shape.kind == "prefill":
        return token_batch_specs(cfg, shape.global_batch, shape.seq_len,
                                 with_labels=False)
    if shape.kind == "decode":
        return {"tokens": _spec((shape.global_batch, 1), torch.int32),
                "step": _spec((), torch.int32)}
    raise ValueError(shape.kind)
