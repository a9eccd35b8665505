"""Port parity: ``repro_torch.configs.shapes`` against the JAX package's
``repro.configs.shapes`` -- the four input shapes and, for all ten
configurations, every input spec's keys, shapes and dtypes (meta tensors
where JAX has ``ShapeDtypeStruct``s)."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import shapes as jshapes
from repro_torch.configs import ARCHS, get_config
from repro_torch.configs import shapes as tshapes

DTYPES = {"int32": torch.int32, "bfloat16": torch.bfloat16}


def test_registries_match():
    assert list(ARCHS) == list(JARCHS)
    assert {k: tuple(v.__dict__.values()) for k, v in tshapes.SHAPES.items()
            } == {k: tuple(v.__dict__.values())
                  for k, v in jshapes.SHAPES.items()}
    assert tshapes.get_shape("long_500k") == tshapes.SHAPES["long_500k"]


@pytest.mark.parametrize("workers", [16, 32])
@pytest.mark.parametrize("shape", sorted(jshapes.SHAPES))
@pytest.mark.parametrize("arch", list(JARCHS))
def test_input_specs_match_jax(arch, shape, workers):
    want = jshapes.input_specs(JARCHS[arch], jshapes.get_shape(shape),
                               workers=workers)
    got = tshapes.input_specs(get_config(arch), tshapes.get_shape(shape),
                              workers=workers)
    assert list(got) == list(want)
    for k, spec in want.items():
        t = got[k]
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(spec.shape), (k, t.shape)
        assert t.dtype == DTYPES[np.dtype(spec.dtype).name], (k, t.dtype)


@pytest.mark.parametrize("arch", ["musicgen-medium", "phi-3-vision-4.2b",
                                  "smollm-360m"])
def test_token_batch_specs_match_jax(arch):
    for with_labels in (False, True):
        want = jshapes.token_batch_specs(JARCHS[arch], 3, 300,
                                         with_labels=with_labels)
        got = tshapes.token_batch_specs(get_config(arch), 3, 300,
                                        with_labels=with_labels)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: tuple(v.shape) for k, v in want.items()}


def test_train_specs_need_a_dividing_worker_count():
    cfg, train = get_config("smollm-360m"), tshapes.get_shape("train_4k")
    with pytest.raises(ValueError, match="worker count"):
        tshapes.input_specs(cfg, train)
    with pytest.raises(ValueError, match="do not divide"):
        tshapes.input_specs(cfg, train, workers=15)
