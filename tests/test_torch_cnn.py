"""Port parity for the paper's CNN and its data: the model's loss and
gradients, the flat parameter order, the vmapped per-worker gradients,
the synthetic image task and the nonlinear augmentations, each against
the JAX package (``benchmarks/common.py``, ``repro/data``) on the same
weights and the same numpy inputs.

Tolerances, each stated where it is used: the loss is an fp32 forward in
another library (rtol 1e-5); a gradient may differ by 1e-6 of the largest
|g| (fp32 sums of the convolutions' products taken in another order; 5e-8
of 0.154 seen); the augmentations by 1e-5 in [0, 1] images (fp32 ``log``,
``sigmoid`` and 16 RK4 steps a few ulps apart); the cat map and the
templates are exact.
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from repro.data import augment as jaugment
from repro.data.synthetic import SyntheticImages as JSyntheticImages
from repro_torch.data import (SyntheticImages, WorkerDataConfig,
                              image_worker_batches, make_image_task,
                              step_generator)
from repro_torch.data import augment
from repro_torch.launch.byzantine import worker_gradients
from repro_torch.models.cnn import cnn_init, cnn_logits, cnn_loss
from repro_torch.weights import leaf_items, pack, params_from_jax

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

CNN_N = 67_642
KEYS = ["b1", "b2", "b3", "b4", "c1", "c2", "f1", "f2"]


@pytest.fixture(scope="module")
def jax_params():
    return jcommon.cnn_init(jax.random.PRNGKey(0))


def _np_params(jp):
    return {k: np.asarray(v) for k, v in jp.items()}


def _batch(seed: int, b: int = 4, ch: int = 3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0.0, 1.0, size=(b, 32, 32, ch)).astype(np.float32)
    y = rng.integers(0, 10, size=b).astype(np.int32)
    return x, y


def _grad_dict(params, x, y):
    return torch.func.grad(cnn_loss)(params, torch.from_numpy(x),
                                      torch.from_numpy(y).long())


@pytest.mark.parametrize("seed", [0, 1])
def test_loss_and_gradients_match_jax(jax_params, seed):
    x, y = _batch(seed)
    want_loss = float(jcommon.cnn_loss(jax_params, jnp.asarray(x),
                                       jnp.asarray(y)))
    want = jax.grad(jcommon.cnn_loss)(jax_params, jnp.asarray(x),
                                      jnp.asarray(y))
    params = params_from_jax(_np_params(jax_params))
    loss = float(cnn_loss(params, torch.from_numpy(x),
                          torch.from_numpy(y).long()))
    assert loss == pytest.approx(want_loss, rel=1e-5)
    got = _grad_dict(params, x, y)
    gmax = max(float(np.abs(np.asarray(v)).max()) for v in want.values())
    for k in KEYS:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6 * gmax, err_msg=k)


def test_logits_match_jax_on_an_odd_batch(jax_params):
    x, _ = _batch(7, b=3)
    want = np.asarray(jcommon.cnn_logits(jax_params, jnp.asarray(x)))
    got = cnn_logits(params_from_jax(_np_params(jax_params)),
                     torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())


def test_flat_order_is_jax_flatten(jax_params):
    params = params_from_jax(_np_params(jax_params))
    assert [p for p, _ in leaf_items(params)] == [(k,) for k in KEYS]
    flat, layout = pack(params)
    assert layout.numel == CNN_N
    np.testing.assert_array_equal(flat.numpy(),
                                  np.asarray(jcommon._flatten(jax_params)))


def test_init_layout_and_scale():
    a = cnn_init(torch.Generator().manual_seed(0))
    b = cnn_init(torch.Generator().manual_seed(0))
    jp = jcommon.cnn_init(jax.random.PRNGKey(0))
    assert sorted(a) == KEYS
    for k in KEYS:
        assert tuple(a[k].shape) == jp[k].shape and a[k].dtype == torch.float32
        assert torch.equal(a[k], b[k])
    for k, fan in (("c1", 27), ("c2", 72), ("f1", 1024), ("f2", 64)):
        assert float(a[k].abs().max()) <= 2.0 * fan ** -0.5
    assert all(float(a[k].abs().max()) == 0.0 for k in KEYS if k[0] == "b")


def test_vmapped_gradients_match_per_worker(jax_params):
    """One vmapped call against a grad per worker: the convolutions fold
    the worker axis into their batch, sums in another order (1.2e-7 of max
    |g| seen; bound 1e-6)."""
    flat, layout = pack(_np_params(jax_params))
    rng = np.random.default_rng(3)
    xs = torch.from_numpy(rng.uniform(0, 1, (5, 4, 32, 32, 3))
                          .astype(np.float32))
    ys = torch.from_numpy(rng.integers(0, 10, (5, 4)))
    G = worker_gradients(flat, layout, xs, ys)
    assert G.shape == (5, CNN_N) and G.dtype == torch.float32
    params = params_from_jax(_np_params(jax_params))
    for w in range(5):
        g = _grad_dict(params, xs[w].numpy(), ys[w].numpy().astype(np.int32))
        row = torch.cat([g[k].reshape(-1) for k in KEYS])
        assert float((G[w] - row).abs().max()) <= 1e-6 * float(
            row.abs().max())


# ---------------------------------------------------------------------------
# the synthetic image task
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [{"seed": 0}, {"seed": 3},
                                {"seed": 1, "channels": 1, "height": 16,
                                 "width": 24, "num_classes": 4}])
def test_templates_are_byte_equal(kw):
    got = make_image_task(**kw).templates
    want = np.asarray(JSyntheticImages(**kw).templates)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert got.numpy().tobytes() == want.tobytes()


def test_sample_and_test_set():
    task = SyntheticImages(seed=0)
    x, y = task.sample(torch.Generator().manual_seed(1), 5, lead=(3,))
    assert x.shape == (3, 5, 32, 32, 3) and y.shape == (3, 5)
    assert float(x.min()) >= 0.0 and float(x.max()) <= 1.0
    assert int(y.min()) >= 0 and int(y.max()) < 10
    x2, y2 = task.sample(torch.Generator().manual_seed(1), 5, lead=(3,))
    assert torch.equal(x, x2) and torch.equal(y, y2)
    # the noise is added to the label's template, then clipped
    t = task.templates[y]
    assert float((x - t).abs().max()) > 0.0
    assert torch.equal(x, torch.clamp(x, 0, 1))
    xt, yt = task.test_set(64)
    xt2, _ = task.test_set(64)
    assert xt.shape == (64, 32, 32, 3) and torch.equal(xt, xt2)
    assert not torch.equal(task.test_set(64, seed=5)[0], xt)


def test_image_worker_batches_augment_the_first_k():
    task = SyntheticImages(seed=0)
    cfg = WorkerDataConfig(workers=4, per_worker_batch=3, augment_workers=2,
                           augment_scheme="cat_map", gaussian_sigma=0.1)
    x, y = image_worker_batches(task, cfg, step=5, seed=2)
    gen = step_generator(2, 5)
    x0, y0 = task.sample(gen, 3, lead=(4,))
    assert torch.equal(y, y0) and torch.equal(x[2:], x0[2:])
    want = augment.augment_batch(gen, x0[:2], scheme="cat_map",
                                 gaussian_sigma=0.1)
    assert torch.equal(x[:2], want)
    plain = WorkerDataConfig(workers=4, per_worker_batch=3)
    assert torch.equal(image_worker_batches(task, plain, 5, 2)[0], x0)


# ---------------------------------------------------------------------------
# the nonlinear augmentations against JAX (no noise)
# ---------------------------------------------------------------------------

AUG_SHAPES = [(2, 32, 32, 3), (2, 32, 32, 4), (1, 16, 16, 5), (3, 8, 8, 1)]


def _images(shape, seed=11):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(
        np.float32)


@pytest.mark.parametrize("shape", AUG_SHAPES, ids=str)
@pytest.mark.parametrize("scheme", ["lotka_volterra", "cat_map",
                                    "smooth_cat_map"])
def test_augmentations_match_jax(scheme, shape):
    x = _images(shape)
    want = np.asarray(getattr(jaugment, scheme)(jnp.asarray(x)))
    got = getattr(augment, scheme)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    if scheme == "cat_map":
        np.testing.assert_array_equal(got, want)        # a gather
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    batch = augment.augment_batch(torch.Generator(), torch.from_numpy(x),
                                  scheme=scheme, gaussian_sigma=0.0).numpy()
    jbatch = np.asarray(jaugment.augment_batch(
        jax.random.PRNGKey(0), jnp.asarray(x), scheme=scheme,
        gaussian_sigma=0.0))
    np.testing.assert_allclose(batch, jbatch, rtol=0, atol=1e-5)


def test_lotka_volterra_odd_channel_passes_through():
    x = _images((2, 8, 8, 3))
    got = augment.lotka_volterra(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got[..., 2], x[..., 2])
    assert not np.array_equal(got[..., :2], x[..., :2])


def test_bilinear_weights_from_the_clipped_corner():
    """Coordinates past the last pixel keep wx = xf - x0 after the clip
    (a weight above 1), as the JAX package computes it."""
    img = _images((6, 6, 2), seed=4)
    yy, xx = np.mgrid[0:6, 0:6].astype(np.float32)
    xf = xx * 1.3 + 0.25
    yf = yy * 0.9 + 2.6
    want = np.asarray(jaugment._bilinear(jnp.asarray(img), jnp.asarray(xf),
                                         jnp.asarray(yf)))
    got = augment._bilinear(torch.from_numpy(img), torch.from_numpy(xf),
                            torch.from_numpy(yf)).numpy()
    assert xf.max() > 6.0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_augment_batch_noise_and_errors():
    x = torch.full((2, 8, 8, 3), 0.5)
    a = augment.augment_batch(torch.Generator().manual_seed(0), x,
                              scheme="none", gaussian_sigma=0.1)
    b = augment.augment_batch(torch.Generator().manual_seed(0), x,
                              scheme="none", gaussian_sigma=0.1)
    assert torch.equal(a, b) and not torch.equal(a, x)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    with pytest.raises(ValueError, match="unknown augmentation"):
        augment.augment_batch(torch.Generator(), x, scheme="rot13")
    with pytest.raises(ValueError, match="square"):
        augment.cat_map(torch.zeros(1, 4, 6, 3))
