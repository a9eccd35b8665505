"""The port's whole CNN training loop against the JAX driver:
``repro_torch.launch.byzantine.run_byzantine_training`` on the CPU against
``benchmarks/common.py::run_byzantine_training`` from the same weights
(``cnn_init`` carried across) on the same images (a task that replays the
JAX driver's key chain and draws).

Tolerance: the accuracies within 2 of the 1,024 test images.  The two
runs' parameters agree to a small share of a step
(``test_torch_byzantine.py``), which can still move an image that lies on
a decision boundary.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

from benchmarks import common as jcommon
from repro_torch.launch import byzantine
from repro_torch.launch.byzantine import ByzRunConfig, run_byzantine_training
from tests.test_torch_byzantine import _jax_draws

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))


class _ReplayTask:
    """A task whose ``sample`` hands out JAX's draws step by step."""

    def __init__(self, draws, test):
        self.draws, self.test, self.calls = draws, test, 0

    def sample(self, gen, batch, lead=()):
        xs, ys, _ = self.draws[self.calls]
        self.calls += 1
        assert lead == (xs.shape[0],) and batch == xs.shape[1]
        return torch.tensor(xs), torch.tensor(ys).long()

    def test_set(self, n):
        assert n == 1024
        return torch.tensor(self.test[0]), torch.tensor(self.test[1])


@pytest.mark.parametrize("agg", ["flag", "multi_krum"])
def test_whole_loop_matches_jax(monkeypatch, agg):
    """``run_byzantine_training`` on the CPU against the JAX driver: 8
    steps, p = 5, f = 1 sign-flipping, accuracy at steps 4 and 8."""
    kw = dict(p=5, f=1, batch=8, steps=8, eval_every=4, attack="sign_flip",
              aggregator=agg)
    want = jcommon.run_byzantine_training(jcommon.ByzRunConfig(**kw))
    draws, test = _jax_draws(5, 8, 8)
    jparams = jcommon.cnn_init(jax.random.PRNGKey(0))
    monkeypatch.setattr(byzantine, "cnn_init", lambda gen, **_: {
        k: np.asarray(v) for k, v in jparams.items()})
    task = _ReplayTask(draws, test)
    got = run_byzantine_training(ByzRunConfig(**kw), task, device="cpu")
    assert task.calls == 8
    assert [s for s, _ in got["trajectory"]] == [4, 8] == \
        [s for s, _ in want["trajectory"]]
    for (_, a), (_, b) in zip(got["trajectory"], want["trajectory"]):
        assert abs(a - b) <= 2 / 1024, (got["trajectory"],
                                         want["trajectory"])
    assert got["final_accuracy"] == got["trajectory"][-1][1]
    assert got["comm_bits_per_step"] == want["comm_bits_per_step"] == \
        32.0 * 5 * 67_642
    assert got["comm_ratio"] == want["comm_ratio"] == 1.0
    assert set(want) <= set(got)


def test_byz_probe_measures_the_run_against_itself(capsys):
    """``launch/byz_probe.py`` on the CPU: at eps 0 the perturbed run is
    the plain run (every step's d the same bits); at eps 1e-5 every step
    moves, and the plain run is restored afterwards."""
    import json

    from repro_torch.launch import byz_probe
    plain = byzantine.worker_gradients
    byz_probe.main(["--device", "cpu", "--eps", "0", "1e-5", "--steps",
                    "2", "--batch", "4"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["eps"] for ln in lines] == [0.0, 1e-5]
    assert lines[0]["d_rel_diff_by_step"] == [0.0, 0.0]
    assert all(x > 0.0 for x in lines[1]["d_rel_diff_by_step"])
    assert byzantine.worker_gradients is plain
