"""Resume and the elastic kill-and-resume driver of the port.

Self-consistency (the port against itself, as tests/test_checkpoint.py
holds the JAX package): running 2N steps uninterrupted equals running N +
1, dying with a torn checkpoint behind, restoring the newest complete one
and running the rest, within the driver's tolerance 1e-6 (measured 0 on
the CPU), across {flag, krum, mean} x {none, sign_flip} x {identity,
signSGD}, plus CountSketch, top-k and a worker leaving and rejoining
around the kill.  The launcher resumes on the persisted horizon with
losses equal to the uninterrupted run's, and refuses a resume whose codec
differs.

Across packages (the weights carried over in the one file layout): JAX's
elastic harness writes its checkpoint at step N, the port restores it and
runs steps N..2N-1 on JAX's batches, and the other way round.  Both are
held to JAX's uninterrupted run at test_torch_train.py's tolerances: the
loss rtol 1e-5 (an fp32 forward in another summation order) and the FA
weights rtol 5e-3 / atol 5e-4 (eigensolvers differ).  The codec is the
exact identity: signSGD and top-k flip coordinates where the packages'
gradients differ in their last bits (ROADMAP.md section 3), and the
bitwise load of an EF state is held in test_torch_checkpoint.py.
"""

from __future__ import annotations

import os

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import load_checkpoint as jax_load
from repro.checkpoint import save_checkpoint as jax_save
from repro.data.pipeline import lm_worker_batches as jax_lm_worker_batches
from repro.launch import elastic as jelastic
from repro_torch.checkpoint import (checkpoint_meta, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.dist.train_step import init_train_state, train_state_tree
from repro_torch.launch import elastic
from repro_torch.launch import train as tlaunch
from repro_torch.launch.elastic import (ElasticConfig, build_harness,
                                        run_elastic, verify_elastic)

torch.set_num_threads(max(1, os.cpu_count() // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

N = 3  # 2N total steps, killed at N + 1 (after the checkpoint at N)

# (aggregator, attack, codec, faults): the acceptance matrix of
# tests/test_checkpoint.py, then CountSketch, top-k, and one worker out
# for steps 2-3 and back at 4, around the kill at 4
CASES = ([(agg, attack, codec, "none")
          for agg in ("flag", "krum", "mean")
          for attack in ("none", "sign_flip")
          for codec in ("identity", "signsgd")]
         + [("flag", "sign_flip", "countsketch", "none"),
            ("flag", "sign_flip", "topk", "none"),
            ("flag", "none", "signsgd", "rejoin")])


@pytest.mark.parametrize("agg,attack,codec,faults", CASES,
                         ids=["-".join(c) for c in CASES])
def test_kill_and_resume_matches_uninterrupted(tmp_path, agg, attack, codec,
                                               faults):
    cfg = ElasticConfig(
        steps=2 * N, workers=6, per_worker_batch=2, seq=32,
        aggregator=agg, attack=attack,
        byzantine=1 if attack != "none" else 0, codec=codec,
        faults=faults, faults_kw={"at": 2, "down": 2} if faults != "none"
        else {}, ckpt_every=N, device="cpu")
    out = verify_elastic(build_harness(cfg), str(tmp_path / "ckpt"),
                         kill_at=(N + 1,), tol=1e-6)
    assert out["kills"] == [N + 1]
    assert out["rounds"] == 2
    assert out["replayed"] == 1               # step N, once more
    assert out["ok"], (out["max_diff"], out["replay_mismatch"])


def test_resume_uses_persisted_lr_horizon(tmp_path):
    cfg = ElasticConfig(steps=2 * N, workers=5, per_worker_batch=2, seq=32,
                        aggregator="mean", ckpt_every=N, device="cpu")
    run_elastic(build_harness(cfg), str(tmp_path / "c"), kill_at=())
    meta = checkpoint_meta(str(tmp_path / "c"))
    assert meta["step"] == 2 * N
    assert meta["extra"]["total_steps"] == 2 * N


def test_cli_verifies_and_refuses_without_a_card(tmp_path, capsys):
    out = elastic.main(["--device", "cpu", "--verify", "--steps", "4",
                        "--kill-at", "3", "--ckpt-every", "2", "--workers",
                        "3", "--seq", "16", "--codec", "signsgd",
                        "--ckpt-dir", str(tmp_path / "c")])
    assert out["ok"] and out["kills"] == [3]
    assert "VERIFY: OK" in capsys.readouterr().out
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            elastic.main(["--steps", "2", "--ckpt-dir",
                          str(tmp_path / "d")])


# ---------------------------------------------------------------------------
# the launcher's resume path
# ---------------------------------------------------------------------------

class _Killed(Exception):
    pass


def _argv(d, steps=4, *extra):
    return ["--debug", "--device", "cpu", "--workers", "4", "--seq", "16",
            "--per-worker-batch", "1", "--steps", str(steps), "--ckpt-dir",
            str(d), "--ckpt-every", "2", "--log-every", "100", *extra]


def test_launcher_resumes_on_the_persisted_horizon(tmp_path, capsys):
    """Killed after the checkpoint at step 2, a run restarted with another
    --steps completes the original 4-step run: steps 2 and 3 equal the
    uninterrupted run's exactly (losses, lr, |g|, FA weights), and so does
    the final checkpoint, leaf for leaf."""
    full = tlaunch.main(_argv(tmp_path / "a"))

    def kill_after_step_1(t, state, m):
        if t == 1:
            raise _Killed
    with pytest.raises(_Killed):
        tlaunch.main(_argv(tmp_path / "b"), on_step=kill_after_step_1)
    assert latest_step(str(tmp_path / "b")) == 2
    capsys.readouterr()
    resumed = tlaunch.main(_argv(tmp_path / "b", 9))
    out = capsys.readouterr().out
    assert "resumed from step 2" in out
    assert "total_steps=4" in out
    assert [r["step"] for r in resumed] == [2, 3]
    for k in ("loss", "lr", "grad_global_norm", "fa_weights"):
        assert [r[k] for r in resumed] == [r[k] for r in full[2:]], k
    assert "save_s" in resumed[-1] and "save_s" in full[1]
    with np.load(tmp_path / "a" / "step_00000004" / "state_0.npz") as za, \
            np.load(tmp_path / "b" / "step_00000004" / "state_0.npz") as zb:
        assert sorted(za.files) == sorted(zb.files)
        for k in za.files:
            np.testing.assert_array_equal(za[k], zb[k], err_msg=k)


def test_launcher_refuses_a_resume_with_another_codec(tmp_path):
    tlaunch.main(_argv(tmp_path, 2))
    with pytest.raises(SystemExit, match="resume state mismatch"):
        tlaunch.main(_argv(tmp_path, 2, "--codec", "signsgd"))


# ---------------------------------------------------------------------------
# across packages: the weights carried over in the one file layout
# ---------------------------------------------------------------------------

CROSS = dict(steps=2 * N, workers=6, per_worker_batch=2, seq=32,
             aggregator="flag", attack="sign_flip", byzantine=1,
             codec="identity", ckpt_every=N)


@pytest.fixture(scope="module")
def jax_run(tmp_path_factory):
    """JAX's uninterrupted 2N-step run (losses, FA weights), its checkpoint
    at step N, and its initial parameters."""
    jh = jelastic.build_harness(jelastic.ElasticConfig(**CROSS))
    d = str(tmp_path_factory.mktemp("jax_ckpt"))
    state = jelastic._init_state(jh)
    params0 = jax.tree.map(np.asarray, state[0])
    ref = {}
    for t in range(2 * N):
        if t == N:
            jax_save(d, N, state, extra={"total_steps": 2 * N})
        state, m = jelastic._one_step(jh, state, t)
        ref[t] = (float(m["loss"]), np.asarray(m["fa_weights"]))
    return jh, d, params0, ref


def _jax_batch(jh, t):
    b = jax_lm_worker_batches(jh.task, jh.wdc, t, jh.cfg.seq)
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def _close(t, loss, c, ref):
    np.testing.assert_allclose(loss, ref[t][0], rtol=1e-5,
                               err_msg=f"loss, step {t}")
    np.testing.assert_allclose(c, ref[t][1], rtol=5e-3, atol=5e-4,
                               err_msg=f"FA weights, step {t}")


def test_port_resumes_a_jax_checkpoint(jax_run):
    jh, d, _, ref = jax_run
    h = build_harness(ElasticConfig(**CROSS, device="cpu"))
    state = elastic._init_state(h)
    _, step = load_checkpoint(d, train_state_tree(state))
    assert step == N and int(state.opt_state["count"]) == N
    for t in range(N, 2 * N):
        m = h.step_fn(state, _jax_batch(jh, t), t)
        _close(t, float(m["loss"]), m["fa_weights"].numpy(), ref)


def test_jax_resumes_a_port_checkpoint(jax_run, tmp_path):
    jh, _, params0, ref = jax_run
    h = build_harness(ElasticConfig(**CROSS, device="cpu"))
    state = init_train_state(h.model_cfg, h.opt, params=params0,
                             comm=h.comm, workers=h.cfg.workers)
    for t in range(N):
        m = h.step_fn(state, _jax_batch(jh, t), t)
        _close(t, float(m["loss"]), m["fa_weights"].numpy(), ref)
    save_checkpoint(str(tmp_path), N, train_state_tree(state),
                    extra={"total_steps": 2 * N})
    jstate, step = jax_load(str(tmp_path), jelastic._init_state(jh))
    assert step == N
    for t in range(N, 2 * N):
        jstate, m = jelastic._one_step(jh, jstate, t)
        _close(t, float(m["loss"]), np.asarray(m["fa_weights"]), ref)
