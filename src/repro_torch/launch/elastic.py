"""Elastic fault-injection training driver of the port: scheduled kills,
crash-safe resume, verified bit-exact trajectories (port of
``repro/launch/elastic.py``).

It runs multi-round training where the training process is killed at
scheduled steps (all in-memory state is dropped, and a deliberately
*torn* checkpoint is left behind to exercise the crash-safe store), then
restarts from the newest complete checkpoint, replays, and continues.
Worker churn (``--faults``, see :mod:`repro_torch.dist.membership`)
composes freely with the kills: membership is a function of the step
index, so a resumed run sees the worker subsets it would have seen
uninterrupted.

The contract ``--verify`` checks is the resume invariant:

    loss trajectory of  (run -> kill -> resume)*  ==  uninterrupted run

within ``--tol`` (default 1e-6), error-feedback codecs included (the EF
memory is part of the checkpointed state).  It holds because every step
is a function of ``(state, step index)``: batches come from a generator
seeded by the step, the attack's noise is seeded by the step, membership
is scheduled, CountSketch's maps are fixed by the codec's seed, the LR
schedule is built on the persisted total horizon, and the checkpoint
round-trips the state bitwise.  On the card it also needs every operation
of the step to be deterministic (see ``PERF.md``).  Each invocation
prints its settings, one line with the rounds, the kills that fired, the
replayed steps and the largest loss differences, and ``VERIFY: OK`` or
``VERIFY: FAILED`` (exit code 1)::

    PYTHONPATH=src python -m repro_torch.launch.elastic --device cpu \\
        --verify --steps 12 --kill-at 5,9 --ckpt-every 3 --codec signsgd

It runs on ``cuda`` unless ``--device cpu`` is given, and raises when no
card is present and the CPU was not asked for.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import tempfile
import time
from dataclasses import dataclass, field
from typing import NamedTuple

import torch

from repro_torch.checkpoint import (checkpoint_meta, latest_step,
                                    load_checkpoint, save_checkpoint)
from repro_torch.checkpoint.checkpoint import (_commit_name, _state_name,
                                               _step_dir)
from repro_torch.comm import CODECS, CommConfig
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.flag import FlagConfig
from repro_torch.data import SyntheticLM, WorkerDataConfig, lm_worker_batches
from repro_torch.device import resolve_device
from repro_torch.dist.aggregation import AggregatorConfig
from repro_torch.dist.membership import FAULTS, get_fault_schedule
from repro_torch.dist.train_step import (TrainConfig, build_train_step,
                                         init_train_state, train_state_tree)
from repro_torch.optim import adamw, warmup_cosine

__all__ = ["ElasticConfig", "build_harness", "run_reference", "run_elastic",
           "verify_elastic", "tear_checkpoint"]


@dataclass
class ElasticConfig:
    """One elastic training scenario (reduced arch, CPU-sized defaults)."""

    arch: str = "smollm-360m"
    steps: int = 12                  # TOTAL horizon
    workers: int = 6
    per_worker_batch: int = 2
    seq: int = 32
    aggregator: str = "flag"
    attack: str = "none"
    byzantine: int = 0
    codec: str = "none"
    error_feedback: bool | None = None
    faults: str = "none"
    faults_kw: dict = field(default_factory=dict)
    lam: float = 0.0                 # small-p default (EXPERIMENTS.md)
    lr: float = 3e-3
    ckpt_every: int = 3
    seed: int = 0
    device: str = "cuda"


class Harness(NamedTuple):
    """Built scenario: the step function and everything to drive it."""

    cfg: ElasticConfig
    device: torch.device
    model_cfg: object
    tc: TrainConfig
    comm: CommConfig
    opt: object
    step_fn: object
    task: SyntheticLM
    wdc: WorkerDataConfig


def build_harness(cfg: ElasticConfig) -> Harness:
    """Build the scenario's train step once; rounds reuse it."""
    device = resolve_device(cfg.device)
    model_cfg = reduce_for_smoke(get_config(cfg.arch))
    comm = CommConfig(codec=cfg.codec, error_feedback=cfg.error_feedback)
    tc = TrainConfig(
        aggregator=AggregatorConfig(
            name=cfg.aggregator, f=cfg.byzantine,
            flag=FlagConfig(
                lam=cfg.lam,
                regularizer="pairwise" if cfg.lam else "none")),
        attack=cfg.attack, attack_f=cfg.byzantine, comm=comm,
        faults=get_fault_schedule(cfg.faults, cfg.workers, **cfg.faults_kw))
    opt = adamw(weight_decay=0.0)
    sched = warmup_cosine(cfg.lr, cfg.steps, warmup=min(5, cfg.steps // 2))
    return Harness(cfg, device, model_cfg, tc, comm, opt,
                   build_train_step(model_cfg, tc, opt, sched),
                   SyntheticLM(vocab_size=model_cfg.vocab_size),
                   WorkerDataConfig(workers=cfg.workers,
                                    per_worker_batch=cfg.per_worker_batch))


def _init_state(h: Harness):
    return init_train_state(h.model_cfg, h.opt, seed=h.cfg.seed,
                            device=h.device, comm=h.comm,
                            workers=h.cfg.workers)


def _one_step(h: Harness, state, t: int) -> dict:
    """Advance ``state`` (in place) by step ``t``; returns its metrics."""
    batch = lm_worker_batches(h.task, h.wdc, t, h.cfg.seq, device=h.device)
    return h.step_fn(state, batch, t)


def run_reference(h: Harness) -> dict[int, float]:
    """The uninterrupted run: per-step losses for the full horizon."""
    state = _init_state(h)
    return {t: float(_one_step(h, state, t)["loss"])
            for t in range(h.cfg.steps)}


def tear_checkpoint(ckpt_dir: str, step: int) -> None:
    """Turn a saved step into what a SIGKILL mid-save leaves: the npz cut
    to half its size and no commit marker.  ``latest_step`` must skip it."""
    step_dir = _step_dir(ckpt_dir, step)
    os.unlink(os.path.join(step_dir, _commit_name(0)))
    state_path = os.path.join(step_dir, _state_name(0))
    size = os.path.getsize(state_path)
    with open(state_path, "rb+") as f:
        f.truncate(max(size // 2, 1))


def _write_torn_checkpoint(ckpt_dir: str, step: int, tree) -> None:
    """Simulate a SIGKILL mid-save of ``tree`` at ``step``."""
    save_checkpoint(ckpt_dir, step, tree)
    tear_checkpoint(ckpt_dir, step)


def run_elastic(h: Harness, ckpt_dir: str,
                kill_at: tuple[int, ...] = ()) -> dict:
    """Multi-round kill-and-resume training.

    Each kill at step k drops all in-memory state after executing step
    k-1 (and leaves a torn checkpoint at k); the next round restores the
    newest *complete* checkpoint into a fresh state and replays from
    there.  Every re-executed step must reproduce the loss of its first
    execution exactly: the largest replay difference is returned for the
    caller to assert on.

    Returns a dict: ``losses`` {step: loss} (first execution wins),
    ``replayed`` (re-executed step count), ``replay_mismatch`` (max abs
    loss diff across replays), ``rounds``, ``kills`` (the kill steps that
    fired).
    """
    cfg = h.cfg
    if os.path.isdir(ckpt_dir):
        shutil.rmtree(ckpt_dir)
    kills = sorted(k for k in set(kill_at) if 0 < k < cfg.steps)
    extra = {"total_steps": cfg.steps}
    losses: dict[int, float] = {}
    replayed = 0
    replay_mismatch = 0.0
    rounds = 0
    fired = []

    while True:
        rounds += 1
        # (re)start: restore the newest complete checkpoint, or init
        state, step0 = _init_state(h), 0
        if latest_step(ckpt_dir) is not None:
            saved_total = checkpoint_meta(ckpt_dir)["extra"]["total_steps"]
            if saved_total != cfg.steps:
                raise ValueError(f"checkpoint horizon {saved_total}, run "
                                 f"horizon {cfg.steps}")
            _, step0 = load_checkpoint(ckpt_dir, train_state_tree(state))
        kill = next((k for k in kills if k > step0), None)
        stop = cfg.steps if kill is None else kill
        for t in range(step0, stop):
            loss = float(_one_step(h, state, t)["loss"])
            if t in losses:
                replayed += 1
                replay_mismatch = max(replay_mismatch,
                                      abs(loss - losses[t]))
            else:
                losses[t] = loss
            if (t + 1) % cfg.ckpt_every == 0 and (t + 1) < stop:
                save_checkpoint(ckpt_dir, t + 1, train_state_tree(state),
                                extra=extra)
        if kill is None:
            save_checkpoint(ckpt_dir, cfg.steps, train_state_tree(state),
                            extra=extra)
            return {"losses": losses, "replayed": replayed,
                    "replay_mismatch": replay_mismatch, "rounds": rounds,
                    "kills": fired}
        # the kill: in-memory state dies here; the torn dir left behind is
        # what a SIGKILL mid-save produces
        fired.append(kill)
        kills = [k for k in kills if k != kill]
        _write_torn_checkpoint(ckpt_dir, stop, train_state_tree(state))
        del state


def verify_elastic(h: Harness, ckpt_dir: str, kill_at: tuple[int, ...],
                   tol: float = 1e-6) -> dict:
    """Run reference + elastic and compare trajectories.

    Returns the elastic result dict extended with ``max_diff`` and ``ok``.
    """
    ref = run_reference(h)
    out = run_elastic(h, ckpt_dir, kill_at)
    diffs = [abs(out["losses"][t] - ref[t]) for t in range(h.cfg.steps)]
    out["max_diff"] = max(diffs)
    out["ok"] = (out["max_diff"] <= tol
                 and out["replay_mismatch"] <= tol
                 and len(out["losses"]) == h.cfg.steps)
    return out


def _parse_fault_args(pairs):
    kw = {}
    for p in pairs or ():
        k, _, v = p.partition("=")
        kw[k] = int(v)
    return kw


def main(argv=None) -> dict:
    """Run the CLI; returns the result dict (``--verify``: exit code 1 when
    the trajectories disagree)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--workers", type=int, default=6)
    ap.add_argument("--per-worker-batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=32)
    ap.add_argument("--aggregator", default="flag")
    ap.add_argument("--attack", default="none")
    ap.add_argument("--byzantine", type=int, default=0)
    ap.add_argument("--codec", default="none", choices=("none",) + CODECS)
    ap.add_argument("--no-ef", action="store_true")
    ap.add_argument("--faults", default="none", choices=sorted(FAULTS))
    ap.add_argument("--fault-arg", action="append", metavar="K=V",
                    help="fault scenario int kwarg, repeatable "
                         "(e.g. --fault-arg at=4 --fault-arg n=2)")
    ap.add_argument("--lam", type=float, default=0.0)
    ap.add_argument("--ckpt-every", type=int, default=3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_elastic_ckpt"))
    ap.add_argument("--kill-at", default="5,9",
                    help="comma-separated steps at which the process dies")
    ap.add_argument("--verify", action="store_true",
                    help="compare against the uninterrupted run; exit "
                         "nonzero on trajectory mismatch")
    ap.add_argument("--tol", type=float, default=1e-6)
    ap.add_argument("--json-out", default="")
    args = ap.parse_args(argv)

    cfg = ElasticConfig(
        arch=args.arch, steps=args.steps, workers=args.workers,
        per_worker_batch=args.per_worker_batch, seq=args.seq,
        aggregator=args.aggregator, attack=args.attack,
        byzantine=args.byzantine, codec=args.codec,
        error_feedback=False if args.no_ef else None,
        faults=args.faults, faults_kw=_parse_fault_args(args.fault_arg),
        lam=args.lam, ckpt_every=args.ckpt_every, device=args.device)
    kill_at = tuple(int(k) for k in args.kill_at.split(",") if k)

    print(f"elastic: arch={cfg.arch} W={cfg.workers} agg={cfg.aggregator} "
          f"attack={cfg.attack}(f={cfg.byzantine}) codec={cfg.codec} "
          f"faults={cfg.faults} steps={cfg.steps} kill_at={kill_at} "
          f"device={cfg.device}")
    t0 = time.time()
    h = build_harness(cfg)
    if args.verify:
        out = verify_elastic(h, args.ckpt_dir, kill_at, tol=args.tol)
        print(f"rounds={out['rounds']} kills={out['kills']} "
              f"replayed={out['replayed']} steps "
              f"(replay mismatch {out['replay_mismatch']:.2e}) "
              f"max |loss diff| vs uninterrupted = {out['max_diff']:.2e} "
              f"({time.time() - t0:.0f}s)")
        print("VERIFY:", "OK" if out["ok"] else "FAILED")
    else:
        out = run_elastic(h, args.ckpt_dir, kill_at)
        print(f"rounds={out['rounds']} kills={out['kills']} "
              f"replayed={out['replayed']} final loss "
              f"{out['losses'][cfg.steps - 1]:.4f} "
              f"({time.time() - t0:.0f}s)")
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump({k: v for k, v in out.items() if k != "losses"}
                      | {"losses": {str(t): l
                                    for t, l in sorted(out["losses"].items())}},
                      f, indent=1)
    if args.verify and not out["ok"]:
        raise SystemExit(1)
    return out


if __name__ == "__main__":
    main()
