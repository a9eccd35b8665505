"""Training launcher of the port: the Byzantine-robust train step on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --workers 15 --byzantine 3 --attack sign_flip --aggregator flag \\
        --steps 4

Without ``--debug`` it trains the full configuration; ``--debug`` trains
the reduced variant (``reduce_for_smoke``).  It runs on ``cuda`` unless
``--device cpu`` is given, and raises when no card is present and the CPU
was not asked for.  The flags are those of ``repro.launch.train`` minus
the mesh flags, plus ``--device`` and ``--seed``.
``--aggregator`` takes every rule of the JAX CLI (``flag``, ``pca``,
``mean``, ``geomed``, ``krum``, ``multi_krum``, ``median``,
``trimmed_mean``, ``meamed``, ``phocas``, ``bulyan``); an unknown name
raises ``KeyError`` listing them before the first step.  ``--codec``
(``none``, ``identity``, ``signsgd``, ``topk``, ``countsketch``) compresses
the workers' messages, with error feedback for the biased codecs unless
``--no-ef``; ``--faults`` (``none``, ``crash``, ``rejoin``, ``churn``,
``straggle``) takes workers in and out of the rounds.

``--ckpt-dir`` saves the whole state (parameters, optimizer moments, the
EF memory) every ``--ckpt-every`` steps and at the end, in the JAX
package's checkpoint format (``repro_torch.checkpoint``), and a run
started on a directory that holds a complete checkpoint resumes from its
newest one and prints ``resumed from step k``.  ``--steps`` is the
*total* horizon: a resumed run reads the horizon from the checkpoint and
rebuilds the LR schedule on it, so it completes the original run, and its
steps equal the uninterrupted run's.  A resume whose ``--codec`` /
``--no-ef`` differ from the run that wrote the checkpoint (the EF memory
is part of the state) stops with ``SystemExit``.  On the CPU:

    PYTHONPATH=src python -m repro_torch.launch.train --debug --device cpu \\
        --ckpt-dir /tmp/c --ckpt-every 2 --steps 4

prints a line per step (``--log-every``); run it a second time and it
prints ``resumed from step 4`` and no step: the run is complete.  Remove
``step_00000004`` first and it resumes from step 2 and prints steps 2
and 3, as the first run printed them.  The kill-and-resume driver that
checks this bit for bit is ``repro_torch.launch.elastic``; it prints
``VERIFY: OK`` when the resumed trajectory equals the uninterrupted one:

    PYTHONPATH=src python -m repro_torch.launch.elastic --device cpu \\
        --verify --steps 12 --kill-at 5,9 --ckpt-every 3 --codec signsgd

On the card, the ``resume`` phase of ``chip_smoke.py`` checkpoints and
resumes the full-width flag run and runs the elastic driver.
"""

from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

import torch

from repro_torch.checkpoint import (checkpoint_meta, latest_step,
                                    leaf_keys, load_checkpoint,
                                    save_checkpoint)
from repro_torch.comm import CODECS, CommConfig
from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.flag import FlagConfig
from repro_torch.data import SyntheticLM, WorkerDataConfig, lm_worker_batches
from repro_torch.device import resolve_device
from repro_torch.dist.aggregation import AggregatorConfig
from repro_torch.dist.membership import FAULTS, get_fault_schedule
from repro_torch.dist.train_step import (TrainConfig, build_train_step,
                                         init_train_state, train_state_tree)
from repro_torch.optim import adamw, sgd, warmup_cosine


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--debug", action="store_true",
                    help="reduced config (2 layers, d_model 256, fp32)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random initial weights")
    ap.add_argument("--steps", type=int, default=100,
                    help="TOTAL training horizon (a resume completes it)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--per-worker-batch", type=int, default=4)
    ap.add_argument("--aggregator", default="flag")
    ap.add_argument("--attack", default="none")
    ap.add_argument("--byzantine", type=int, default=0)
    ap.add_argument("--codec", default="none", choices=("none",) + CODECS,
                    help="worker->server codec (repro_torch.comm)")
    ap.add_argument("--no-ef", action="store_true",
                    help="disable error feedback for biased codecs")
    ap.add_argument("--faults", default="none", choices=sorted(FAULTS),
                    help="worker-churn scenario (repro_torch.dist.membership)")
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd"])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--lam", type=float, default=-1.0,
                    help="FA lambda (-1 = auto: p if p>6 else 0)")
    ap.add_argument("--ckpt-dir", default="",
                    help="save here, and resume from the newest complete "
                         "checkpoint here")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def setup(args, faults_kw=None):
    """Everything a run needs from the parsed flags: a namespace with
    ``device``, ``cfg``, ``tc``, ``opt``, ``sched``, ``step_fn``,
    ``state``, ``task``, ``wdc``, ``lam``, and ``step0`` / ``total``, the
    steps the run takes (``step0 > 0`` and ``total`` the checkpoint's
    horizon when it resumes from ``--ckpt-dir``; ``load_s`` is then the
    restore's wall time).  ``faults_kw`` are keyword arguments of the
    ``--faults`` schedule (its defaults otherwise)."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.debug:
        cfg = reduce_for_smoke(cfg)
    W = args.workers
    lam = args.lam if args.lam >= 0 else (float(W) if W > 6 else 0.0)
    comm = CommConfig(codec=args.codec,
                      error_feedback=False if args.no_ef else None)
    tc = TrainConfig(
        aggregator=AggregatorConfig(
            name=args.aggregator, f=args.byzantine,
            flag=FlagConfig(lam=lam,
                            regularizer="pairwise" if lam else "none")),
        attack=args.attack, attack_f=args.byzantine, comm=comm,
        faults=get_fault_schedule(args.faults, W, **(faults_kw or {})))
    opt = adamw() if args.optimizer == "adamw" else sgd(momentum=0.9)
    state = init_train_state(cfg, opt, seed=args.seed, device=device,
                             comm=comm, workers=W)
    total, step0, load_s = args.steps, 0, None
    last = latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if last is not None:
        # the LR horizon belongs to the run, not to this invocation: the
        # schedule is rebuilt on the persisted total, or a resumed run
        # would re-warm and re-decay on the leftover step count
        meta = checkpoint_meta(args.ckpt_dir, step=last)
        saved_total = meta["extra"].get("total_steps")
        if saved_total is not None and saved_total != total:
            print("resume: using checkpointed horizon total_steps="
                  f"{saved_total} (ignoring --steps {total})")
            total = saved_total
        tree = train_state_tree(state)
        want = leaf_keys(tree)
        if meta["keys"] != want:
            raise SystemExit(
                "resume state mismatch: the checkpoint holds "
                f"{len(meta['keys'])} leaves but this invocation expects "
                f"{len(want)} — most likely the --codec/--no-ef flags "
                "differ from the run that wrote the checkpoint (the EF "
                "memory is part of the checkpointed state); rerun with "
                "the original flags or start a fresh --ckpt-dir")
        t0 = time.perf_counter()
        _, step0 = load_checkpoint(args.ckpt_dir, tree, step=last)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        load_s = time.perf_counter() - t0
        print(f"resumed from step {step0}", flush=True)
    sched = warmup_cosine(args.lr, total, warmup=min(20, total // 5))
    return SimpleNamespace(
        device=device, cfg=cfg, lam=lam, tc=tc, opt=opt, sched=sched,
        step_fn=build_train_step(cfg, tc, opt, sched), state=state,
        step0=step0, total=total, load_s=load_s,
        task=SyntheticLM(vocab_size=cfg.vocab_size),
        wdc=WorkerDataConfig(workers=W,
                             per_worker_batch=args.per_worker_batch))


def run_steps(args, run, on_step=None):
    """The training loop from ``run.step0`` to ``run.total``; returns one
    dict of host numbers per step (``step``, ``loss``, ``lr``,
    ``grad_global_norm``, ``fa_weights``, ``comm_bits``, ``comm_ratio``,
    ``active_workers`` under faults, ``step_s``, the step's wall time up to
    a device synchronisation, and ``save_s``, the wall time of the
    checkpoint written after the step, where one was).  With
    ``--ckpt-dir`` it saves after every ``--ckpt-every``-th step and after
    the last.  ``on_step(t, state, metrics)`` is called after each step
    (read-only)."""
    device, state, total = run.device, run.state, run.total
    history = []
    t0 = time.perf_counter()
    for t in range(run.step0, total):
        ts = time.perf_counter()
        batch = lm_worker_batches(run.task, run.wdc, t, args.seq,
                                  device=device)
        m = run.step_fn(state, batch, t)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rec = {"step": t, "loss": float(m["loss"]), "lr": float(m["lr"]),
               "grad_global_norm": float(m["grad_global_norm"]),
               "fa_weights": m["fa_weights"].tolist(),
               "comm_bits": float(m["comm_bits"]),
               "comm_ratio": float(m["comm_ratio"]),
               "step_s": time.perf_counter() - ts}
        if "active_workers" in m:
            rec["active_workers"] = int(m["active_workers"])
        if args.ckpt_dir and ((t + 1) % args.ckpt_every == 0
                              or t + 1 == total):
            ts = time.perf_counter()
            save_checkpoint(args.ckpt_dir, t + 1, train_state_tree(state),
                            extra={"total_steps": total})
            rec["save_s"] = time.perf_counter() - ts
        history.append(rec)
        if on_step is not None:
            on_step(t, state, m)
        if t % args.log_every == 0 or t == total - 1:
            act = (f" act {rec['active_workers']}/{args.workers}"
                   if "active_workers" in rec else "")
            print(f"step {t:5d} loss {rec['loss']:.4f} lr {rec['lr']:.2e} "
                  f"|g| {rec['grad_global_norm']:.3f}{act} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    return history


def main(argv=None, on_step=None):
    """Train; returns :func:`run_steps`' history (``on_step`` as there)."""
    args = _parser().parse_args(argv)
    run = setup(args)
    print(f"arch={run.cfg.name} params={run.state.layout.numel / 1e6:.1f}M "
          f"workers={args.workers} agg={args.aggregator}(lam={run.lam}) "
          f"attack={args.attack} f={args.byzantine} codec={args.codec} "
          f"ef={run.tc.comm.wants_ef} faults={args.faults} "
          f"device={run.device} steps {run.step0}->{run.total}", flush=True)
    return run_steps(args, run, on_step)


if __name__ == "__main__":
    main()
