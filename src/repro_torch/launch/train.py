"""Training launcher of the port: the Flag-Aggregator train step on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --workers 15 --byzantine 3 --attack sign_flip --aggregator flag \\
        --steps 4

Without ``--debug`` it trains the full configuration; ``--debug`` trains
the reduced variant (``reduce_for_smoke``).  It runs on ``cuda`` unless
``--device cpu`` is given, and raises when no card is present and the CPU
was not asked for.  The flags are those of ``repro.launch.train`` minus
the mesh and checkpoint flags, plus ``--device`` and ``--seed``.
"""

from __future__ import annotations

import argparse
import time
from types import SimpleNamespace

import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.core.flag import FlagConfig
from repro_torch.data import SyntheticLM, WorkerDataConfig, lm_worker_batches
from repro_torch.device import resolve_device
from repro_torch.dist.aggregation import AggregatorConfig
from repro_torch.dist.train_step import (TrainConfig, build_train_step,
                                         init_train_state)
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
                    help="total training horizon")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--per-worker-batch", type=int, default=4)
    ap.add_argument("--aggregator", default="flag")
    ap.add_argument("--attack", default="none")
    ap.add_argument("--byzantine", type=int, default=0)
    ap.add_argument("--codec", default="none",
                    help="worker->server codec (only 'none' in this port)")
    ap.add_argument("--faults", default="none",
                    help="worker-churn scenario (only 'none' in this port)")
    ap.add_argument("--optimizer", default="adamw", choices=["adamw", "sgd"])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--lam", type=float, default=-1.0,
                    help="FA lambda (-1 = auto: p if p>6 else 0)")
    ap.add_argument("--log-every", type=int, default=10)
    return ap


def setup(args):
    """Everything a run needs from the parsed flags: a namespace with
    ``device``, ``cfg``, ``step_fn``, ``state``, ``task``, ``wdc``, ``lam``."""
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.debug:
        cfg = reduce_for_smoke(cfg)
    W = args.workers
    lam = args.lam if args.lam >= 0 else (float(W) if W > 6 else 0.0)
    tc = TrainConfig(
        aggregator=AggregatorConfig(
            name=args.aggregator, f=args.byzantine,
            flag=FlagConfig(lam=lam,
                            regularizer="pairwise" if lam else "none")),
        attack=args.attack, attack_f=args.byzantine, codec=args.codec,
        faults=args.faults)
    opt = adamw() if args.optimizer == "adamw" else sgd(momentum=0.9)
    sched = warmup_cosine(args.lr, args.steps,
                          warmup=min(20, args.steps // 5))
    return SimpleNamespace(
        device=device, cfg=cfg, lam=lam,
        step_fn=build_train_step(cfg, tc, opt, sched),
        state=init_train_state(cfg, opt, seed=args.seed, device=device),
        task=SyntheticLM(vocab_size=cfg.vocab_size),
        wdc=WorkerDataConfig(workers=W,
                             per_worker_batch=args.per_worker_batch))


def main(argv=None):
    """Train; returns one dict of host numbers per step (``loss``, ``lr``,
    ``grad_global_norm``, ``fa_weights``, ``step_s`` -- the step's wall time
    up to a device synchronisation)."""
    args = _parser().parse_args(argv)
    run = setup(args)
    device, cfg, state, total = run.device, run.cfg, run.state, args.steps
    W, lam = args.workers, run.lam

    print(f"arch={cfg.name} params={state.layout.numel / 1e6:.1f}M "
          f"workers={W} agg={args.aggregator}(lam={lam}) "
          f"attack={args.attack} f={args.byzantine} device={device} "
          f"steps 0->{total}", flush=True)
    history = []
    t0 = time.perf_counter()
    for t in range(total):
        ts = time.perf_counter()
        batch = lm_worker_batches(run.task, run.wdc, t, args.seq,
                                  device=device)
        m = run.step_fn(state, batch, t)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        rec = {"loss": float(m["loss"]), "lr": float(m["lr"]),
               "grad_global_norm": float(m["grad_global_norm"]),
               "fa_weights": m["fa_weights"].tolist(),
               "step_s": time.perf_counter() - ts}
        history.append(rec)
        if t % args.log_every == 0 or t == total - 1:
            print(f"step {t:5d} loss {rec['loss']:.4f} lr {rec['lr']:.2e} "
                  f"|g| {rec['grad_global_norm']:.3f} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    return history


if __name__ == "__main__":
    main()
