"""Training launcher of the port: the Byzantine-robust train step on one card.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m \\
        --workers 15 --byzantine 3 --attack sign_flip --aggregator flag \\
        --steps 4

Without ``--debug`` it trains the full configuration; ``--debug`` trains
the reduced variant (``reduce_for_smoke``, its frontend removed: the
synthetic data has no prefix).  It runs on ``cuda`` unless
``--device cpu`` is given, and raises when no card is present and the CPU
was not asked for.  The flags are those of ``repro.launch.train``, plus
``--device`` and ``--seed``.
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

``--sharded-agg`` shards the aggregation over ranks of
``torch.distributed`` (``repro_torch.dist.sharded``): each rank holds its
coordinate shard of the gradient stack, the (W, W) Gram meets in one
``all_reduce``, and no rank holds the (W, N) buffer.  It runs with every
``--codec``, with error feedback or ``--no-ef``: each rank encodes and
decodes its own columns (the codec's cross-rank step is a collective) and
keeps its (W, width) shard of the EF memory, which ``--ckpt-dir`` saves
as the whole leaves (gathered to rank 0 one row of a leaf at a time), in
the file a one-device run writes, and every rank loads its columns of on
resume.  The mesh is the
host mesh over the whole world (``launch.mesh.make_host_mesh``).  Under
``torchrun`` the process group comes from its environment; without it
the run is a world of one rank (the JAX launcher's ``--debug`` mesh over
the local devices, one on a plain host).  The backend follows the
layout and is never switched on failure: NCCL where each rank has a card
of its own (``LOCAL_WORLD_SIZE`` <= the cards), gloo where ranks share one
card or run on the CPU.  Rank r uses ``cuda:{LOCAL_RANK % cards}``; rank
0 alone prints and writes checkpoints (under tensor parallelism the ranks
of its ``model`` group gather their blocks to it), every rank loads them.  The group is destroyed when the run ends.  On the CPU:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --debug --device cpu --sharded-agg --workers 8 --steps 4
    PYTHONPATH=src torchrun --nproc-per-node 2 -m repro_torch.launch.train \\
        --debug --device cpu --sharded-agg --workers 8 --codec topk --steps 4

Where the host mesh has a ``model`` axis (a world of 4 ranks: (data 2,
model 2); of 8: (2, 4)), the model trains tensor-parallel over it
(``repro_torch.dist.tensor_parallel``): each rank holds its blocks of the
weights the JAX package's rules split over ``model`` and of their AdamW
moments, the ranks of a ``model`` group compute their
workers together, and a checkpoint holds the whole leaves (gathered to
rank 0 a leaf at a time; every rank loads its blocks).  Every
configuration trains so: the dense transformer, the MoE banks (a block
of ``d_e`` of every expert under the default rules), the recurrent
blocks' state widths and heads, a frontend's replicated projector.  The
first line says ``tp=model:M`` and which leaves split (``tp=replicated``
where the rules split nothing).  A caller that activates other rules on
the same mesh (``use_sharding(mesh, rules)``, e.g. the expert-parallel
``{"experts": "model", "expert_mlp": None}``) around :func:`main` trains
under them.  On the CPU:

    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --debug --device cpu --sharded-agg --workers 4 --steps 2
    PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
        --arch xlstm-1.3b --debug --device cpu --sharded-agg --workers 4 \\
        --steps 2 --seq 32

``--multi-pod`` (without ``--debug``, as the JAX launcher's) builds the
production mesh (pod 2, data 16, model 16) and takes W = 32 from it; on a
world of another size than 512 ranks it raises the mesh's ``ValueError``
before any weight is drawn.  Without it the port trains on the ranks it
is given, where the JAX launcher builds its 256-device production mesh.
The ``train_sharded`` phase of ``chip_smoke.py`` runs the sharded path at
full width on 1, 2 and 3 ranks of one card, at R = 2 also under signSGD
(EF), top-k (EF) and CountSketch decoded.
"""

from __future__ import annotations

import argparse
import os
import time
from contextlib import contextmanager, nullcontext
from types import SimpleNamespace

import torch
import torch.distributed as dist

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
from repro_torch.dist.sharding import (current_mesh, current_rules,
                                       use_sharding)
from repro_torch.dist.train_step import (TrainConfig, build_train_step,
                                         check_train_config,
                                         init_train_state, train_state_tree)
from repro_torch.launch.mesh import (make_host_mesh, make_production_mesh,
                                     worker_count)
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
    ap.add_argument("--multi-pod", action="store_true",
                    help="the (pod 2, data 16, model 16) production mesh; "
                         "needs 512 ranks; W = 32 (ignored with --debug)")
    ap.add_argument("--sharded-agg", action="store_true",
                    help="coordinate-sharded aggregation over the ranks "
                         "(repro_torch.dist.sharded): partial-Gram "
                         "all_reduce, no (W, N) buffer on any rank, every "
                         "--codec with or without --no-ef (the EF memory "
                         "sharded too); a world of one rank outside "
                         "torchrun")
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


def _wants_world(args) -> bool:
    return args.sharded_agg or (args.multi_pod and not args.debug)


def _device(args) -> torch.device:
    """The run's device: ``cuda:{LOCAL_RANK % cards}`` for a rank of a
    sharded run on the card, else ``--device``."""
    device = resolve_device(args.device)
    if device.type == "cuda" and _wants_world(args):
        local = int(os.environ.get("LOCAL_RANK", 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def is_rank0() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


@contextmanager
def open_world(args):
    """The process group of a ``--sharded-agg`` / ``--multi-pod`` run
    (module docstring), destroyed on exit; nothing for another run, or
    when the caller already made one."""
    if not _wants_world(args) or dist.is_initialized():
        yield
        return
    device = _device(args)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    env = all(k in os.environ for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR",
                                        "MASTER_PORT"))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE",
                                     os.environ.get("WORLD_SIZE", "1"))
                      ) if env else 1
    backend = ("nccl" if device.type == "cuda"
               and local_world <= torch.cuda.device_count() else "gloo")
    if env:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def setup(args, faults_kw=None):
    """Everything a run needs from the parsed flags: a namespace with
    ``device``, ``cfg``, ``tc``, ``opt``, ``sched``, ``step_fn``,
    ``state``, ``task``, ``wdc``, ``lam``, and ``step0`` / ``total``, the
    steps the run takes (``step0 > 0`` and ``total`` the checkpoint's
    horizon when it resumes from ``--ckpt-dir``; ``load_s`` is then the
    restore's wall time) and ``mesh``, the sharded run's mesh or ``None``.
    ``faults_kw`` are keyword arguments of the ``--faults`` schedule (its
    defaults otherwise).  A ``--sharded-agg`` / ``--multi-pod`` run calls
    it inside :func:`open_world`."""
    device = _device(args)
    cfg = get_config(args.arch)
    if args.debug:
        # the launcher's data has no prefix: the frontend goes, as JAX's
        cfg = reduce_for_smoke(cfg).replace(frontend=None,
                                            num_prefix_embeds=0)
    W, mesh, rules = args.workers, None, None
    if _wants_world(args):
        if not dist.is_initialized():
            raise ValueError("--sharded-agg / --multi-pod: call setup() "
                             "inside open_world(args)")
        mesh = (make_production_mesh(multi_pod=True)
                if args.multi_pod and not args.debug else make_host_mesh())
        if args.multi_pod and not args.debug:
            W = worker_count(mesh)
        if current_mesh() == mesh:        # the caller's rules carry through
            rules = current_rules()
    lam = args.lam if args.lam >= 0 else (float(W) if W > 6 else 0.0)
    comm = CommConfig(codec=args.codec,
                      error_feedback=False if args.no_ef else None)
    tc = TrainConfig(
        aggregator=AggregatorConfig(
            name=args.aggregator, f=args.byzantine,
            flag=FlagConfig(lam=lam,
                            regularizer="pairwise" if lam else "none")),
        attack=args.attack, attack_f=args.byzantine, comm=comm,
        faults=get_fault_schedule(args.faults, W, **(faults_kw or {})),
        sharded_agg=args.sharded_agg)
    check_train_config(tc)
    opt = adamw() if args.optimizer == "adamw" else sgd(momentum=0.9)
    state = init_train_state(cfg, opt, seed=args.seed, device=device,
                             comm=comm, workers=W,
                             sharded=mesh if args.sharded_agg else None)
    total, step0, load_s = args.steps, 0, None
    last = latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if last is not None:
        # the LR horizon belongs to the run, not to this invocation: the
        # schedule is rebuilt on the persisted total, or a resumed run
        # would re-warm and re-decay on the leftover step count
        meta = checkpoint_meta(args.ckpt_dir, step=last)
        saved_total = meta["extra"].get("total_steps")
        if saved_total is not None and saved_total != total:
            if is_rank0():
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
        if is_rank0():
            print(f"resumed from step {step0}", flush=True)
    sched = warmup_cosine(args.lr, total, warmup=min(20, total // 5))
    return SimpleNamespace(
        device=device, cfg=cfg, lam=lam, tc=tc, opt=opt, sched=sched,
        step_fn=build_train_step(cfg, tc, opt, sched), state=state,
        step0=step0, total=total, load_s=load_s, mesh=mesh, rules=rules,
        task=SyntheticLM(vocab_size=cfg.vocab_size),
        wdc=WorkerDataConfig(workers=W,
                             per_worker_batch=args.per_worker_batch))


def run_steps(args, run, on_step=None):
    """The training loop from ``run.step0`` to ``run.total``; returns one
    dict of host numbers per step (``step``, ``loss``, ``lr``,
    ``grad_global_norm``, ``fa_weights``, ``comm_bits``, ``comm_ratio``,
    ``active_workers`` under faults, ``moe_aux`` and ``moe_z`` (the
    router losses, mean over the workers) for an MoE config, ``step_s``,
    the step's wall time up to a device synchronisation, and ``save_s``,
    the wall time of the checkpoint written after the step, where one
    was).  With
    ``--ckpt-dir`` it saves after every ``--ckpt-every``-th step and after
    the last (rank 0 writes in a sharded run; every rank takes part in
    gathering a sharded EF memory).  ``on_step(t, state,
    metrics)`` is called after each step (read-only).  A sharded run's
    steps run under its mesh (``use_sharding``) and the rules that were
    active on it at :func:`setup`, else the defaults."""
    with use_sharding(run.mesh, run.rules) if run.mesh is not None \
            else nullcontext():
        return _run_steps(args, run, on_step)


def _run_steps(args, run, on_step):
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
        for k in ("moe_aux", "moe_z"):          # an MoE config's router
            if k in m:
                rec[k] = float(m[k])
        if args.ckpt_dir and ((t + 1) % args.ckpt_every == 0
                              or t + 1 == total):
            ts = time.perf_counter()
            save_checkpoint(args.ckpt_dir, t + 1, train_state_tree(state),
                            extra={"total_steps": total}, write=is_rank0())
            rec["save_s"] = time.perf_counter() - ts
        history.append(rec)
        if on_step is not None:
            on_step(t, state, m)
        if is_rank0() and (t % args.log_every == 0 or t == total - 1):
            act = (f" act {rec['active_workers']}/{run.wdc.workers}"
                   if "active_workers" in rec else "")
            print(f"step {t:5d} loss {rec['loss']:.4f} lr {rec['lr']:.2e} "
                  f"|g| {rec['grad_global_norm']:.3f}{act} "
                  f"({time.perf_counter() - t0:.0f}s)", flush=True)
    return history


def _tp_note(run) -> str:
    """The first line's layout: `` tp=model:M split=<leaves>`` where the
    model is tensor-parallel, `` tp=replicated`` on a mesh with a
    ``model`` axis where the rules split nothing, else nothing; then
    `` zero1=data:D`` where the moments are cut over ``data``."""
    tp, z = run.state.tp, run.state.zero1
    note = "" if z is None else f" zero1=data:{z.parts}"
    if tp is not None:
        leaves = ",".join(".".join(str(p) for p in path)
                          for path, d in zip(tp.full.paths, tp.dims)
                          if d is not None)
        return f" tp=model:{tp.parts} split={leaves}{note}"
    if run.mesh.shape.get("model", 1) > 1 and run.tc.sharded_agg:
        return " tp=replicated" + note
    return note


def main(argv=None, on_step=None):
    """Train; returns :func:`run_steps`' history (``on_step`` as there)."""
    args = _parser().parse_args(argv)
    with open_world(args):
        run = setup(args)
        if is_rank0():
            world = (f" sharded_agg ranks={run.mesh.size} "
                     f"mesh={run.mesh.shape} backend={dist.get_backend()}"
                     f"{_tp_note(run)}" if run.mesh is not None else "")
            print(f"arch={run.cfg.name} "
                  f"params={run.state.full_layout.numel / 1e6:.1f}M "
                  f"workers={run.wdc.workers} "
                  f"agg={args.aggregator}(lam={run.lam}) "
                  f"attack={args.attack} f={args.byzantine} "
                  f"codec={args.codec} ef={run.tc.comm.wants_ef} "
                  f"faults={args.faults} device={run.device}{world} "
                  f"steps {run.step0}->{run.total}", flush=True)
        return run_steps(args, run, on_step)


if __name__ == "__main__":
    main()
