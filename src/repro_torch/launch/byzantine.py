"""The paper's CNN training loop under Byzantine workers, on one card.

    PYTHONPATH=src python -m repro_torch.launch.byzantine --p 15 --f 3 \\
        --aggregator flag --attack random --steps 60

Port of ``benchmarks/common.py``'s ``ByzRunConfig`` and
``run_byzantine_training``, the driver behind every accuracy figure of the
paper.  One step:

  1. every worker's batch is drawn on a CPU generator seeded by
     (seed, step) and moved to the device, so the card and the CPU see the
     same data;
  2. the honest workers f <= w < f + augment_workers augment theirs (as
     ``benchmarks/common.py`` picks them, which is not the pipeline's
     first-k rule), the noise drawn from the same generator;
  3. one ``torch.func.vmap(torch.func.grad(...))`` call gives the (p, N)
     fp32 per-worker gradient matrix, coordinates in the JAX flat order
     (sorted keys: b1, b2, b3, b4, c1, c2, f1, f2; N = 67,642);
  4. the attack rewrites the first f rows in place (seeded by the step);
  5. without a codec, the flat rule of :mod:`repro_torch.core.aggregators`
     gives d: FA-N (``FlagConfig(lam=p, norm_mode="clip",
     renormalize=True)``) for ``flag``, ``f`` for every other rule; with
     a codec (``signsgd``, ``topk``, ``countsketch``, ``identity``; the
     rows of ``benchmarks/comm_loss.py``), d comes from
     :func:`repro_torch.dist.aggregation.compressed_aggregate` with
     ``AggregatorConfig(name, f, flag=FA-N)`` over the per-leaf layout,
     the EF memory (p, N) carried across steps;
  6. momentum SGD, ``mom = mu mom + d; theta -= lr mom``, with the lr
     decayed by ``lr_decay ** (t // lr_decay_every)``;
  7. every ``eval_every`` steps (and after the last) the accuracy on
     ``test_set(1024)``.

Without a codec the rules are plain PyTorch on either device, as the
reference's flat rules are plain ``jnp``: the loop launches none of the
port's kernels.  With a codec it goes through ``aggregate_tree``'s Gram
path as the reference does, so on the card it launches the port's
kernels (tree Gram, combine, and the rule's selection).
``comm_bits_per_step`` and ``comm_ratio`` come from the codec's cost
model.  It runs on ``cuda`` unless ``--device cpu`` is given and raises
without a card.  The CLI has a flag per config field (dict fields take
JSON) and prints one JSON result line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time
from dataclasses import dataclass, field

import torch

from repro_torch.comm import CommConfig, dense_bits, get_codec, init_ef
from repro_torch.core import aggregators
from repro_torch.core.attacks import apply_attack
from repro_torch.core.flag import FlagConfig
from repro_torch.data import augment as augment_lib
from repro_torch.data.pipeline import step_generator
from repro_torch.data.synthetic import SyntheticImages
from repro_torch.device import resolve_device
from repro_torch.dist.aggregation import (AggregatorConfig,
                                          compressed_aggregate)
from repro_torch.models.cnn import cnn_init, cnn_logits, cnn_loss
from repro_torch.weights import Layout, pack, unflatten

__all__ = ["ByzRunConfig", "aggregator_for", "worker_gradients",
           "byzantine_step", "run_byzantine_training", "main"]


@dataclass
class ByzRunConfig:
    p: int = 15                        # workers (paper's main setting)
    f: int = 3                         # Byzantine workers
    batch: int = 16                    # per worker (the paper uses 128)
    steps: int = 60
    lr: float = 0.05
    momentum: float = 0.9
    lr_decay: float = 0.2
    lr_decay_every: int = 40
    attack: str = "random"
    attack_kw: dict = field(default_factory=dict)
    aggregator: str = "flag"
    agg_kw: dict = field(default_factory=dict)
    flag_cfg: FlagConfig | None = None
    codec: str = "none"                # worker->server codec (comm/)
    codec_kw: dict = field(default_factory=dict)
    augment_scheme: str = "none"       # honest-worker augmentation
    augment_workers: int = 0
    gaussian_sigma: float = 0.0
    seed: int = 0
    eval_every: int = 20


def aggregator_for(cfg: ByzRunConfig):
    """(rule, its keyword arguments).  Without a codec: the flat rule,
    FA-N unless ``flag_cfg`` is given for ``flag``, ``f`` for the others,
    ``agg_kw`` overriding.  With a codec: ``compressed_aggregate`` with
    the rule's ``AggregatorConfig`` (FA-N for ``flag``), the
    ``CommConfig`` (``codec_kw`` its other fields) and one codec instance
    kept across steps."""
    flag_cfg = cfg.flag_cfg or FlagConfig(lam=float(cfg.p), norm_mode="clip",
                                          renormalize=True)
    if cfg.codec != "none":
        comm = CommConfig(codec=cfg.codec, **cfg.codec_kw)
        return compressed_aggregate, {
            "cfg": AggregatorConfig(name=cfg.aggregator, f=cfg.f,
                                    flag=flag_cfg),
            "comm": comm, "codec": get_codec(comm)}
    fn = aggregators.get_aggregator(cfg.aggregator)
    kw = dict(cfg.agg_kw)
    if cfg.aggregator == "flag":
        kw.setdefault("cfg", flag_cfg)
    else:
        kw.setdefault("f", cfg.f)
    return fn, kw


def worker_gradients(theta: torch.Tensor, layout: Layout, xs: torch.Tensor,
                     ys: torch.Tensor) -> torch.Tensor:
    """(p, N) fp32: row w is the gradient of worker w's loss on
    (xs[w], ys[w]) at the flat parameters ``theta``, in one vmapped call."""
    def loss(th, x, y):
        return cnn_loss(unflatten(th, layout), x, y)
    return torch.func.vmap(torch.func.grad(loss), in_dims=(None, 0, 0))(
        theta, xs, ys)


def byzantine_step(theta: torch.Tensor, mom: torch.Tensor, layout: Layout,
                   xs: torch.Tensor, ys: torch.Tensor, *, cfg: ByzRunConfig,
                   step: int, lr: float, rule=None,
                   ef: torch.Tensor | None = None):
    """Steps 3-6 of the module note on one batch: updates ``theta`` and
    ``mom`` in place (and the EF memory ``ef``, under a codec that carries
    one) and returns the gradient matrix G (p, N) and the update d (N,).
    G is the attacked gradients, or under a codec that decodes, the
    decoded estimates.  ``rule``: ``aggregator_for(cfg)``, built once."""
    fn, kw = rule or aggregator_for(cfg)
    G = worker_gradients(theta, layout, xs, ys)
    apply_attack(cfg.attack, G, cfg.f, seed=step, **cfg.attack_kw)
    if cfg.codec == "none":
        d = fn(G, **kw)
    else:
        d, _, _ = fn(G, ef=ef, layout=layout, **kw)
    mom.mul_(cfg.momentum).add_(d)
    theta.sub_(lr * mom)
    return G, d


def _augment(gen, xs, cfg: ByzRunConfig):
    """Honest workers f .. f + augment_workers - 1 augment their images."""
    lo, hi = cfg.f, min(cfg.f + cfg.augment_workers, cfg.p)
    if cfg.augment_scheme != "none" and hi > lo:
        xs[lo:hi] = augment_lib.augment_batch(
            gen, xs[lo:hi], scheme=cfg.augment_scheme,
            gaussian_sigma=cfg.gaussian_sigma)
    return xs


def run_byzantine_training(cfg: ByzRunConfig,
                           task: SyntheticImages | None = None, *,
                           device="cuda", on_step=None) -> dict:
    """Train the CNN for ``cfg.steps`` steps; returns the JAX driver's keys
    (``final_accuracy``, ``trajectory`` [(step, accuracy)],
    ``wall_seconds``, ``us_per_step``, ``comm_bits_per_step``,
    ``comm_ratio``) and ``device``.  ``on_step(t, G, d, theta)`` is called
    after each step's update (read-only)."""
    dev = resolve_device(str(device))
    rule = aggregator_for(cfg)
    codec, comm = rule[1].get("codec"), rule[1].get("comm", CommConfig())
    task = task or SyntheticImages(seed=cfg.seed)
    params = cnn_init(torch.Generator().manual_seed(cfg.seed))
    theta, layout = pack(params, dev)
    mom = torch.zeros_like(theta)
    ef = init_ef(theta, cfg.p) if comm.wants_ef else None
    xt, yt = (t.to(dev) for t in task.test_set(1024))

    def accuracy() -> float:
        with torch.no_grad():
            pred = cnn_logits(unflatten(theta, layout), xt).argmax(-1)
            return float((pred == yt).float().mean())

    traj = []
    t0 = time.perf_counter()
    for t in range(cfg.steps):
        lr = cfg.lr * (cfg.lr_decay ** (t // cfg.lr_decay_every))
        gen = step_generator(cfg.seed, t)
        xs, ys = task.sample(gen, cfg.batch, lead=(cfg.p,))
        xs = _augment(gen, xs.to(dev), cfg)
        G, d = byzantine_step(theta, mom, layout, xs, ys.to(dev), cfg=cfg,
                              step=t, lr=lr, rule=rule, ef=ef)
        if on_step is not None:
            on_step(t, G, d, theta)
        if (t + 1) % cfg.eval_every == 0 or t == cfg.steps - 1:
            traj.append((t + 1, accuracy()))
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    dense = dense_bits(layout, cfg.p)
    bits = codec.bits(layout, cfg.p) if codec else dense
    return {"final_accuracy": traj[-1][1], "trajectory": traj,
            "wall_seconds": wall, "us_per_step": wall / cfg.steps * 1e6,
            "comm_bits_per_step": bits, "comm_ratio": dense / bits,
            "device": str(dev)}


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    for fld in dataclasses.fields(ByzRunConfig):
        flag = "--" + fld.name.replace("_", "-")
        default = (fld.default_factory() if fld.default_factory
                   is not dataclasses.MISSING else fld.default)
        if fld.name.endswith("_kw") or fld.name == "flag_cfg":
            ap.add_argument(flag, type=json.loads, default=default,
                            help="JSON object" + (" of FlagConfig fields"
                                                  if fld.name == "flag_cfg"
                                                  else ""))
        else:
            ap.add_argument(flag, type=type(default), default=default)
    return ap


def main(argv=None) -> dict:
    """Parse the flags, train, print one JSON line and return it."""
    args = vars(_parser().parse_args(argv))
    device = args.pop("device")
    if args["flag_cfg"] is not None:
        args["flag_cfg"] = FlagConfig(**args["flag_cfg"])
    cfg = ByzRunConfig(**args)
    out = run_byzantine_training(cfg, device=device)
    if out["device"].startswith("cuda"):
        out["device_name"] = torch.cuda.get_device_name(torch.device(device))
    line = {"config": {**dataclasses.asdict(cfg)}, **out}
    print(json.dumps(line, default=str), flush=True)
    return line


if __name__ == "__main__":
    main()
