"""How far the CNN loop's trajectory moves when its gradients move by a
relative ``eps``: the loop run plain, then with every step's gradient
matrix multiplied by ``1 + eps * N(0, 1)`` (a fixed generator), for each
``eps``; one JSON line each with the relative distance of every step's
update d from the plain run's, and both final accuracies.

    PYTHONPATH=src python -m repro_torch.launch.byz_probe \\
        --eps 1e-7 1e-6 1e-5

The defaults are ``chip_smoke.py``'s card-against-CPU case that holds
flag x sign_flip x signSGD (p = 7, f = 1, batch 8, 4 steps): a d that
moves by far more than ``eps`` shows a step where the FA solve is near a
bifurcation, where two devices' last bits may choose different branches.
Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json

import torch

from repro_torch.device import resolve_device
from repro_torch.launch import byzantine as bz


def trajectory(cfg: bz.ByzRunConfig, device, eps: float, seed: int = 5):
    """(each step's d on the host, final accuracy) with the gradients
    perturbed by ``eps`` relative."""
    gen = torch.Generator(device=device).manual_seed(seed)
    plain = bz.worker_gradients

    def perturbed(*args, **kw):
        G = plain(*args, **kw)
        return G * (1 + eps * torch.randn(G.shape, generator=gen,
                                          device=G.device))
    ds = []
    bz.worker_gradients = perturbed
    try:
        out = bz.run_byzantine_training(
            cfg, device=device,
            on_step=lambda t, G, d, theta: ds.append(d.cpu().clone()))
    finally:
        bz.worker_gradients = plain
    return ds, out["final_accuracy"]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--eps", type=float, nargs="+",
                    default=[1e-7, 1e-6, 1e-5])
    ap.add_argument("--aggregator", default="flag")
    ap.add_argument("--attack", default="sign_flip")
    ap.add_argument("--codec", default="signsgd")
    ap.add_argument("--p", type=int, default=7)
    ap.add_argument("--f", type=int, default=1)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--steps", type=int, default=4)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = bz.ByzRunConfig(aggregator=args.aggregator, attack=args.attack,
                          codec=args.codec, p=args.p, f=args.f,
                          batch=args.batch, steps=args.steps,
                          eval_every=args.steps)
    base, acc = trajectory(cfg, device, 0.0)
    for eps in args.eps:
        ds, acc_eps = trajectory(cfg, device, eps)
        print(json.dumps({
            "device": str(device), "eps": eps,
            "d_rel_diff_by_step": [float(torch.linalg.vector_norm(a - b)
                                         / torch.linalg.vector_norm(a))
                                   for a, b in zip(base, ds)],
            "accuracy": acc, "accuracy_perturbed": acc_eps}), flush=True)


if __name__ == "__main__":
    main()
