"""Serving launcher of the port: batched greedy decoding on one card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch smollm-360m \\
        --batch 4 --prompt-len 64 --gen 32

The flags are those of ``repro.launch.serve`` plus ``--device`` and
``--seed``.  Without ``--debug`` it serves the full configuration;
``--debug`` serves the reduced variant (``reduce_for_smoke``, its
frontend removed: the prompts are tokens alone).  It runs on
``cuda`` unless ``--device cpu`` is given, and raises when no card is
present and the CPU was not asked for.  Weights are random from
``--seed``, prompts random from ``--seed + 1``.  The prompt is consumed
token by token through the serve step, then ``--gen`` tokens are
generated; the printout has the JAX launcher's fields (prefill and decode
seconds, decode tok/s), timed on the host clock after a device
synchronisation.
"""

from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, reduce_for_smoke
from repro_torch.device import resolve_device
from repro_torch.dist.serve_step import build_serve_step, check_lengths
from repro_torch.models import transformer


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--debug", action="store_true",
                    help="reduced config (2 layers, d_model 256, fp32)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights (prompts: seed + 1)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    return ap


def main(argv=None):
    """Serve; returns ``{"prompts", "tokens", "prefill_s", "decode_s",
    "tok_per_s"}`` (tokens: the (batch, gen) int32 generated ids)."""
    args = _parser().parse_args(argv)
    device = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.debug:
        # the launcher's data has no prefix: the frontend goes, as JAX's
        cfg = reduce_for_smoke(cfg).replace(frontend=None,
                                            num_prefix_embeds=0)
    max_len = args.prompt_len + args.gen + 1
    check_lengths(args.prompt_len, args.gen, max_len)
    params = transformer.init_params(cfg, seed=args.seed, device=device)
    caches = transformer.init_caches(cfg, args.batch, max_len, torch.float32,
                                     device=device)
    step_fn = build_serve_step(cfg, max_len=max_len)
    gen = torch.Generator().manual_seed(args.seed + 1)
    prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                            generator=gen).to(device)

    def clock():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter()

    t0 = clock()
    for t in range(args.prompt_len):
        tok, caches = step_fn(params, caches, prompts[:, t:t + 1], t)
    prefill_s = clock() - t0
    out = []
    t0 = clock()
    for t in range(args.prompt_len, args.prompt_len + args.gen):
        out.append(tok)
        tok, caches = step_fn(params, caches, tok, t)
    decode_s = clock() - t0
    tokens = torch.cat(out, dim=1)
    tok_per_s = args.gen * args.batch / max(decode_s, 1e-9)
    print(f"arch={cfg.name} batch={args.batch} "
          f"prefill {args.prompt_len} steps in {prefill_s:.2f}s, "
          f"decode {args.gen} steps in {decode_s:.2f}s "
          f"({tok_per_s:.1f} tok/s)", flush=True)
    for row in tokens.cpu()[:2]:
        print("  ", row.tolist()[:16], "...", flush=True)
    return {"prompts": prompts, "tokens": tokens, "prefill_s": prefill_s,
            "decode_s": decode_s, "tok_per_s": tok_per_s}


if __name__ == "__main__":
    main()
