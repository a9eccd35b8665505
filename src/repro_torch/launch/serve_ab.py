"""Serve-path timings of two source trees on one CUDA card, interleaved.

Each (tree, arch) runs in a fresh process with ``<tree>/src`` first on the
path: the serve CLI (``repro_torch.launch.serve``: batch 4, prompt 64, 32
generated tokens, seed 0, on ``cuda``) with its weights kept, then 4 more
decode steps under that tree's ``chip_smoke.device_profile`` (host wall
time, device busy time and idle share, CPU operator calls a step) and,
for an arch given as ``name:BxS``, two timed prefill calls of B x S
random tokens and one profiled.  The trees run in the order of
``--order`` (e.g. ``A,B,B,A``: parent, change, change, parent), so a
drift of the shared host shows in both trees' readings.  One JSON line a
run goes to stdout and to ``--out``.

    PYTHONPATH=src python -m repro_torch.launch.serve_ab \\
        --tree A=build/parent --tree B=. --order A,B,B,A \\
        --arch xlstm-1.3b:4x2048 --arch recurrentgemma-9b \\
        --out chiprun_out/serve_ab.jsonl

(``build/parent``: e.g. ``git archive HEAD~1 | tar -x -C build/parent``.)
Both trees need a ``chip_smoke.py`` with ``device_profile``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

CHILD = r"""
import json, sys, time
tree, arch, prefill = sys.argv[1], sys.argv[2], sys.argv[3]
sys.path[:0] = [tree + "/src", tree]
import torch
import chip_smoke
from repro_torch.configs import get_config
from repro_torch.device import resolve_device
from repro_torch.dist.serve_step import build_prefill_step, build_serve_step
from repro_torch.launch import serve
from repro_torch.models import transformer

resolve_device("cuda")
kept = {}
init_params = transformer.init_params


def keep(cfg, *, seed=0, device="cpu"):
    t0 = time.perf_counter()
    kept["params"] = init_params(cfg, seed=seed, device=device)
    torch.cuda.synchronize()
    kept["init_s"] = time.perf_counter() - t0
    return kept["params"]


transformer.init_params = keep
out = serve.main(["--arch", arch, "--batch", "4", "--prompt-len", "64",
                  "--gen", "32", "--device", "cuda"])
transformer.init_params = init_params
cfg, params = get_config(arch), kept["params"]
P, G = out["prompts"].shape[1], out["tokens"].shape[1]
max_len = P + G + 1
caches = transformer.init_caches(cfg, 4, max_len, torch.float32,
                                 device="cuda")
step_fn = build_serve_step(cfg, max_len=max_len)
state = {"tok": out["prompts"][:, :1], "pos": 0}


def decode_one():
    state["tok"], _ = step_fn(params, caches, state["tok"], state["pos"])
    state["pos"] += 1


rec = {"arch": arch, "init_params_s": kept["init_s"],
       "tok_per_s": out["tok_per_s"], "serve_prefill_s": out["prefill_s"],
       "serve_decode_s": out["decode_s"],
       "decode_step_profile": chip_smoke.device_profile(decode_one, 4)}
if prefill:
    B, S = map(int, prefill.split("x"))
    g = torch.Generator().manual_seed(9)
    tokens = torch.randint(0, cfg.vocab_size, (B, S), generator=g).cuda()
    fn = build_prefill_step(cfg)
    times = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    rec.update(prefill_tokens=[B, S], prefill_s=times,
               prefill_profile=chip_smoke.device_profile(
                   lambda: fn(params, {"tokens": tokens}), 1))
print("RESULT " + json.dumps(rec), flush=True)
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", action="append", required=True,
                    help="NAME=PATH of a source tree (a checkout's root)")
    ap.add_argument("--order", required=True,
                    help="comma-separated tree names, e.g. A,B,B,A")
    ap.add_argument("--arch", action="append", required=True,
                    help="an arch, with ':BxS' for a timed prefill")
    ap.add_argument("--out", default=None, help="JSON lines file")
    args = ap.parse_args(argv)
    trees = dict(t.split("=", 1) for t in args.tree)
    sink = open(args.out, "a") if args.out else None
    for i, name in enumerate(args.order.split(",")):
        root = str(Path(trees[name]).resolve())
        for spec in args.arch:
            arch, _, prefill = spec.partition(":")
            env = {**os.environ, "PYTHONPATH": root + "/src"}
            proc = subprocess.run(
                [sys.executable, "-c", CHILD, root, arch, prefill],
                env=env, capture_output=True, text=True, check=False)
            lines = [ln for ln in proc.stdout.splitlines()
                     if ln.startswith("RESULT ")]
            if proc.returncode != 0 or not lines:
                sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
                raise SystemExit(f"serve_ab: {name} {arch} failed "
                                 f"(rc {proc.returncode})")
            rec = {"run": i, "tree": name, "path": trees[name],
                   **json.loads(lines[-1][len("RESULT "):])}
            line = json.dumps(rec)
            print(line, flush=True)
            if sink:
                sink.write(line + "\n")
                sink.flush()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
