#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line (a failure in any phase raises and the
script exits non-zero; it prints no result without a CUDA card):

  1. card    -- the card's name and power limit (``nvidia-smi``) and count;
  2. build   -- ``nvcc`` builds every CUDA source of the port, one process
                per source, all started together; build seconds and each
                kernel's registers / shared memory from ``-Xptxas -v``;
  3. sweep   -- each kernel's wrapper against its plain PyTorch version on
                the card over a sweep of worker counts, ragged widths,
                sketch strides and dtypes, with the tolerance stated;
  4. train   -- the port's main path at full width:
                ``repro_torch.launch.train.main`` for smollm-360m (32
                layers, d_model 960, N = 361,821,120 parameters, random
                weights from seed 0), 15 workers, 3 sign-flipping
                Byzantine workers, the flag aggregator, a few steps; the
                kernels' launch counters are zeroed just before and read
                just after, and each kernel must have launched once per
                step;
  5. check   -- the same train CLI at the reduced size on the card (the
                kernels) and on the CPU (the plain versions) from the same
                weights and tokens must agree;
  6. timing  -- each kernel at the main path's shape (W = 15,
                N = 361,821,120, fp32) against its plain version, checked
                for agreement and timed with CUDA events beside the plain
                version, one PyTorch library call computing the same
                function (a yardstick the port never calls), and the
                card's bound for the work.

Then the ``nvidia-smi`` line, the ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published (NVIDIA data sheet)
FP32_FLOP_PER_S = 67e12         # H100 SXM fp32 outside the tensor cores
DEVICE = "cuda"
MAIN_W, MAIN_N = 15, 361_821_120
TRAIN_STEPS = 4
TRAIN_ARGV = ["--arch", "smollm-360m", "--workers", str(MAIN_W),
              "--byzantine", "3", "--attack", "sign_flip", "--aggregator",
              "flag", "--steps", str(TRAIN_STEPS), "--log-every", "1"]
# (W, ragged N) of the kernel sweep
SWEEP = ((1, 50_000_017), (3, 50_000_017), (15, 50_000_017),
         (64, 3_000_001), (100, 3_000_001))
# rel. error of an fp32 sum of products against another summation order,
# normalised by sqrt(K_ii K_jj) (Gram) or sum_w |c_w x_w| (combine)
GRAM_TOL, WSUM_TOL = 2e-5, 1e-5
BF16_ULP = 2.0 ** -7            # one bf16 ulp (relative): two fp32 sums
                                # straddling a rounding boundary


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def gram_err(K, K_plain) -> float:
    """max |K - K_plain| / sqrt(K_ii K_jj)."""
    import torch
    d = torch.sqrt(torch.clamp(torch.diagonal(K_plain), min=1e-30))
    return float(((K - K_plain).abs() / (d[:, None] * d[None, :])).max())


def gram_fp64(X, stride: int, block_n: int = 1024):
    """The kept-chunk Gram in float64 (an accuracy yardstick for both the
    kernel and the plain version)."""
    import torch
    from repro_torch.kernels.gram.ref import chunk_schedule
    n = X.shape[1]
    _, _, scale = chunk_schedule(n, block_n, stride)
    cols = torch.arange(n, device=X.device)
    Xs = X[:, (cols // block_n) % stride == 0].double()
    return (Xs @ Xs.T) * scale


def abs_weighted(X, c):
    """sum_w |c_w| |X[w]| in fp32, row by row (no (W, N) temporary)."""
    import torch
    acc = torch.zeros(X.shape[1], dtype=torch.float32, device=X.device)
    for w in range(X.shape[0]):
        acc += c[w].abs() * X[w].float().abs()
    return acc


def wsum_err(d, d_plain, X, c) -> float:
    """max excess of |d - d_plain| over its tolerance (<= 0 passes) and
    the raw max error, for the combine."""
    import torch
    bound = WSUM_TOL * abs_weighted(X, c)
    if d.dtype == torch.bfloat16:
        bound = bound + BF16_ULP * d_plain.float().abs()
    diff = (d.float() - d_plain.float()).abs()
    return float((diff - bound).max()), float(diff.max())


def phase_card():
    import torch
    line = nvidia_smi()
    emit({"phase": "card", "nvidia_smi": line,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})
    return line


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build_all(["tree_gram", "weighted_sum"])
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"library": str(b.path.relative_to(ROOT)),
                          "nvcc_s": b.seconds, "ptxas": list(b.ptxas)}
                      for n, b in built.items()}})


def phase_sweep():
    import torch
    from repro_torch.kernels.gram.kernel import tree_gram_cuda
    from repro_torch.kernels.gram.ref import tree_gram_plain
    from repro_torch.kernels.weighted_sum.kernel import weighted_sum_cuda
    from repro_torch.kernels.weighted_sum.ref import weighted_sum_plain

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(1)
    worst = {"tree_gram": 0.0, "weighted_sum": 0.0}
    vs_fp64 = {"kernel": 0.0, "plain": 0.0}
    cases = 0
    for W, n in SWEEP:
        X32 = torch.randn((W, n), generator=gen, device=DEVICE)
        c = torch.randn(W, generator=gen, device=DEVICE)
        for dtype in (torch.float32, torch.bfloat16):
            X = X32 if dtype == torch.float32 else X32.to(dtype)
            for stride in (1, 4):
                K = tree_gram_cuda(X, sketch_stride=stride)
                torch.cuda.synchronize()
                K2 = tree_gram_cuda(X, sketch_stride=stride)
                K_plain = tree_gram_plain(X, stride, 1024)
                torch.cuda.synchronize()
                err = gram_err(K, K_plain)
                if not (err <= GRAM_TOL and torch.equal(K, K2)
                        and torch.equal(K, K.T)):
                    raise AssertionError(
                        f"tree_gram W={W} n={n} stride={stride} {dtype}: "
                        f"rel err {err} (tol {GRAM_TOL}), run-to-run equal "
                        f"{torch.equal(K, K2)}, symmetric "
                        f"{torch.equal(K, K.T)}")
                worst["tree_gram"] = max(worst["tree_gram"], err)
                if W <= 15:
                    K64 = gram_fp64(X, stride)
                    vs_fp64["kernel"] = max(vs_fp64["kernel"],
                                            gram_err(K.double(), K64))
                    vs_fp64["plain"] = max(vs_fp64["plain"],
                                           gram_err(K_plain.double(), K64))
                    del K64
                cases += 1
            d = weighted_sum_cuda(X, c)
            torch.cuda.synchronize()
            d_plain = weighted_sum_plain(X, c)
            excess, raw = wsum_err(d, d_plain, X, c)
            torch.cuda.synchronize()
            if excess > 0 or d.dtype != X.dtype or d.shape != (n,):
                raise AssertionError(
                    f"weighted_sum W={W} n={n} {dtype}: max err {raw} over "
                    f"its tolerance by {excess}")
            worst["weighted_sum"] = max(worst["weighted_sum"], raw)
            cases += 1
            del X
        del X32
        torch.cuda.empty_cache()
    emit({"phase": "sweep", "cases": cases, "gram_rel_tol": GRAM_TOL,
          "wsum_rel_tol": WSUM_TOL, "gram_worst_rel_err": worst["tree_gram"],
          "gram_worst_rel_err_vs_fp64_w_le_15": vs_fp64,
          "wsum_worst_abs_err": worst["weighted_sum"]})


def phase_train():
    import torch
    from repro_torch.kernels.gram import kernel as gram_k
    from repro_torch.kernels.weighted_sum import kernel as wsum_k
    from repro_torch.launch import train

    argv = TRAIN_ARGV + ["--device", DEVICE]
    torch.cuda.reset_peak_memory_stats()
    gram_k.launches = 0
    wsum_k.launches = 0
    hist = train.main(argv)
    launches = {"tree_gram": gram_k.launches,
                "weighted_sum": wsum_k.launches}
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in hist]
    if len(hist) != TRAIN_STEPS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: losses {losses}")
    for h in hist:
        c = h["fa_weights"]
        if len(c) != MAIN_W or not all(math.isfinite(x) for x in c):
            raise AssertionError(f"train: fa_weights {c}")
    if any(n != TRAIN_STEPS for n in launches.values()):
        raise AssertionError(f"train: kernel launches {launches}, want "
                             f"{TRAIN_STEPS} each (one per step)")
    steady = [h["step_s"] for h in hist[1:]]
    emit({"phase": "train", "argv": argv, "losses": losses,
          "grad_global_norm": [h["grad_global_norm"] for h in hist],
          "fa_weights_last": hist[-1]["fa_weights"],
          "step_s": [h["step_s"] for h in hist],
          "step_s_after_warmup": sum(steady) / len(steady),
          "max_memory_allocated_bytes": peak, "launches": launches})
    gc.collect()
    torch.cuda.empty_cache()
    return launches


def phase_check():
    """Small input: kernels on the card against plain versions on the CPU,
    the whole train step end to end."""
    from repro_torch.launch import train
    common = ["--debug", "--steps", "3", "--seq", "32", "--workers", "8",
              "--per-worker-batch", "2", "--byzantine", "2", "--attack",
              "sign_flip", "--optimizer", "sgd", "--log-every", "100"]
    gpu = train.main(common + ["--device", DEVICE])
    cpu = train.main(common + ["--device", "cpu"])
    for g, c in zip(gpu, cpu):
        if not math.isclose(g["loss"], c["loss"], rel_tol=1e-4):
            raise AssertionError(f"check: loss {g['loss']} vs {c['loss']}")
        for a, b in zip(g["fa_weights"], c["fa_weights"]):
            if abs(a - b) > 5e-4 + 5e-3 * abs(b):
                raise AssertionError(f"check: fa_weights {g['fa_weights']} "
                                     f"vs {c['fa_weights']}")
    emit({"phase": "check", "loss_gpu": [g["loss"] for g in gpu],
          "loss_cpu": [c["loss"] for c in cpu],
          "fa_weights_gpu": gpu[-1]["fa_weights"],
          "fa_weights_cpu": cpu[-1]["fa_weights"]})


def phase_timing(launches, smi):
    import torch
    from repro_torch.kernels.gram.kernel import tree_gram_cuda
    from repro_torch.kernels.gram.ref import tree_gram_plain
    from repro_torch.kernels.weighted_sum.kernel import weighted_sum_cuda
    from repro_torch.kernels.weighted_sum.ref import weighted_sum_plain

    W, N = MAIN_W, MAIN_N
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(2)
    X = torch.randn((W, N), generator=gen, device=DEVICE)
    c = torch.randn(W, generator=gen, device=DEVICE)
    rows = []

    K = tree_gram_cuda(X)
    K_plain = tree_gram_plain(X, 1, 1024)
    torch.cuda.synchronize()
    rel = gram_err(K, K_plain)
    if rel > GRAM_TOL:
        raise AssertionError(f"timing: tree_gram rel err {rel}")
    gram_bytes = W * N * 4 + W * W * 4
    gram_ops = W * (W + 1) * N              # upper triangle, mul + add
    t_b, t_o = gram_bytes / HBM_BYTES_PER_S, gram_ops / FP32_FLOP_PER_S
    rows.append({
        "name": "tree_gram", "route": "cuda",
        "source": "src/repro_torch/csrc/tree_gram.cu",
        "replaces": "src/repro/kernels/gram/kernel.py:91",
        "launches": launches["tree_gram"],
        "max_abs_err": float((K - K_plain).abs().max()),
        "ms": cuda_ms(lambda: tree_gram_cuda(X), 10, 2),
        "plain_ms": cuda_ms(lambda: tree_gram_plain(X, 1, 1024), 3),
        "bound_ms": 1e3 * max(t_b, t_o),
        "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": cuda_ms(lambda: X @ X.T, 3)})
    del K, K_plain

    d = weighted_sum_cuda(X, c)
    d_plain = weighted_sum_plain(X, c)
    torch.cuda.synchronize()
    excess, raw = wsum_err(d, d_plain, X, c)
    if excess > 0:
        raise AssertionError(f"timing: weighted_sum err {raw}")
    del d, d_plain
    ws_bytes = W * N * 4 + N * 4 + W * 4
    ws_ops = 2 * W * N
    t_b, t_o = ws_bytes / HBM_BYTES_PER_S, ws_ops / FP32_FLOP_PER_S
    rows.append({
        "name": "weighted_sum", "route": "cuda",
        "source": "src/repro_torch/csrc/weighted_sum.cu",
        "replaces": "src/repro/kernels/weighted_sum/kernel.py:27",
        "launches": launches["weighted_sum"],
        "max_abs_err": raw,
        "ms": cuda_ms(lambda: weighted_sum_cuda(X, c), 10, 2),
        "plain_ms": cuda_ms(lambda: weighted_sum_plain(X, c), 3),
        "bound_ms": 1e3 * max(t_b, t_o),
        "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": cuda_ms(lambda: c @ X, 5)})
    emit({"phase": "timing", "shape": [W, N], "dtype": "float32",
          "card": smi, "hbm_bytes_per_s": HBM_BYTES_PER_S,
          "fp32_flop_per_s": FP32_FLOP_PER_S, "kernels": rows,
          "breakdown": breakdown(X)})
    del X
    torch.cuda.empty_cache()
    return rows


def breakdown(X):
    """The aggregation and optimizer stages of one main-path step, timed
    alone on the main path's shapes (host clock ending in a
    synchronisation, mean of 3 after one warm-up)."""
    import torch
    from repro_torch.core.flag import FlagConfig
    from repro_torch.core.gram import fa_weights_from_gram
    from repro_torch.dist.aggregation import AggregatorConfig, aggregate_tree
    from repro_torch.kernels.gram.kernel import tree_gram_cuda
    from repro_torch.optim import adamw, apply_updates

    def host_ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t0) / reps

    W = X.shape[0]
    flag = FlagConfig(lam=float(W), regularizer="pairwise")
    K = tree_gram_cuda(X)
    out = {
        "aggregate_tree_flag_ms": host_ms(lambda: aggregate_tree(
            X, AggregatorConfig(name="flag", f=3, flag=flag))),
        "fa_solve_ms": host_ms(lambda: fa_weights_from_gram(K, flag)),
        "worker_norms_ms": host_ms(
            lambda: torch.linalg.vector_norm(X, dim=1)),
    }
    opt = adamw()
    p = X[1].clone()
    state = opt.init(p)

    def step():
        upd, _ = opt.update(X[0], state, p, torch.tensor(1e-4))
        apply_updates(p, upd)
    out["adamw_ms"] = host_ms(step)
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    resolve_device("cuda")                  # TF32 and reduced reductions off
    smi = phase_card()
    phase_build()
    phase_sweep()
    launches = phase_train()
    phase_check()
    rows = phase_timing(launches, smi)
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
