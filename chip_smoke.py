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
                sketch strides, dtypes, Byzantine counts, masks (none, all
                inactive, one, random), ``rows=`` views and exact ties, with
                the tolerance stated;
  4. train   -- the port's main path at full width:
                ``repro_torch.launch.train.main`` for smollm-360m (32
                layers, d_model 960, N = 361,821,120 parameters, random
                weights from seed 0), 15 workers, 3 sign-flipping
                Byzantine workers, a few steps, once per aggregator:
                ``flag`` (tree Gram + combine), ``bulyan`` (tree Gram +
                Bulyan selection + coordinate statistics) and
                ``multi_krum`` (tree Gram + Krum scores + combine); before
                each run the kernels' launch counters are zeroed, after it
                each of the run's kernels must have launched once per step;
  5. check   -- the same train CLI at the reduced size on the card (the
                kernels) and on the CPU (the plain versions) from the same
                weights and tokens must agree, for flag and for each of the
                seven baseline rules; and ``aggregate_tree`` under a mask,
                card against CPU, for each baseline rule;
  6. timing  -- each kernel at the main path's shape (W = 15,
                N = 361,821,120, fp32) against its plain version, checked
                for agreement and timed with CUDA events beside the plain
                version, one PyTorch library call computing the same
                function where there is one (a yardstick the port never
                calls), and the card's bound for the work.

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
MAIN_F = 3
TRAIN_STEPS = 4
TRAIN_ARGV = ["--arch", "smollm-360m", "--workers", str(MAIN_W),
              "--byzantine", str(MAIN_F), "--attack", "sign_flip",
              "--steps", str(TRAIN_STEPS), "--log-every", "1"]
# aggregator -> the kernels its main-path run must launch once a step
TRAIN_RUNS = {"flag": ("tree_gram", "weighted_sum"),
              "bulyan": ("tree_gram", "bulyan_select", "coord_stats"),
              "multi_krum": ("tree_gram", "krum_scores", "weighted_sum")}
BASELINES = ("krum", "multi_krum", "median", "trimmed_mean", "meamed",
             "phocas", "bulyan")
SOURCES = ("tree_gram", "weighted_sum", "coord_stats", "krum_select")
# (W, ragged N) of the kernel sweep
SWEEP = ((1, 50_000_017), (3, 50_000_017), (15, 50_000_017),
         (64, 3_000_001), (100, 3_000_001))
# rel. error of an fp32 sum of products against another summation order,
# normalised by sqrt(K_ii K_jj) (Gram) or sum_w |c_w x_w| (combine)
GRAM_TOL, WSUM_TOL = 2e-5, 1e-5
BF16_ULP = 2.0 ** -7            # one bf16 ulp (relative): two fp32 sums
                                # straddling a rounding boundary
# coord_stats sweep: worker counts, a ragged width, Byzantine counts (the
# last one above (W - 1) / 2 for every W)
COORD_W, COORD_N, COORD_F = (1, 2, 3, 8, 15, 64), 2_000_003, (0, 1, 3, 40)
SELECT_W = (3, 4, 8, 15, 64)
# Kernel and plain version sort alike and sum in the same order (ascending,
# sequential fp32, one IEEE division), so the median must be bit-equal and
# the means may differ only by an fp32 rounding of a sum that another
# compiler contracted differently: |diff| <= 2^-20 * (|ref| + max|x|).
COORD_TOL = 2.0 ** -20
SCORE_TOL = 2.0 ** -20          # Krum scores, relative, same reasoning


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
    built = _build.build_all(SOURCES)
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


def coord_excess(got, want, X) -> tuple[float, float]:
    """Max excess of |got - want| over COORD_TOL * (|want| + max|X|)
    (<= 0 passes; equal infinities pass) and the raw max error."""
    import torch
    same = got == want
    diff = torch.where(same, 0.0, (got - want).abs())
    if bool(torch.isnan(diff).any()):
        return math.inf, math.inf
    scale = max(float(X.max()), -float(X.min()))   # max|X|, no temporary
    bound = COORD_TOL * (torch.where(same, 0.0, want.abs()) + scale)
    return float((diff - bound).max()), float(diff.max())


def _coord_inputs(gen, W, n, ties):
    """Normal data, or small integers with a repeated row (exact ties)."""
    import torch
    if not ties:
        return torch.randn((W, n), generator=gen, device=DEVICE)
    X = torch.randint(-3, 4, (W, n), generator=gen, device=DEVICE).float()
    if W > 2:
        X[W - 1] = X[0]
    return X


def _masks(gen, W):
    import torch
    one = torch.zeros(W, device=DEVICE)
    one[W // 2] = 1.0
    rnd = (torch.rand(W, generator=gen, device=DEVICE) < 0.6).float()
    return {"none": None, "all_inactive": torch.zeros(W, device=DEVICE),
            "one": one, "random": rnd}


def phase_sweep_coord():
    """coord_stats kernel against its plain version: every op, W, f, mask
    kind and dtype on a ragged width; exact-tie data; rows= views."""
    import torch
    from repro_torch.kernels.coord_stats.kernel import coord_stats_cuda
    from repro_torch.kernels.coord_stats.ref import COORD_OPS, coord_stat_plain

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(3)
    worst, cases = 0.0, 0

    def one(X, op, f, **kw):
        nonlocal worst, cases
        got = coord_stats_cuda(X, op, f, **kw)
        want = coord_stat_plain(X, op, f, **kw)
        torch.cuda.synchronize()
        if op == "median":
            ok = bool(((got == want) | (got.isnan() & want.isnan())).all())
            raw = 0.0 if ok else float((got - want).abs().max())
        else:
            excess, raw = coord_excess(got, want, X)
            ok = excess <= 0
        if not ok:
            raise AssertionError(
                f"coord_stats {op} W={X.shape[0]} f={f} {X.dtype} "
                f"{sorted(kw)}: max err {raw}")
        worst = max(worst, raw)
        cases += 1

    for W in COORD_W:
        for ties in (False, True):
            X32 = _coord_inputs(gen, W, COORD_N, ties)
            for dtype in (torch.float32, torch.bfloat16):
                if ties and dtype == torch.bfloat16:
                    continue
                X = X32 if dtype == torch.float32 else X32.to(dtype)
                masks = _masks(gen, W)
                for f in COORD_F:
                    for kind, m in masks.items():
                        for op in COORD_OPS:
                            one(X, op, f, mask=m)
                del X
            del X32
    X = _coord_inputs(gen, 20, COORD_N, False)
    view = X[2:19, 5:COORD_N - 7]              # strided rows, ragged start
    rows = torch.tensor([9, 0, 16, 4, 11, 3, 7, 14, 1], dtype=torch.int32,
                        device=DEVICE)
    rmask = _masks(gen, rows.numel())["random"]
    for op in COORD_OPS:
        one(view, op, 6, rows=rows)
        one(view, op, 6, rows=rows, mask=rmask)
    del X, view
    torch.cuda.empty_cache()
    emit({"phase": "sweep_coord_stats", "cases": cases, "w": list(COORD_W),
          "n": COORD_N, "f": list(COORD_F), "tol_rel": COORD_TOL,
          "median": "bit-equal", "worst_abs_err": worst})


def _sq_dists(gen, W, dup):
    """Squared distances of W random points, the first ``dup`` identical
    (exact score ties, as the zero attack makes them)."""
    import torch
    P = torch.randn((W, 6), generator=gen, device=DEVICE)
    P[:dup] = 0.0
    D = ((P[:, None, :] - P[None, :, :]) ** 2).sum(-1)
    return D.fill_diagonal_(0.0).contiguous()


def phase_sweep_select():
    """krum_scores and bulyan_select kernels against their plain versions:
    picks equal, scores within SCORE_TOL."""
    import torch
    from repro_torch.kernels.coord_stats.kernel import (bulyan_select_cuda,
                                                        krum_scores_cuda)
    from repro_torch.kernels.coord_stats.ref import (bulyan_select_plain,
                                                     krum_scores_plain)

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(4)
    worst, cases = 0.0, 0
    for W in SELECT_W:
        for dup in (0, 3):
            D = _sq_dists(gen, W, dup)
            for f in sorted({0, 1, 3, W // 2}):
                s, s_plain = krum_scores_cuda(D, f), krum_scores_plain(D, f)
                picks = bulyan_select_cuda(D, f)
                picks_plain = bulyan_select_plain(D, f)
                torch.cuda.synchronize()
                rel = float(((s - s_plain).abs()
                             / s_plain.abs().clamp(min=1e-30)).max())
                if not (rel <= SCORE_TOL and torch.equal(picks, picks_plain)
                        and torch.equal(torch.argmin(s),
                                        torch.argmin(s_plain))):
                    raise AssertionError(
                        f"selection W={W} f={f} dup={dup}: score rel err "
                        f"{rel}, picks {picks.tolist()} vs "
                        f"{picks_plain.tolist()}")
                worst = max(worst, rel)
                cases += 1
    emit({"phase": "sweep_select", "cases": cases, "w": list(SELECT_W),
          "score_rel_tol": SCORE_TOL, "picks": "equal",
          "worst_score_rel_err": worst})


def _counters():
    """name -> (get, reset) for every kernel's launch counter."""
    from repro_torch.kernels.coord_stats import kernel as cs_k
    from repro_torch.kernels.gram import kernel as gram_k
    from repro_torch.kernels.weighted_sum import kernel as wsum_k

    def attr(mod):
        return (lambda: mod.launches,
                lambda: setattr(mod, "launches", 0))

    def key(name):
        return (lambda: cs_k.launches[name],
                lambda: cs_k.launches.__setitem__(name, 0))
    return {"tree_gram": attr(gram_k), "weighted_sum": attr(wsum_k),
            **{n: key(n) for n in cs_k.launches}}


def phase_train():
    """The main path once per aggregator of TRAIN_RUNS; returns, per
    kernel, its launches in the run that drives it and that run's steps."""
    import torch
    from repro_torch.launch import train

    counters = _counters()
    launches = {}
    for agg, kernels in TRAIN_RUNS.items():
        argv = TRAIN_ARGV + ["--aggregator", agg, "--device", DEVICE]
        torch.cuda.reset_peak_memory_stats()
        for _, reset in counters.values():
            reset()
        hist = train.main(argv)
        counts = {n: get() for n, (get, _) in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in hist]
        if len(hist) != TRAIN_STEPS or not all(math.isfinite(x)
                                               for x in losses):
            raise AssertionError(f"train {agg}: losses {losses}")
        for h in hist:
            c = h["fa_weights"]
            if len(c) != MAIN_W or not all(math.isfinite(x) for x in c):
                raise AssertionError(f"train {agg}: fa_weights {c}")
        if any(counts[n] != TRAIN_STEPS for n in kernels):
            raise AssertionError(
                f"train {agg}: kernel launches {counts}, want {TRAIN_STEPS} "
                f"each of {kernels} (one per step)")
        for n in kernels:
            launches.setdefault(n, (counts[n], agg))
        steady = [h["step_s"] for h in hist[1:]]
        emit({"phase": "train", "aggregator": agg, "argv": argv,
              "losses": losses,
              "grad_global_norm": [h["grad_global_norm"] for h in hist],
              "fa_weights_last": hist[-1]["fa_weights"],
              "step_s": [h["step_s"] for h in hist],
              "step_s_after_warmup": sum(steady) / len(steady),
              "max_memory_allocated_bytes": peak, "launches": counts})
        del hist
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def phase_check():
    """Small input: kernels on the card against plain versions on the CPU,
    the whole train step end to end for flag and each baseline rule, and
    aggregate_tree under a mask for each baseline rule.

    Tolerances: the loss to rel 1e-4 and the weights to 5e-4 + 5e-3 |c|
    (the FA tolerance).  Bulyan at W = 8, f = 2 keeps 1 of its 4 picks per
    coordinate, the one nearer the midpoint of the middle two: a tie in
    real arithmetic that fp32 rounding decides, so gradients that differ in
    their last bits between card and CPU move some coordinates by a whole
    gap; its loss is held to rel 5e-4 (tests/test_torch_train.py states
    the same for the port against JAX)."""
    import torch
    from repro_torch.dist.aggregation import AggregatorConfig, aggregate_tree
    from repro_torch.launch import train
    common = ["--debug", "--steps", "3", "--seq", "32", "--workers", "8",
              "--per-worker-batch", "2", "--byzantine", "2", "--attack",
              "sign_flip", "--optimizer", "sgd", "--log-every", "100"]
    out = {}
    for agg in ("flag",) + BASELINES:
        argv = common + ["--aggregator", agg]
        gpu = train.main(argv + ["--device", DEVICE])
        cpu = train.main(argv + ["--device", "cpu"])
        rel = 5e-4 if agg == "bulyan" else 1e-4
        for g, c in zip(gpu, cpu):
            if not math.isclose(g["loss"], c["loss"], rel_tol=rel):
                raise AssertionError(f"check {agg}: loss {g['loss']} vs "
                                     f"{c['loss']}")
            for a, b in zip(g["fa_weights"], c["fa_weights"]):
                if abs(a - b) > 5e-4 + 5e-3 * abs(b):
                    raise AssertionError(
                        f"check {agg}: fa_weights {g['fa_weights']} vs "
                        f"{c['fa_weights']}")
        out[agg] = {"loss_gpu": [g["loss"] for g in gpu],
                    "loss_cpu": [c["loss"] for c in cpu],
                    "fa_weights_gpu": gpu[-1]["fa_weights"],
                    "fa_weights_cpu": cpu[-1]["fa_weights"]}

    gen = torch.Generator().manual_seed(5)
    X = torch.randn((MAIN_W, 200_001), generator=gen)
    X[:MAIN_F] *= -10.0
    mask = torch.ones(MAIN_W)
    mask[torch.randperm(MAIN_W, generator=gen)[:3]] = 0.0
    masked = {}
    for agg in BASELINES:
        cfg = AggregatorConfig(name=agg, f=MAIN_F)
        d, aux = aggregate_tree(X.to(DEVICE), cfg, mask=mask.to(DEVICE))
        d_cpu, aux_cpu = aggregate_tree(X, cfg, mask=mask)
        scale = float(d_cpu.abs().max())
        diff = (d.cpu() - d_cpu).abs()
        err = float(diff.max()) / scale
        excess = float((diff - 5e-4 * scale - 5e-3 * d_cpu.abs()).max())
        werr = float((aux["weights"].cpu() - aux_cpu["weights"]).abs().max())
        if excess > 0 or werr > 5e-4 + 5e-3 * float(
                aux_cpu["weights"].abs().max()):
            raise AssertionError(f"check masked {agg}: d err {err} of "
                                 f"max|d|, weights err {werr}")
        masked[agg] = {"d_err_of_max": err, "weights_err": werr}
    emit({"phase": "check", "train": out, "masked_aggregate_tree": masked})


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
        "launches": launches["tree_gram"][0],
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
        "launches": launches["weighted_sum"][0],
        "max_abs_err": raw,
        "ms": cuda_ms(lambda: weighted_sum_cuda(X, c), 10, 2),
        "plain_ms": cuda_ms(lambda: weighted_sum_plain(X, c), 3),
        "bound_ms": 1e3 * max(t_b, t_o),
        "bound_by": "bytes" if t_b >= t_o else "operations",
        "library_ms": cuda_ms(lambda: c @ X, 5)})
    coord_rows = timing_coord_stats(X, launches, rows)
    emit({"phase": "timing", "shape": [W, N], "dtype": "float32",
          "card": smi, "hbm_bytes_per_s": HBM_BYTES_PER_S,
          "fp32_flop_per_s": FP32_FLOP_PER_S, "kernels": rows,
          "coord_stats_rows": coord_rows, "breakdown": breakdown(X)})
    del X
    torch.cuda.empty_cache()
    return rows


def bound(nbytes: float, ops: float) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / FP32_FLOP_PER_S
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def coord_ops(op: str, r: int, f: int) -> int:
    """fp32 operations per coordinate of one statistic over r values: the
    odd-even network's r(r-1)/2 compare-exchanges at r (not the padded
    width), 2 operations each (min, max); the center (2, or the kept sum
    and a division); for MeaMed / Phocas r distances (2 each), the
    key-value network (5 per compare-exchange: compare, 4 selects) and the
    kept sum and a division."""
    ce = r * (r - 1) // 2
    kt, ka = min(f, (r - 1) // 2), max(r - f, 1)
    n = 2 * ce + (2 if op in ("median", "meamed") else r - 2 * kt + 1)
    if op in ("meamed", "phocas"):
        n += 2 * r + 5 * ce + ka + 1
    return n


def timing_coord_stats(X, launches, rows):
    """coord_stats (each op, masked median, Bulyan's rows= MeaMed),
    krum_scores and bulyan_select at the main path's shape; appends the
    kernels' entries (the coord_stats entry is Bulyan's stage, the shape
    the main path gives it) to ``rows`` and returns the per-op rows."""
    import torch
    from repro_torch.core.aggregators import sq_dists_from_gram
    from repro_torch.kernels.coord_stats.kernel import (bulyan_select_cuda,
                                                        coord_stats_cuda,
                                                        krum_scores_cuda)
    from repro_torch.kernels.coord_stats.ref import (COORD_OPS,
                                                     bulyan_select_plain,
                                                     coord_stat_plain,
                                                     krum_scores_plain)
    from repro_torch.kernels.gram.kernel import tree_gram_cuda

    W, N, F = X.shape[0], X.shape[1], MAIN_F
    D2 = sq_dists_from_gram(tree_gram_cuda(X)).contiguous()
    picks = bulyan_select_cuda(D2, F)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(6)
    mask = torch.ones(W, device=DEVICE)
    mask[torch.randperm(W, generator=gen, device=DEVICE)[:3]] = 0.0
    cases = [(op, F, {}) for op in COORD_OPS] + [
        ("median", F, {"mask": mask}),
        ("meamed", 2 * F, {"rows": picks})]
    out = []
    for op, f, kw in cases:
        got = coord_stats_cuda(X, op, f, **kw)
        want = coord_stat_plain(X, op, f, **kw)
        torch.cuda.synchronize()
        excess, raw = coord_excess(got, want, X)
        if (op == "median" and not torch.equal(got, want)) or excess > 0:
            raise AssertionError(f"timing: coord_stats {op} {sorted(kw)} "
                                 f"max err {raw}")
        del got, want
        read = (picks.numel() if "rows" in kw else
                int(mask.sum()) if "mask" in kw else W)
        t, by = bound(read * N * 4 + N * 4, N * coord_ops(op, read, f))
        lib = None
        if op == "median" and not kw:           # odd W: the true median
            lib = cuda_ms(lambda: torch.median(X, dim=0), 3)
        out.append({
            "op": op, "f": f, "variant": ("rows" if "rows" in kw else
                                          "masked" if "mask" in kw
                                          else "plain"),
            "workers_read": read, "max_abs_err": raw,
            "ms": cuda_ms(lambda: coord_stats_cuda(X, op, f, **kw), 5),
            "plain_ms": cuda_ms(lambda: coord_stat_plain(X, op, f, **kw), 2,
                                0),
            "bound_ms": t, "bound_by": by, "library_ms": lib})
        torch.cuda.empty_cache()
    bul = out[-1]
    rows.append({
        "name": "coord_stats", "route": "cuda",
        "source": "src/repro_torch/csrc/coord_stats.cu",
        "replaces": "src/repro/kernels/coord_stats/kernel.py:210",
        "launches": launches["coord_stats"][0],
        **{k: bul[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                               "bound_by", "library_ms")}})

    k = max(W - F - 2, 1)
    s, s_plain = krum_scores_cuda(D2, F), krum_scores_plain(D2, F)
    p_plain = bulyan_select_plain(D2, F)
    torch.cuda.synchronize()
    if not torch.equal(picks, p_plain) or \
            float(((s - s_plain).abs() / s_plain.abs()).max()) > SCORE_TOL:
        raise AssertionError(f"timing: selection picks {picks.tolist()} vs "
                             f"{p_plain.tolist()}, scores {s} vs {s_plain}")
    t, by = bound(W * W * 4 + W * 4, W * (W - 1) + W * k)
    rows.append({
        "name": "krum_scores", "route": "cuda",
        "source": "src/repro_torch/csrc/krum_select.cu",
        "replaces": "src/repro/kernels/coord_stats/kernel.py:293",
        "launches": launches["krum_scores"][0],
        "max_abs_err": float((s - s_plain).abs().max()),
        "ms": cuda_ms(lambda: krum_scores_cuda(D2, F), 100, 5),
        "plain_ms": cuda_ms(lambda: krum_scores_plain(D2, F), 20, 2),
        "bound_ms": t, "bound_by": by, "library_ms": None})
    theta = picks.numel()
    t, by = bound(W * W * 4 + theta * 4, theta * (W * (W - 1) + W * k + W))
    rows.append({
        "name": "bulyan_select", "route": "cuda",
        "source": "src/repro_torch/csrc/krum_select.cu",
        "replaces": "src/repro/kernels/coord_stats/kernel.py:356",
        "launches": launches["bulyan_select"][0],
        "max_abs_err": 0.0,
        "ms": cuda_ms(lambda: bulyan_select_cuda(D2, F), 100, 5),
        "plain_ms": cuda_ms(lambda: bulyan_select_plain(D2, F), 5, 1),
        "bound_ms": t, "bound_by": by, "library_ms": None})
    return out


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
        "aggregate_tree_bulyan_ms": host_ms(lambda: aggregate_tree(
            X, AggregatorConfig(name="bulyan", f=MAIN_F))),
        "aggregate_tree_multi_krum_ms": host_ms(lambda: aggregate_tree(
            X, AggregatorConfig(name="multi_krum", f=MAIN_F))),
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
    phase_sweep_coord()
    phase_sweep_select()
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
