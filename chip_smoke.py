#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port runs on one NVIDIA H100.

    python3 chip_smoke.py

Phases, each printing one JSON line (a failure in any phase raises and the
script exits non-zero; it prints no result without a CUDA card):

  1. card    -- the card's name and power limit (``nvidia-smi``) and count;
  2. build   -- ``nvcc`` builds every CUDA source of the port, one process
                per source, all started together; build seconds and each
                kernel's registers / shared memory / spills from
                ``-Xptxas -v`` (the bf16 flash-attention body's lines also
                printed one a line; the coordinate-statistics kernel's
                lines by network width and dtype, and the exact widths
                that spill);
  3. sweep   -- each kernel's wrapper against its plain PyTorch version on
                the card, with the tolerance stated: the tree Gram and the
                combine over worker counts, ragged widths, sketch strides
                and dtypes (``sweep``); the coordinate statistics over
                Byzantine counts, masks, ``rows=`` views and exact ties
                (``sweep_coord_stats``); the Krum / Bulyan selections
                (``sweep_select``); flash attention over square prefill,
                decode (sq = 1), ragged, sq < sk and sq > sk shapes,
                windows 16 and 64 with and without causal masking,
                H / KV in {1, 3, 8}, every head dim and both dtypes,
                held against the plain version in fp32, the limit shown in
                each case to reject a zeroed and a mis-scaled output
                (``sweep_flash``); the per-matrix Gram over widths, ragged
                lengths, element strides, row-strided views, dtypes and
                bf16 rounding (``sweep_gram``);
  4. train   -- the port's training path at full width:
                ``repro_torch.launch.train.main`` for smollm-360m (32
                layers, d_model 960, N = 361,821,120 parameters, random
                weights from seed 0), 15 workers, 3 sign-flipping
                Byzantine workers, a few steps, once per aggregator:
                ``flag`` (tree Gram + combine), ``bulyan`` (tree Gram +
                Bulyan selection + coordinate statistics) and
                ``multi_krum`` (tree Gram + Krum scores + combine); before
                each run the kernels' launch counters are zeroed, after it
                each of the run's kernels must have launched once per step;
     train_comm -- the same main path under the worker->server codecs
                (TRAIN_COMM_RUNS): flag x countsketch (the sketch feeds
                the Gram; never decoded; peak below the no-codec flag run's
                plus 8 GB), flag x signsgd and multi_krum x topk (error
                feedback in place), bulyan x countsketch (decoded, no EF),
                flag x signsgd under churn for 6 steps (worker 0's frozen
                EF row resumes at step 5); each kernel of the run once a
                step and no other, comm_bits and comm_ratio the exact cost
                models' counts; step time, peak memory, launches;
     resume -- crash-safe checkpoints on the main path: the flag run
                again through the launcher with ``--ckpt-dir`` (every 2
                steps; 4.34 GB a checkpoint), its steps equal to the train
                phase's; step 4's checkpoint torn as a crash mid-save
                leaves it; a fresh ``setup()`` resumes from step 2 and
                steps 2-3 must equal the first execution's bit for bit
                (losses, |g|, FA weights, the parameters' SHA-256), the
                tree Gram and the combine once a step; save and load
                seconds, bytes on disk and the filesystem; then
                ``launch.elastic --verify`` on the card at the reduced
                size (ELASTIC_RUNS: kills at steps 5 and 9, replay and
                trajectory equal within 1e-6);
  5. serve   -- the port's serving path at full width, bf16 compute:
                (a) ``repro_torch.launch.serve.main`` with the JAX
                launcher's defaults (batch 4, prompt 64, 32 generated
                tokens): decode tok/s; (b) ``build_prefill_step`` scoring
                4 requests x 2048 tokens, the first 64 of each being (a)'s
                prompt: the flash-attention kernel must launch once per
                layer (32) per call and nothing else may launch; (c) the
                prefill logits at (a)'s last prompt position against the
                decode path's logits there, and (a)'s first generated token
                against the prefill argmax; then one decode step and one
                prefill call under ``torch.profiler`` (device busy time,
                idle share, operator calls);
  6. check   -- the same train CLI at the reduced size on the card (the
                kernels) and on the CPU (the plain versions) from the same
                weights and tokens must agree, for flag and for each of the
                seven baseline rules; ``aggregate_tree`` under a mask, card
                against CPU, for each baseline rule; the serving path at
                the reduced size, card against CPU (prefill logits, decode
                logits, the greedy token chain); the reduced train CLI
                under every codec x {flag, multi_krum, median, bulyan},
                with and without EF where the codec allows it, and signSGD
                with EF under a crash and under churn, card against CPU
                (losses, d, parameters; the sketch maps equal on both);
                and the looped ``tree_gram(fused=False)``, card against
                CPU;
  7. byzantine -- the paper's CNN training loop
                (``repro_torch.launch.byzantine.run_byzantine_training``)
                on the card: p = 15, f = 3 with the driver's defaults, and
                p = 30, f = 7 and p = 60, f = 14 as
                ``benchmarks/scalability.py`` sets them, each under flag,
                multi_krum and mean; one run per augmentation scheme with
                ``benchmarks/augmentation.py``'s settings;
                ``benchmarks/comm_loss.py``'s codec rows (none, signsgd,
                topk, countsketch x flag, multi_krum, mean; p = 15, f = 3,
                random x5, 100 steps); one JSON line a run (us_per_step,
                accuracy trajectory, comm_ratio, peak memory, launches):
                without a codec none of the port's kernels may launch (the
                loop's rules are plain, as the reference's are), with one
                the tree Gram and the combine launch once a step (and
                Multi-Krum's scores); then the same loop at a small size
                on the card and on the CPU from the same weights and
                draws, for all 11 rules under no attack and sign_flip and
                every codec under flag, multi_krum and the median: picks
                equal, updates and parameters within the stated
                tolerance;
  8. timing  -- each kernel at the shape its path gives it, against its
                plain version, checked for agreement and timed with CUDA
                events beside the plain version, one PyTorch library call
                computing the same function where there is one (a
                yardstick the port never calls), and the card's bound for
                the work: the aggregation kernels at W = 15,
                N = 361,821,120, fp32; flash attention at one layer of the
                prefill (B = 4, H = 15, KV = 5, S = 2048, d = 64, bf16,
                causal), with its share of the bound, its time over the
                library's and its useful TFLOP/s; the per-matrix Gram as
                the looped tree Gram over smollm-360m's 11 leaves (its
                launches counted on that call); the coordinate statistics
                for each op, the masked median and Bulyan's 9-row MeaMed,
                each with its share of the bound and its network width's
                ptxas lines; the selections' device time from CUDA graphs,
                their back-to-back time (which follows the host's
                wrapper) beside it, the launch floor (an empty kernel
                timed the same way) and the Krum scores' one-warp body
                against the one-block body in turns; and ``breakdown``: each
                rule's ``aggregate_tree`` (flag, bulyan, multi_krum and
                the four coordinate rules), the FA solve and AdamW, timed
                alone on the main path's shapes; and ``codecs``: each
                codec's encode, decode and EF round at full width, row by
                row as the round runs, ``compressed_aggregate`` for each
                train_comm run, the tree Gram at the sketch's shape
                (15 x 22,613,820) against its byte bound, and
                CountSketch's deterministic encode (the slot table) beside
                one atomic ``index_add_`` a row, each run twice.

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
BF16_FLOP_PER_S = 989e12        # H100 SXM dense bf16 tensor cores; bf16
                                # products accumulate exactly in fp32
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
# the codec runs at full width: (aggregator, codec, faults, steps, the
# kernels each step must launch once).  The churn run takes 6 steps: its
# default schedule drops worker 0 for steps 0-4 and, at step 5, takes it
# back (its frozen EF row resumes) and drops worker 1.
TRAIN_COMM_RUNS = (
    ("flag", "countsketch", "none", TRAIN_STEPS, ("tree_gram",
                                                  "weighted_sum")),
    ("flag", "signsgd", "none", TRAIN_STEPS, ("tree_gram", "weighted_sum")),
    ("multi_krum", "topk", "none", TRAIN_STEPS, ("tree_gram", "krum_scores",
                                                  "weighted_sum")),
    ("bulyan", "countsketch", "none", TRAIN_STEPS, ("tree_gram",
                                                    "bulyan_select",
                                                    "coord_stats")),
    ("flag", "signsgd", "churn", 6, ("tree_gram", "weighted_sum")))
# exact worker->server bits a step at full width (W = 15, N = 361,821,120,
# the codecs' cost models) and comm_ratio to 2 decimals
COMM_BITS = {"none": 173_674_137_600, "countsketch": 10_854_633_600,
             "signsgd": 5_578_736_160, "topk": 19_802_399_400}
COMM_RATIO = {"none": 1.0, "countsketch": 16.0, "signsgd": 31.13,
              "topk": 8.77}
SKETCH_COLS = 22_613_820       # sum over the leaves of round(n / 16)
# a decoded (W, N) fp32 stack would add 21.7 GB; the sketch route may add
# at most this much to the no-codec flag run's peak
SKETCH_PEAK_MARGIN = 8 * 2 ** 30
BASELINES = ("krum", "multi_krum", "median", "trimmed_mean", "meamed",
             "phocas", "bulyan")
SOURCES = ("gram", "weighted_sum", "coord_stats", "krum_select",
           "flash_attn")
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
# (9, 15: Bulyan's theta and the paper's W; 16 / 17: the last exact and the
# first padded network width; 64 padded)
COORD_W, COORD_N, COORD_F = ((1, 2, 3, 8, 9, 15, 16, 17, 64), 2_000_003,
                             (0, 1, 3, 40))
# (1: scores +inf; 16 / 17 and 32 / 33: the last and first of each network
# width of the one-warp bodies, 33 the first one-block body)
SELECT_W = (1, 2, 3, 4, 8, 15, 16, 17, 31, 32, 33, 64)
# Kernel and plain version sort alike and sum in the same order (ascending,
# sequential fp32, one IEEE division), so the median must be bit-equal and
# the means may differ only by an fp32 rounding of a sum that another
# compiler contracted differently: |diff| <= 2^-20 * (|ref| + max|x|).
COORD_TOL = 2.0 ** -20
SCORE_TOL = 2.0 ** -20          # Krum scores, relative, same reasoning
# flash attention: |o - want| <= FLASH_ATOL + FLASH_RTOL |want|, want being
# the plain version in fp32 on the same inputs (bf16 inputs upcast exactly;
# the kernel computes in fp32 too).  fp32: sums in another order, rtol =
# atol = 2e-4 as the JAX kernel tests hold it (tests/test_kernels.py:
# 157-159).  bf16 adds the kernel's one rounding of its output to bf16, at
# most 2^-8 relative.  Each sweep case also holds two wrong outputs
# against the same limit, which must fail it: all zeros, and the kernel's
# output off by 2^-6 (a normaliser 1.6 % wrong).  Read on an H100 80GB HBM3
# at 700 W over the sweep: a sound output used at most 0.912 of the limit
# in bf16 (the output rounding alone reaches 2^-8 / (2^-8 + 2e-4) = 0.95)
# and 0.012 in fp32; a zeroed output at least 147 times it, one off by
# 2^-6 at least 2.49 times it.
FLASH_ATOL = 2e-4
FLASH_RTOL = {"float32": 2e-4, "bfloat16": 2e-4 + 2.0 ** -8}
FLASH_WRONG_SCALE = 1 + 2.0 ** -6
FLASH_D = (64, 96, 128, 256)
FLASH_HEADS = ((3, 3), (6, 2), (8, 1))          # (H, KV): H / KV = 1, 3, 8
FLASH_SEQ = ((256, 256), (1, 4096), (100, 100), (37, 1000), (300, 77))
FLASH_MASKS = ((True, None), (False, None), (True, 16), (True, 64),
               (False, 16), (False, 64))
# per-matrix Gram sweep: widths p, ragged lengths n, element strides
GRAM_P, GRAM_N, GRAM_STRIDE = (1, 2, 7, 15, 16, 33, 64), (1, 1000,
                                                          1_000_003), (1, 2, 7)
# serving: the JAX launcher's defaults, and a prefill of SmolLM's training
# context for 4 requests
SERVE_ARGV = ["--arch", "smollm-360m", "--batch", "4", "--prompt-len", "64",
              "--gen", "32"]
PREFILL_B, PREFILL_S = 4, 2048
# Prefill logits against decode logits at one position, bf16 compute: the
# logits are bf16 values (one ulp is 2^-5 = 0.031 for |logit| in [4, 8);
# their RMS is ~1 with these random weights), and the two paths round
# their bf16 activations after sums taken in another order (one GEMM over
# the sequence against one row at a time; the flash kernel against the
# decode path's matmuls), so a few ulps of the largest logits apart after
# 32 layers of such roundings; the tolerance is 8 of those ulps.
SERVE_LOGIT_TOL = 0.25
# fp32 compute (the reduced size): sums in another order only
SMOKE_LOGIT_TOL = 1e-4
# the CNN loop: (p, f, ByzRunConfig overrides) of the card's runs, each
# under BYZ_RULES; the scalability runs as benchmarks/scalability.py sets
# them, and one run per scheme as benchmarks/augmentation.py sets it
BYZ_RULES = ("flag", "multi_krum", "mean")
BYZ_RUNS = ((15, 3, {}),
            (30, 7, {"batch": 32, "attack_kw": {"scale": 5.0}}),
            (60, 14, {"batch": 32, "attack_kw": {"scale": 5.0}}))
BYZ_AUGMENT = ("lotka_volterra", "cat_map", "smooth_cat_map")
BYZ_AUGMENT_KW = {"f": 0, "aggregator": "flag", "steps": 100,
                  "attack": "none", "augment_workers": 3,
                  "gaussian_sigma": 0.10}
# card against CPU: the same driver, weights and draws at a small size
BYZ_CHECK_KW = {"p": 7, "f": 1, "batch": 8, "steps": 4, "eval_every": 2}
BYZ_CHECK_RULES = ("flag", "pca", "mean", "geomed", "krum", "multi_krum",
                   "median", "trimmed_mean", "meamed", "phocas", "bulyan")
# benchmarks/comm_loss.py's codec rows: p = 15, f = 3, random x5, 100
# steps, each codec under each rule; then card against CPU per codec
BYZ_COMM_CODECS = ("none", "signsgd", "topk", "countsketch")
BYZ_COMM_RULES = ("flag", "multi_krum", "mean")
BYZ_COMM_KW = {"p": 15, "f": 3, "steps": 100, "attack": "random",
               "attack_kw": {"scale": 5.0}}
BYZ_COMM_CHECK_CODECS = ("identity", "signsgd", "topk", "countsketch")
BYZ_COMM_CHECK_RULES = ("flag", "multi_krum", "median")
# the biased codecs are discontinuous in their input (a sign at ~0, the
# k-th largest |h|): card and CPU differ in their gradients' last bits, so
# a few decoded coordinates differ by a whole value and error feedback
# carries them on.  Held there: d and the parameters' displacement to the
# FA tolerance in all but this share of their coordinates and within
# BIASED_NORM_TOL in norm (the CNN loop's parameters: within the largest
# change and BIASED_NORM_TOL in norm; tests/test_torch_train_comm.py holds
# the port to JAX alike).  Read on an H100 80GB HBM3 at 700 W: shares up to
# 1.6e-4 (the CNN's first signSGD step, 11 of 67,642 coordinates) and
# 2.9e-5 (the reduced train), norms up to 1.25e-2.
BIASED = ("signsgd", "topk")
BIASED_SHARE, BIASED_NORM_TOL = 1e-3, 2e-2
# resume: the train phase's flag run again, checkpointed every 2 steps; a
# checkpoint of it holds params, AdamW's mu and nu (fp32) and its count
RESUME_EVERY = 2
RESUME_DATA_BYTES = 3 * MAIN_N * 4 + 4
# the elastic driver at the reduced size on the card: (extra argv); each
# run verifies 12 steps killed at 5 and 9, checkpointed every 3
ELASTIC_ARGV = ["--verify", "--steps", "12", "--kill-at", "5,9",
                "--ckpt-every", "3"]
ELASTIC_RUNS = (
    ["--aggregator", "flag", "--attack", "sign_flip", "--byzantine", "1",
     "--codec", "signsgd"],
    ["--aggregator", "flag", "--codec", "countsketch"],
    ["--aggregator", "krum", "--codec", "identity"],
    ["--aggregator", "flag", "--codec", "signsgd", "--faults", "rejoin",
     "--fault-arg", "at=3", "--fault-arg", "down=4"],
    # the sketch decoded (no Gram feed) into the coordinate statistics
    ["--aggregator", "bulyan", "--workers", "8", "--byzantine", "1",
     "--codec", "countsketch"])


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line; a phase's line also carries ``t_s``, the seconds
    since the script started (where the time limit goes)."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 1)}
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


def coord_ptxas(lines) -> dict:
    """``coord_stats_kernel``'s ptxas lines by network width and dtype:
    {"15/float32": ["64 registers, ...", <a spill line, if any>], ...}."""
    import re
    out = {}
    for line in lines:
        m = re.search(r"coord_stats_kernelILi(\d+)E(f|13__nv_bfloat16)E",
                      line)
        if m:
            key = f"{m.group(1)}/" + ("float32" if m.group(2) == "f"
                                      else "bfloat16")
            out.setdefault(key, []).append(line.split(": ", 1)[-1])
    return dict(sorted(out.items(), key=lambda kv: (int(kv[0].split("/")[0]),
                                                    kv[0])))


def phase_build():
    """Builds every source; returns coord_stats' ptxas lines by width."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    built = _build.build_all(SOURCES)
    by_width = coord_ptxas(built["coord_stats"].ptxas)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "kernels": {n: {"library": str(b.path.relative_to(ROOT)),
                          "nvcc_s": b.seconds, "ptxas": list(b.ptxas)}
                      for n, b in built.items()},
          "coord_stats_by_width": by_width,
          "coord_stats_spills_at_exact_widths": sorted(
              k for k, v in by_width.items()
              if int(k.split("/")[0]) <= 16 and any("spill" in x for x in v))})
    # the bf16 tensor-core body of flash attention, one line a head dim
    for line in built["flash_attn"].ptxas:
        if "flash_fwd_tc" in line:
            print(f"ptxas {line}", flush=True)
    return by_width


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
    """Squared distances of W random points, the first ``min(dup, W)``
    identical (exact score ties, as the zero attack makes them)."""
    import torch
    P = torch.randn((W, 6), generator=gen, device=DEVICE)
    P[:min(dup, W)] = 0.0
    D = ((P[:, None, :] - P[None, :, :]) ** 2).sum(-1)
    return D.fill_diagonal_(0.0).contiguous()


def score_rel_err(s, s_plain) -> float:
    """max |s - s_plain| / |s_plain|, equal values (+inf at W = 1) 0."""
    import torch
    diff = torch.where(s == s_plain, 0.0, (s - s_plain).abs())
    return float((diff / s_plain.abs().clamp(min=1e-30)).max())


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
                rel = score_rel_err(s, s_plain)
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
    from repro_torch.kernels.flash_attn import kernel as flash_k
    from repro_torch.kernels.gram import kernel as gram_k
    from repro_torch.kernels.weighted_sum import kernel as wsum_k

    def attr(mod, name="launches"):
        return (lambda: getattr(mod, name),
                lambda: setattr(mod, name, 0))

    def key(name):
        return (lambda: cs_k.launches[name],
                lambda: cs_k.launches.__setitem__(name, 0))
    return {"tree_gram": attr(gram_k), "weighted_sum": attr(wsum_k),
            "flash_attn": attr(flash_k), "gram": attr(gram_k, "gram_launches"),
            **{n: key(n) for n in cs_k.launches}}


def phase_train():
    """The main path once per aggregator of TRAIN_RUNS; returns, per
    kernel, its launches in the run that drives it and that run's
    aggregator, each run's peak memory, and the flag run's history."""
    import torch
    from repro_torch.launch import train

    counters = _counters()
    launches, peaks = {}, {}
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
        peaks[agg] = peak
        if agg == "flag":
            flag_hist = [{k: h[k] for k in ("loss", "grad_global_norm",
                                            "fa_weights", "step_s")}
                         for h in hist]
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
    return launches, peaks, flag_hist


def phase_train_comm(flag_peak: int):
    """The main path under each codec run of TRAIN_COMM_RUNS at full
    width: every listed kernel launched once a step and no other; the
    Gram-feed run (flag x countsketch) never decodes and peaks below the
    no-codec flag run's peak plus SKETCH_PEAK_MARGIN; comm_bits and
    comm_ratio are the cost models' exact counts (scaled by the active
    fraction under churn); under churn worker 0's EF row stays frozen (at
    zero) while it is out and resumes at step 5, when worker 1's freezes."""
    import torch
    from repro_torch.comm import compressors
    from repro_torch.launch import train

    counters = _counters()
    decodes = {"n": 0}
    real_decode = compressors.CountSketchCodec.decode_leaf

    def counting_decode(self, *a, **k):
        decodes["n"] += 1
        return real_decode(self, *a, **k)
    compressors.CountSketchCodec.decode_leaf = counting_decode
    try:
        for agg, codec, faults, steps, kernels in TRAIN_COMM_RUNS:
            argv = [a for a in TRAIN_ARGV] + [
                "--aggregator", agg, "--codec", codec, "--faults", faults,
                "--device", DEVICE]
            argv[argv.index("--steps") + 1] = str(steps)
            gc.collect()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            for _, reset in counters.values():
                reset()
            decodes["n"] = 0
            ef_rows = []

            def on_step(t, state, m):
                if faults == "churn":
                    ef_rows.append((float(state.ef[0].abs().max()),
                                    float(state.ef[1].abs().max()),
                                    float(state.ef[1].double().sum())))
            hist = train.main(argv, on_step=on_step)
            counts = {n: get() for n, (get, _) in counters.items()}
            peak = torch.cuda.max_memory_allocated()
            what = f"train_comm {agg} x {codec} ({faults})"
            losses = [h["loss"] for h in hist]
            if len(hist) != steps or not all(math.isfinite(x)
                                             for x in losses) or not all(
                    math.isfinite(c) for h in hist for c in h["fa_weights"]):
                raise AssertionError(f"{what}: losses {losses}")
            want = {n: (steps if n in kernels else 0) for n in counts}
            if counts != want:
                raise AssertionError(f"{what}: kernel launches {counts}, "
                                     f"want {want} (one a step)")
            gram_feed = codec == "countsketch" and agg != "bulyan"
            if (decodes["n"] == 0) != gram_feed and codec == "countsketch":
                raise AssertionError(f"{what}: {decodes['n']} decode calls")
            if gram_feed and peak >= flag_peak + SKETCH_PEAK_MARGIN:
                raise AssertionError(f"{what}: peak {peak} B, no-codec flag "
                                     f"run {flag_peak} B")
            for h in hist:
                frac = h.get("active_workers", MAIN_W) / MAIN_W
                if not (math.isclose(h["comm_bits"], COMM_BITS[codec] * frac,
                                     rel_tol=1e-12)
                        and (faults != "none" or
                             h["comm_bits"] == COMM_BITS[codec])
                        and round(h["comm_ratio"], 2) == COMM_RATIO[codec]):
                    raise AssertionError(f"{what}: comm_bits "
                                         f"{h['comm_bits']}, comm_ratio "
                                         f"{h['comm_ratio']}")
            if faults == "churn":
                actives = [h["active_workers"] for h in hist]
                row0, row1 = [r[0] for r in ef_rows], [r[2] for r in ef_rows]
                if actives != [MAIN_W - 1] * steps or any(row0[:5]) or \
                        not row0[5] or row1[5] != row1[4]:
                    raise AssertionError(
                        f"{what}: active {actives}, EF row 0 max|e| {row0}, "
                        f"row 1 sums {row1}")
            steady = [h["step_s"] for h in hist[1:]]
            emit({"phase": "train_comm", "aggregator": agg, "codec": codec,
                  "faults": faults, "argv": argv, "losses": losses,
                  "step_s": [h["step_s"] for h in hist],
                  "step_s_after_warmup": sum(steady) / len(steady),
                  "max_memory_allocated_bytes": peak,
                  "no_codec_flag_peak_bytes": flag_peak,
                  "comm_bits": [h["comm_bits"] for h in hist],
                  "comm_ratio": hist[-1]["comm_ratio"],
                  "active_workers": [h.get("active_workers", MAIN_W)
                                     for h in hist],
                  "countsketch_decode_calls": decodes["n"],
                  "ef_rows_0_1_max_abs": [r[:2] for r in ef_rows],
                  "launches": counts})
            del hist
    finally:
        compressors.CountSketchCodec.decode_leaf = real_decode
    gc.collect()
    torch.cuda.empty_cache()


def _mount_of(path: str) -> str:
    """The filesystem ``path`` lies on: "<mount point> (<type>)"."""
    import os
    path = os.path.realpath(path)
    with open("/proc/mounts") as f:
        mounts = [line.split()[1:3] for line in f]
    mnt, fstype = max((m for m in mounts if path == m[0] or path.startswith(
        m[0].rstrip("/") + "/")), key=lambda m: len(m[0]))
    return f"{mnt} ({fstype})"


def _max_diff(hs, gs) -> float:
    """Largest |difference| of the losses, |g| and FA weights of two runs'
    step records (inf when their step counts differ)."""
    if len(hs) != len(gs):
        return math.inf
    return max(abs(a - b) for h, g in zip(hs, gs) for a, b in zip(
        [h["loss"], h["grad_global_norm"], *h["fa_weights"]],
        [g["loss"], g["grad_global_norm"], *g["fa_weights"]]))


def _flat_sha256(state) -> str:
    import hashlib
    return hashlib.sha256(state.flat.detach().cpu().numpy().tobytes()
                          ).hexdigest()


def phase_resume(flag_hist):
    """(a) The train phase's flag run at full width again, through the
    launcher with ``--ckpt-dir --ckpt-every 2``: its losses, |g| and FA
    weights must equal the train phase's exactly (``flag_hist``; the step
    is deterministic).  Then step 4's checkpoint is torn as
    ``launch.elastic`` tears one (half the npz, no marker), and a fresh
    ``setup()`` resumes from step 2 and runs steps 2-3: losses, |g| and FA
    weights equal to the first execution's (max |diff| = 0), the final
    parameters' SHA-256 equal, the tree Gram and the combine launched once
    in each resumed step and nothing else.  One line: save and load
    seconds, bytes on disk, the device memory a save adds, step times
    before and after.  (b) ``launch.elastic --verify --device cuda`` for
    each of ELASTIC_RUNS at the reduced size: ok, kills [5, 9].  Every
    checkpoint dir is deleted at the end, also on failure."""
    import os
    import shutil
    import tempfile

    import torch
    from repro_torch.launch import elastic, train

    counters = _counters()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resume_")
    try:
        argv = TRAIN_ARGV + ["--aggregator", "flag", "--device", DEVICE,
                             "--ckpt-dir", tmp, "--ckpt-every",
                             str(RESUME_EVERY)]
        saves = []
        real_save = train.save_checkpoint

        def measured_save(*a, **k):
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            out = real_save(*a, **k)
            saves.append(torch.cuda.max_memory_allocated() - base)
            return out
        hashes = {}

        def on_step(t, state, m):
            if t == TRAIN_STEPS - 1:
                hashes[len(hashes)] = _flat_sha256(state)
        train.save_checkpoint = measured_save
        try:
            gc.collect()
            torch.cuda.empty_cache()
            first = train.main(argv, on_step=on_step)
            step2 = os.path.join(tmp, "step_00000002")
            disk = {n: os.path.getsize(os.path.join(step2, n))
                    for n in sorted(os.listdir(step2))}
            elastic.tear_checkpoint(tmp, TRAIN_STEPS)
            gc.collect()
            torch.cuda.empty_cache()
            args = train._parser().parse_args(argv)
            run = train.setup(args)
            for _, reset in counters.values():
                reset()
            resumed = train.run_steps(args, run, on_step=on_step)
            counts = {n: get() for n, (get, _) in counters.items()}
        finally:
            train.save_checkpoint = real_save
        vs_train = _max_diff(first, flag_hist)
        vs_first = _max_diff(resumed, first[RESUME_EVERY:])
        want = {n: (TRAIN_STEPS - RESUME_EVERY
                    if n in TRAIN_RUNS["flag"] else 0) for n in counts}
        line = {"phase": "resume", "argv": argv,
                "tmpdir_filesystem": _mount_of(tmp),
                "resumed_from": run.step0,
                "steps_first": [h["step"] for h in first],
                "steps_resumed": [h["step"] for h in resumed],
                "losses_first": [h["loss"] for h in first],
                "losses_resumed": [h["loss"] for h in resumed],
                "max_abs_diff_vs_train_phase": vs_train,
                "max_abs_diff_resumed_vs_first": vs_first,
                "params_sha256_first": hashes.get(0),
                "params_sha256_resumed": hashes.get(1),
                "save_s": [h["save_s"] for h in first + resumed
                           if "save_s" in h],
                "load_s": run.load_s,
                "state_bytes_on_disk": disk,
                "predicted_data_bytes": RESUME_DATA_BYTES,
                "device_bytes_added_by_a_save": saves,
                "step_s_first": [h["step_s"] for h in first],
                "step_s_resumed": [h["step_s"] for h in resumed],
                "train_phase_step_s": [h["step_s"] for h in flag_hist],
                "launches_resumed": counts}
        emit(line)
        if (vs_train != 0 or vs_first != 0 or run.step0 != RESUME_EVERY
                or len(hashes) != 2 or hashes[0] != hashes[1]
                or counts != want
                or [h["step"] for h in resumed] != list(
                    range(RESUME_EVERY, TRAIN_STEPS))):
            raise AssertionError(
                f"resume: diff vs the train phase {vs_train}, resumed vs "
                f"first {vs_first}, resumed from {run.step0}, hashes "
                f"{hashes}, launches {counts}, want {want}")
        del first, resumed, run
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    # (b) the elastic driver on the card
    for extra in ELASTIC_RUNS:
        tmp = tempfile.mkdtemp(prefix="chip_smoke_elastic_")
        try:
            for _, reset in counters.values():
                reset()
            argv = ELASTIC_ARGV + extra + ["--device", DEVICE,
                                           "--ckpt-dir", tmp]
            out = elastic.main(argv)
            counts = {n: get() for n, (get, _) in counters.items()}
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        emit({"phase": "resume_elastic", "argv": argv,
              **{k: out[k] for k in ("ok", "rounds", "kills", "replayed",
                                     "replay_mismatch", "max_diff")},
              "launches": {n: c for n, c in counts.items() if c}})
        if not out["ok"] or out["kills"] != [5, 9]:
            raise AssertionError(f"resume_elastic {argv}: {out}")


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
    emit({"phase": "check", "train": out, "masked_aggregate_tree": masked,
          "train_comm": check_train_comm(),
          "serve": check_serve(), "looped_tree_gram": check_looped_gram()})


def _fa_close(got, want, loose: bool, what: str, key: str) -> dict:
    """``got`` within the FA tolerance of ``want`` (d, or a parameter
    displacement), 5e-4 ||want|| + 5e-3 |want| at every coordinate; with
    ``loose``, at all but BIASED_SHARE of the coordinates and within
    BIASED_NORM_TOL in norm.  Raises, else returns the errors."""
    import torch
    scale = float(torch.linalg.vector_norm(want)) + 1e-12
    bad = float(((got - want).abs() > 5e-4 * scale + 5e-3 * want.abs())
                .float().mean())
    norm = float(torch.linalg.vector_norm(got - want)) / scale
    ok = bad <= BIASED_SHARE and norm <= BIASED_NORM_TOL if loose \
        else bad == 0.0
    err = {f"{key}_bad_share": bad, f"{key}_norm": norm}
    if not ok:
        raise AssertionError(f"{what}: {err}")
    return err


def _theta_close(got, want, base, loose: bool, what: str) -> dict:
    """The parameters within 1 % of the largest change the CPU run made
    from ``base``; with ``loose``, within the largest change and
    BIASED_NORM_TOL of the displacement in norm."""
    import torch
    change = float((want - base).abs().max())
    norm = float(torch.linalg.vector_norm(got - want)
                 / torch.linalg.vector_norm(want - base))
    of_change = float((got - want).abs().max()) / change
    ok = of_change <= 1.0 and norm <= BIASED_NORM_TOL if loose \
        else of_change <= 0.01
    err = {"theta_of_change": of_change, "theta_norm": norm}
    if not ok:
        raise AssertionError(f"{what}: {err}")
    return err


def _train_cli_record(argv, faults_kw=None):
    """The train CLI's loop on ``argv`` (``setup`` and ``run_steps``,
    ``faults_kw`` the schedule's keyword arguments): per step the history
    record, d (from SGD's momentum, d_t = mu_t - 0.9 mu_{t-1}) and the
    parameters, on the CPU; the parameters before the first step; the
    run's namespace."""
    from repro_torch.launch import train
    args = train._parser().parse_args(argv)
    run = train.setup(args, faults_kw)
    base = run.state.flat.cpu().clone()
    rec, prev = [], {"mu": None}

    def on_step(t, state, m):
        mu = state.opt_state["mu"].cpu().clone()
        d = mu if prev["mu"] is None else mu - 0.9 * prev["mu"]
        prev["mu"] = mu
        rec.append((d, state.flat.cpu().clone()))
    hist = train.run_steps(args, run, on_step)
    return hist, rec, base, run


# lambda 0: at lambda = W the reduced run's FA solution is near-degenerate
# (weights ~1e-3 of mixed sign that jump from step to step), and a
# rounding-level difference moved them past the FA tolerance on the card
# (top-k without EF); FA at lambda = W is held card against CPU by
# phase_check's rules
TRAIN_CHECK_ARGV = ["--debug", "--seq", "32", "--workers", "8",
                    "--per-worker-batch", "2", "--byzantine", "1",
                    "--attack", "sign_flip", "--optimizer", "sgd",
                    "--lam", "0", "--log-every", "100"]


def _train_check_cases():
    """(aggregator, codec, --no-ef, (faults, keyword arguments) or None)."""
    cases = [(agg, codec, no_ef, None)
             for agg in ("flag", "multi_krum", "median", "bulyan")
             for codec in ("identity", "signsgd", "topk", "countsketch")
             for no_ef in ((False, True) if codec in BIASED else (False,))]
    return cases + [("median", "signsgd", False, ("crash", {"at": 2})),
                    ("median", "signsgd", False, ("churn", {"period": 2}))]


def _train_case(agg, codec, no_ef, faults, worst: dict) -> None:
    """One check_train_comm case: the run on the card and on the CPU."""
    import torch
    from repro_torch.comm import compressors
    argv = TRAIN_CHECK_ARGV + ["--aggregator", agg, "--codec", codec,
                               "--steps", "6" if faults else "3"]
    argv += ["--no-ef"] * no_ef + (["--faults", faults[0]] if faults else [])
    kw = faults[1] if faults else None
    g_hist, g_rec, base, g_run = _train_cli_record(argv + ["--device",
                                                           DEVICE], kw)
    c_hist, c_rec, c_base, c_run = _train_cli_record(argv + ["--device",
                                                             "cpu"], kw)
    what = f"check train_comm {agg} x {codec} no_ef={no_ef} {faults}"
    if not torch.equal(base, c_base):
        raise AssertionError(f"{what}: initial weights differ")
    if codec == "countsketch":
        card, cpu = (compressors.get_codec(r.tc.comm) for r in (g_run, c_run))
        for i, n in enumerate(g_run.state.layout.sizes):
            for a, b in zip(card.maps(n, i, DEVICE), cpu.maps(n, i, "cpu")):
                if not torch.equal(a.cpu(), b):
                    raise AssertionError(f"{what}: sketch maps differ, "
                                         f"leaf {i}")
        worst["countsketch_maps_equal_card_cpu"] = True
    # Bulyan's MeaMed keeps the values nearest a median: a near tie that
    # rounding decides moves a coordinate by a whole gap
    loose = codec in BIASED or agg == "bulyan"
    for t, (g, c, (gd, gp), (cd, cp)) in enumerate(zip(
            g_hist, c_hist, g_rec, c_rec)):
        at = f"{what} step {t}"
        if not math.isclose(g["loss"], c["loss"], rel_tol=1e-4) or \
                g.get("active_workers") != c.get("active_workers") or \
                g["comm_bits"] != c["comm_bits"]:
            raise AssertionError(f"{at}: loss {g['loss']} vs {c['loss']}, "
                                 f"{g} vs {c}")
        for a, b in zip(g["fa_weights"], c["fa_weights"]):
            if abs(a - b) > 5e-4 + 5e-3 * abs(b):
                raise AssertionError(f"{at}: fa_weights {g['fa_weights']} "
                                     f"vs {c['fa_weights']}")
        errs = {**_fa_close(gd, cd, loose, at, "d"),
                **_fa_close(gp - base, cp - base, loose, at, "step")}
        key = "loose" if loose else "exact"
        worst[key] = {k: max(v, worst.get(key, {}).get(k, 0.0))
                      for k, v in errs.items()}


def check_train_comm() -> dict:
    """The reduced train CLI on the card and on the CPU from the same
    weights and tokens, for every codec under flag, multi_krum, median and
    bulyan, with and without error feedback where the CLI allows it
    (signSGD and top-k carry it unless --no-ef); then signSGD with EF
    under a crash at step 2 and under churn with period 2, over 6 steps
    (a leave and a rejoin inside the run), under the median.  f = 1 of
    W = 8 (Bulyan keeps 4 values a coordinate: no tie of the W = 8, f = 2
    case).

    Tolerances: the loss to rel 1e-4 and the combination weights to the FA
    tolerance, 5e-4 + 5e-3 |c|, as the rules' check above; d and the
    parameters' displacement from the first step's weights to the FA
    tolerance over their norms (``_fa_close``; under a biased codec and
    under Bulyan loosely); active counts and comm_bits equal.
    CountSketch's maps must be equal on both devices."""
    worst = {}
    cases = _train_check_cases()
    for case in cases:
        _train_case(*case, worst)
    return {"cases": len(cases), "byzantine": 1, "workers": 8,
            "loss_rel_tol": 1e-4, "weights_tol": "5e-4 + 5e-3 |c|",
            "d_and_step_tol": "5e-4 ||.|| + 5e-3 |.|",
            "biased_share": BIASED_SHARE, "biased_norm_tol": BIASED_NORM_TOL,
            "worst": worst}


def phase_byzantine(smi):
    """The paper's CNN loop on the card: BYZ_RUNS x BYZ_RULES, one run per
    augmentation scheme, and benchmarks/comm_loss.py's codec rows
    (BYZ_COMM_CODECS x BYZ_COMM_RULES), each after the kernels' counters
    are zeroed (without a codec the loop must launch none of them; with
    one, the Gram path's kernels once a step), one JSON line a run; one
    step of p = 15 and of p = 60 under flag, profiled; then the card
    against the CPU (``check_byzantine``)."""
    import torch
    from repro_torch.launch.byzantine import (ByzRunConfig,
                                              run_byzantine_training)

    counters = _counters()
    # warm-up: the first call on the card sets up its libraries' handles
    run_byzantine_training(ByzRunConfig(steps=2, eval_every=1),
                           device=DEVICE)
    runs = [dict(p=p, f=f, aggregator=a, **kw) for p, f, kw in BYZ_RUNS
            for a in BYZ_RULES]
    runs += [dict(augment_scheme=s, **BYZ_AUGMENT_KW) for s in BYZ_AUGMENT]
    runs += [dict(codec=c, aggregator=a, **BYZ_COMM_KW)
             for c in BYZ_COMM_CODECS for a in BYZ_COMM_RULES]
    for kw in runs:
        cfg = ByzRunConfig(**kw)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for _, reset in counters.values():
            reset()
        out = run_byzantine_training(cfg, device=DEVICE)
        counts = {n: get() for n, (get, _) in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        steps = [t for t in range(1, cfg.steps + 1)
                 if t % cfg.eval_every == 0 or t == cfg.steps]
        accs = [a for _, a in out["trajectory"]]
        # no codec: the flat plain rules, no kernel; a codec: the Gram path
        # (tree Gram, combine, and Multi-Krum's scores) once a step
        used = () if cfg.codec == "none" else (
            ("tree_gram", "weighted_sum")
            + (("krum_scores",) if cfg.aggregator == "multi_krum" else ()))
        want = {n: (cfg.steps if n in used else 0) for n in counts}
        if [t for t, _ in out["trajectory"]] != steps or \
                not all(0.0 <= a <= 1.0 for a in accs) or counts != want:
            raise AssertionError(f"byzantine {kw}: trajectory "
                                 f"{out['trajectory']}, launches {counts}, "
                                 f"want {want}")
        emit({"phase": "byzantine", "card": smi,
              "device_name": torch.cuda.get_device_name(0),
              **{k: getattr(cfg, k) for k in (
                  "p", "f", "aggregator", "attack", "attack_kw", "batch",
                  "steps", "augment_scheme", "augment_workers",
                  "gaussian_sigma", "codec")},
              **{k: out[k] for k in ("us_per_step", "wall_seconds",
                                     "final_accuracy", "trajectory",
                                     "comm_bits_per_step", "comm_ratio")},
              "max_memory_allocated_bytes": peak, "launches": counts})
    emit({"phase": "byzantine_profile", "card": smi,
          **{f"p{p}": profile_byzantine_step(p, f, kw)
             for p, f, kw in (BYZ_RUNS[0], BYZ_RUNS[2])}})
    emit({"phase": "byzantine_check", **check_byzantine()})


def profile_byzantine_step(p: int, f: int, kw: dict) -> dict:
    """One flag step of the CNN loop (per-worker gradients, attack, FA,
    momentum SGD) on its first batch, under ``device_profile``."""
    import torch
    from repro_torch.data.pipeline import step_generator
    from repro_torch.data.synthetic import SyntheticImages
    from repro_torch.launch.byzantine import (ByzRunConfig, aggregator_for,
                                              byzantine_step)
    from repro_torch.models.cnn import cnn_init
    from repro_torch.weights import pack
    cfg = ByzRunConfig(p=p, f=f, **kw)
    theta, layout = pack(cnn_init(torch.Generator().manual_seed(0)), DEVICE)
    mom = torch.zeros_like(theta)
    xs, ys = SyntheticImages().sample(step_generator(0, 0), cfg.batch,
                                      lead=(p,))
    xs, ys = xs.to(DEVICE), ys.to(DEVICE)
    rule = aggregator_for(cfg)

    def step():
        byzantine_step(theta, mom, layout, xs, ys, cfg=cfg, step=0,
                       lr=cfg.lr, rule=rule)
    step()
    return {"aggregator": cfg.aggregator, "batch": cfg.batch,
            **device_profile(step, 5)}


def _byz_picks(rule, G, f):
    import torch
    from repro_torch.core import aggregators as agg_lib
    if rule not in ("krum", "multi_krum", "bulyan"):
        return []
    D = agg_lib.pairwise_sq_dists(G)
    if rule == "bulyan":
        return agg_lib.bulyan_select(D, f).tolist()
    q = 1 if rule == "krum" else max(G.shape[0] - f - 2, 1)
    return torch.argsort(agg_lib.krum_scores(D, f), stable=True)[:q].tolist()


def _byz_case(cfg, worst: dict) -> None:
    """One check_byzantine case: the run on the card and on the CPU."""
    import torch
    from repro_torch.launch.byzantine import run_byzantine_training
    biased = cfg.codec in BIASED
    # the codec route runs FA-N through the Gram kernels, in another
    # summation order than the flat rule, and error feedback carries a
    # step's differences on: its later d follow from the parameters (held
    # every step) and the EF memory, and FA-N's renormalisation by |sum c|
    # amplifies rounding (ROADMAP.md section 3).  So d is held at the first
    # step there (the same parameters), loosely under a biased codec.
    routed = cfg.codec != "none"
    runs = {}
    for dev in (DEVICE, "cpu"):
        rec = []

        def hook(t, G, d, theta, rec=rec):
            rec.append((_byz_picks(cfg.aggregator, G, cfg.f),
                        G.cpu() if t == 0 else None, d.cpu(),
                        theta.cpu().clone()))
        runs[dev] = (run_byzantine_training(cfg, device=dev, on_step=hook),
                     rec)
    (out_g, rec_g), (out_c, rec_c) = runs[DEVICE], runs["cpu"]
    theta0 = rec_c[0][3] + cfg.lr * rec_c[0][2]   # mom_0 = d_0
    for t, (a, b) in enumerate(zip(rec_g, rec_c)):
        what = (f"byzantine check {cfg.aggregator} {cfg.attack} "
                f"{cfg.codec} step {t}")
        if a[0] != b[0]:
            raise AssertionError(f"{what}: picks {a[0]} vs {b[0]}")
        if t == 0 and not biased:      # a biased codec's G is decoded
            g0 = float((a[1] - b[1]).abs().max() / b[1].abs().max())
            if g0 > 1e-4:
                raise AssertionError(f"{what}: G rel err {g0}")
            worst["g0"] = max(worst["g0"], g0)
        errs = _theta_close(a[3], b[3], theta0, biased, what)
        if t == 0 or not routed:
            errs.update(_fa_close(a[2], b[2], biased, what, "d"))
        for k, v in errs.items():
            key = f"{k}_codec" if routed else k
            worst[key] = max(worst.get(key, 0.0), v)
    acc = abs(out_g["final_accuracy"] - out_c["final_accuracy"])
    if acc > (8 if biased else 2) / 1024 or \
            out_g["comm_bits_per_step"] != out_c["comm_bits_per_step"]:
        raise AssertionError(f"byzantine check {cfg}: accuracy "
                             f"{out_g['final_accuracy']} vs "
                             f"{out_c['final_accuracy']}")
    worst["accuracy"] = max(worst["accuracy"], acc)


def check_byzantine() -> dict:
    """The CNN loop at BYZ_CHECK_KW's size on the card and on the CPU, from
    the same weights and draws (one seed), for every rule under no attack
    and sign_flip, and for every codec under flag, multi_krum and the
    median with sign_flip.

    Tolerances.  The selections' picks (Krum, Multi-Krum's q, Bulyan's
    rounds) must be equal at every step.  The first step's gradient matrix
    (the same parameters) to 1e-4 of its largest entry: the card's
    convolutions may run other algorithms than the CPU's (Winograd or FFT
    forms sum fp32 products in another basis; the CPU tests hold two CPU
    libraries to 1e-6).  Each step's update d to the FA tolerance, rtol
    5e-3 / atol 5e-4 of d over its norm (the eigen- and SVD solvers differ;
    ``tests/test_properties.py:114``).  The parameters after every step
    within 1 % of the largest change the CPU run made to any of them, as
    the CPU tests hold the port against JAX; the final accuracy within 2
    of the 1,024 test images.  Under a codec d is held at the first step
    (the parameters every step); under the biased codecs G is the decoded
    matrix and not held, d and the parameters are held loosely
    (``_fa_close``, ``_theta_close``) and the accuracy within 8 images
    (parameters 2 % apart in norm can move an image near a decision
    boundary)."""
    from repro_torch.launch.byzantine import ByzRunConfig
    worst = {"g0": 0.0, "accuracy": 0.0}
    cases = [ByzRunConfig(aggregator=rule, attack=attack, **BYZ_CHECK_KW)
             for attack in ("none", "sign_flip") for rule in BYZ_CHECK_RULES]
    cases += [ByzRunConfig(aggregator=rule, attack="sign_flip", codec=codec,
                           **BYZ_CHECK_KW)
              for codec in BYZ_COMM_CHECK_CODECS
              for rule in BYZ_COMM_CHECK_RULES]
    for cfg in cases:
        _byz_case(cfg, worst)
    return {"config": BYZ_CHECK_KW, "rules": list(BYZ_CHECK_RULES),
            "attacks": ["none", "sign_flip"],
            "codecs": list(BYZ_COMM_CHECK_CODECS),
            "codec_rules": list(BYZ_COMM_CHECK_RULES), "cases": len(cases),
            "picks": "equal", "g0_tol_rel": 1e-4,
            "d_tol": "5e-4 + 5e-3 |d| over ||d||",
            "theta_tol_of_change": 0.01, "accuracy_tol": 2 / 1024,
            "biased_share": BIASED_SHARE, "biased_norm_tol": BIASED_NORM_TOL,
            "biased_accuracy_tol": 8 / 1024, "worst": worst}


def phase_timing(launches, flash_launches, smi, by_width):
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
        "source": "src/repro_torch/csrc/gram.cu",
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
    coord_rows, select_b2b, krum_turns = timing_coord_stats(
        X, launches, rows, by_width)
    gram_row = timing_gram(X, rows)
    brk = breakdown(X)
    codec_times = timing_codecs(X)
    del X
    torch.cuda.empty_cache()
    flash_row = timing_flash(flash_launches, rows)
    emit({"phase": "timing", "shape": [W, N], "dtype": "float32",
          "card": smi, "hbm_bytes_per_s": HBM_BYTES_PER_S,
          "fp32_flop_per_s": FP32_FLOP_PER_S,
          "bf16_flop_per_s": BF16_FLOP_PER_S, "kernels": rows,
          "coord_stats_rows": coord_rows,
          "selection_back_to_back_ms": select_b2b,
          "launch_floor_graph_ms": launch_floor_ms(),
          "krum_scores_warp_vs_block": krum_turns, "looped_gram": gram_row,
          "flash_prefill_layer": flash_row, "breakdown": brk,
          "codecs": codec_times})
    return rows


def bound(nbytes: float, ops: float,
          flop_per_s: float = FP32_FLOP_PER_S) -> tuple[float, str]:
    t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / flop_per_s
    return 1e3 * max(t_b, t_o), ("bytes" if t_b >= t_o else "operations")


def coord_ops(op: str, r: int, f: int) -> int:
    """fp32 operations per coordinate of one statistic over r values, as
    the kernel computes it: the merge-exchange network it sorts r values
    with (``networks.comparators(r)``; exact width up to 16, padded above),
    2 operations a compare-exchange (min, max); the center (2, or the kept
    sum and a division); for MeaMed / Phocas the window: 3 a step of the
    scan over the r - ka positions it may drop (two differences, a
    compare), the ka kept values' sum, the edge test (4 differences, a
    max, a min, 2 compares) and a division.  The rare exact-tie path is
    not counted."""
    from repro_torch.kernels.coord_stats.networks import comparators
    kt, ka = min(f, (r - 1) // 2), max(r - f, 1)
    n = 2 * len(comparators(r)) + (2 if op in ("median", "meamed")
                                   else r - 2 * kt + 1)
    if op in ("meamed", "phocas"):
        n += 3 * (r - ka) + ka + 9
    return n


def graph_ms(fn, launches: int = 50, reps: int = 20) -> float:
    """Device time of one call of ``fn`` with no host in the way: a CUDA
    graph of ``launches`` calls, replayed ``reps`` times (a launch-bound
    kernel's back-to-back time follows the host's wrapper instead)."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    return cuda_ms(graph.replay, reps) / launches


def timing_coord_stats(X, launches, rows, by_width):
    """coord_stats (each op, masked median, Bulyan's rows= MeaMed),
    krum_scores and bulyan_select at the main path's shape; appends the
    kernels' entries (the coord_stats entry is Bulyan's stage, the shape
    the main path gives it) to ``rows`` and returns the per-op rows (each
    with its network width's ptxas lines from ``by_width``), the
    selections' back-to-back times (their rows' ms come from CUDA graphs)
    and the Krum scores' one-warp body against the one-block body."""
    import torch
    from repro_torch.core.aggregators import sq_dists_from_gram
    from repro_torch.kernels.coord_stats.kernel import (bulyan_select_cuda,
                                                        coord_stats_cuda,
                                                        krum_scores_cuda)
    from repro_torch.kernels.coord_stats.networks import width_for
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
        width = width_for(picks.numel() if "rows" in kw else W)
        ms = cuda_ms(lambda: coord_stats_cuda(X, op, f, **kw), 5)
        out.append({
            "op": op, "f": f, "variant": ("rows" if "rows" in kw else
                                          "masked" if "mask" in kw
                                          else "plain"),
            "workers_read": read, "max_abs_err": raw, "ms": ms,
            "plain_ms": cuda_ms(lambda: coord_stat_plain(X, op, f, **kw), 2,
                                0),
            "bound_ms": t, "bound_by": by, "share_of_bound": t / ms,
            "library_ms": lib, "network_width": width,
            "ptxas": by_width.get(f"{width}/float32")})
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
            score_rel_err(s, s_plain) > SCORE_TOL:
        raise AssertionError(f"timing: selection picks {picks.tolist()} vs "
                             f"{p_plain.tolist()}, scores {s} vs {s_plain}")
    t, by = bound(W * W * 4 + W * 4, W * (W - 1) + W * k)
    rows.append({
        "name": "krum_scores", "route": "cuda",
        "source": "src/repro_torch/csrc/krum_select.cu",
        "replaces": "src/repro/kernels/coord_stats/kernel.py:293",
        "launches": launches["krum_scores"][0],
        "max_abs_err": float((s - s_plain).abs().max()),
        "ms": graph_ms(lambda: krum_scores_cuda(D2, F)),
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
        "ms": graph_ms(lambda: bulyan_select_cuda(D2, F)),
        "plain_ms": cuda_ms(lambda: bulyan_select_plain(D2, F), 5, 1),
        "bound_ms": t, "bound_by": by, "library_ms": None})
    # the rows' ms come from CUDA graphs: back to back, these launch-bound
    # kernels time the host's wrapper instead
    back_to_back = {
        "krum_scores": cuda_ms(lambda: krum_scores_cuda(D2, F), 100, 5),
        "bulyan_select": cuda_ms(lambda: bulyan_select_cuda(D2, F), 100, 5)}
    return out, back_to_back, krum_warp_vs_block(D2, F, s)


# krum_scores_launch with every W sent to the one-block body, the Krum
# scores' only body before the one-warp body (the comparison's baseline)
KRUM_BLOCK_PATCH = ("""  if (w <= 16) {
    krum_scores_warp<16><<<1, 32, 0, s>>>(d2, w, k, out);
  } else if (w <= 32) {
    krum_scores_warp<32><<<1, 32, 0, s>>>(d2, w, k, out);
  } else {
    krum_scores_kernel<<<1, threads_for(w), 0, s>>>(d2, w, k, out);
  }
""", """  krum_scores_kernel<<<1, threads_for(w), 0, s>>>(d2, w, k, out);
""")


def krum_warp_vs_block(D2, F, s_warp) -> dict:
    """The shipped Krum scores (one warp at W <= 32) against the one-block
    body on the same D2, in one call: ``krum_select.cu`` rebuilt into
    ``build/krum_block/`` with KRUM_BLOCK_PATCH, its scores held equal to
    the shipped kernel's, both timed from CUDA graphs in turns (shipped,
    block, block, shipped)."""
    import ctypes

    import torch
    from repro_torch.kernels import _build
    from repro_torch.kernels.coord_stats.kernel import krum_scores_cuda
    out_dir = _build.BUILD_DIR.parent / "krum_block"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = (_build.CSRC / "krum_select.cu").read_text()
    old, new = KRUM_BLOCK_PATCH
    if src.count(old) != 1:
        raise AssertionError("krum_warp_vs_block: the patch no longer "
                             "matches csrc/krum_select.cu")
    cu, so = out_dir / "krum_select.cu", out_dir / "krum_select.so"
    cu.write_text(src.replace(old, new))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                    str(_build.CSRC), "-o", str(so), str(cu)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.krum_scores_launch.argtypes = [vp, i32, i32, vp, vp]
    lib.krum_scores_launch.restype = i32
    W = D2.shape[0]

    def block():
        out = torch.empty(W, dtype=torch.float32, device=D2.device)
        _build.check(lib.krum_scores_launch(
            D2.data_ptr(), W, F, out.data_ptr(),
            torch.cuda.current_stream().cuda_stream), "krum block body")
        return out
    s_block = block()
    torch.cuda.synchronize()
    if not torch.equal(s_block, s_warp):
        raise AssertionError(f"krum block body {s_block} vs warp {s_warp}")
    turns = {"warp": [], "block": []}
    for name in ("warp", "block", "block", "warp"):
        fn = (lambda: krum_scores_cuda(D2, F)) if name == "warp" else block
        turns[name].append(graph_ms(fn))
    return {"w": W, "f": F, "scores_equal": True, "graph_ms_turns": turns,
            **{f"{n}_graph_ms": sum(t) / len(t) for n, t in turns.items()}}


def launch_floor_ms() -> float:
    """Device time of one empty one-warp kernel (``krum_select.cu``'s
    ``empty_launch``) from a CUDA graph, as ``graph_ms`` times the
    selections: the least a launch of theirs can take."""
    import ctypes

    import torch
    from repro_torch.kernels import _build
    lib = _build.load_library("krum_select", {
        "empty_launch": ([ctypes.c_void_p], ctypes.c_int)})

    def empty():
        _build.check(lib.empty_launch(torch.cuda.current_stream()
                                      .cuda_stream), "empty_launch")
    return graph_ms(empty)


def host_ms(fn, reps: int = 3) -> float:
    """Host clock over ``reps`` calls of ``fn`` ending in a
    synchronisation, after one warm-up call; ms a call."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t0) / reps


def timing_codecs(X) -> dict:
    """The codecs at full width, on the main path's (W, N) shape: for each
    codec the encode, the decode and the EF round, as the round runs them
    (one worker row of one leaf at a time), and ``compressed_aggregate``
    for each run of TRAIN_COMM_RUNS (host clock, ``host_ms``); then the
    tree Gram at the sketch's shape (W x sum_i k_i = 15 x 22,613,820),
    checked against its plain version and timed with CUDA events beside it
    and the library's product, against its byte bound.  Overwrites X."""
    import torch
    from repro_torch.comm import CommConfig, ef_encode_decode, get_codec
    from repro_torch.comm.compressors import leaf_blocks
    from repro_torch.configs import get_config
    from repro_torch.core.flag import FlagConfig
    from repro_torch.dist.aggregation import (AggregatorConfig,
                                              compressed_aggregate)
    from repro_torch.kernels.gram.kernel import tree_gram_cuda
    from repro_torch.kernels.gram.ref import tree_gram_plain
    from repro_torch.models.transformer import param_shapes_tree
    from repro_torch.weights import layout_of

    layout = layout_of(param_shapes_tree(get_config("smollm-360m")))
    W = X.shape[0]
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(13)
    E = torch.zeros_like(X)
    codecs, per_codec = {}, {}
    for name in ("identity", "signsgd", "topk", "countsketch"):
        codec = codecs[name] = get_codec(CommConfig(codec=name))
        X.normal_(generator=gen)

        def encode_all(codec=codec):
            return [[codec.encode_leaf(X[w:w + 1, o:o + n], i, shape)
                     for w in range(W)]
                    for i, o, n, shape in leaf_blocks(layout)]
        payload = encode_all()          # CountSketch draws its maps here

        def decode_all(codec=codec, payload=payload):
            for (i, o, n, shape), rows in zip(leaf_blocks(layout), payload):
                for w, p in enumerate(rows):
                    codec.decode_leaf(p, i, shape, out=X[w:w + 1, o:o + n])
        per_codec[name] = {
            "encode_ms": host_ms(encode_all),
            "decode_ms": host_ms(decode_all),
            "ef_round_ms": host_ms(lambda codec=codec: ef_encode_decode(
                codec, X, layout, E))}
        del payload
        torch.cuda.empty_cache()
    determinism = countsketch_determinism(X, layout, codecs["countsketch"],
                                          gen)
    X.normal_(generator=gen)
    E.zero_()
    churn = torch.ones(W, device=DEVICE)
    churn[0] = 0.0
    aggregate = {}
    for agg, name, faults, _, _ in TRAIN_COMM_RUNS:
        comm = CommConfig(codec=name)
        cfg = AggregatorConfig(name=agg, f=MAIN_F, flag=FlagConfig(
            lam=float(W), regularizer="pairwise"))
        aggregate[f"{agg}_{name}_{faults}_ms"] = host_ms(
            lambda comm=comm, cfg=cfg, name=name, faults=faults:
            compressed_aggregate(X, cfg, comm, E if comm.wants_ef else None,
                                 layout=layout, codec=codecs[name],
                                 mask=churn if faults == "churn" else None))
    X.normal_(generator=gen)
    P = codecs["countsketch"].sketch(X, layout)
    K, K_plain = tree_gram_cuda(P), tree_gram_plain(P, 1, 1024)
    torch.cuda.synchronize()
    rel = gram_err(K, K_plain)
    if rel > GRAM_TOL or P.shape != (W, SKETCH_COLS):
        raise AssertionError(f"timing: tree_gram on the sketch "
                             f"{tuple(P.shape)}: rel err {rel}")
    t, by = bound(P.numel() * 4 + W * W * 4, W * (W + 1) * P.shape[1])
    ms = cuda_ms(lambda: tree_gram_cuda(P), 20, 2)
    sketch_gram = {
        "shape": list(P.shape), "rel_err": rel, "ms": ms,
        "plain_ms": cuda_ms(lambda: tree_gram_plain(P, 1, 1024), 5),
        "library_ms": cuda_ms(lambda: P @ P.T, 10, 2), "bound_ms": t,
        "bound_by": by, "share_of_bound": t / ms}
    del P, E
    torch.cuda.empty_cache()
    return {"per_codec": per_codec, "compressed_aggregate": aggregate,
            "tree_gram_sketch": sketch_gram,
            "countsketch_determinism": determinism}


def countsketch_determinism(X, layout, cs, gen) -> dict:
    """CountSketch's encode of the whole (W, N) buffer as the codec runs
    it (a scatter into a slot table, one value an address, summed over the
    table's rows) beside PR 17's body (one ``index_add_`` of each row:
    float atomics on shared buckets), on the same input: host ms of each,
    and whether each gives the same bits twice.  The codec's must."""
    import torch
    from repro_torch.comm.compressors import leaf_blocks

    X.normal_(generator=gen)
    W = X.shape[0]

    def slot_table():
        return [cs.encode_leaf(X[:, o:o + n], i, shape)
                for i, o, n, shape in leaf_blocks(layout)]

    def atomic():
        outs = []
        for i, o, n, _ in leaf_blocks(layout):
            bucket, sign = cs.maps(n, i, X.device)
            out = torch.zeros((W, cs._k(n)), device=X.device)
            for w in range(W):
                out[w].index_add_(0, bucket, X[w, o:o + n] * sign)
            outs.append(out)
        return outs

    def repeatable(fn) -> bool:
        a = fn()
        return all(torch.equal(x, y) for x, y in zip(a, fn()))
    out = {"slot_table_ms": host_ms(slot_table),
           "atomic_ms": host_ms(atomic),
           "slot_table_repeatable": repeatable(slot_table),
           "atomic_repeatable": repeatable(atomic)}
    if not out["slot_table_repeatable"]:
        raise AssertionError(f"countsketch encode not repeatable: {out}")
    torch.cuda.empty_cache()
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
        **{f"aggregate_tree_{r}_ms": host_ms(
            lambda r=r: aggregate_tree(X, AggregatorConfig(name=r, f=MAIN_F)))
           for r in ("median", "trimmed_mean", "meamed", "phocas")},
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


def flash_ratio(o, want, dtype: str) -> tuple[float, float]:
    """max |o - want| / (FLASH_ATOL + FLASH_RTOL |want|) (<= 1 passes; a
    non-finite output fails) and the raw max error; ``want`` is fp32."""
    import torch
    if not bool(torch.isfinite(o.float()).all()):
        return math.inf, math.inf
    diff = (o.float() - want).abs()
    limit = FLASH_ATOL + FLASH_RTOL[dtype] * want.abs()
    return float((diff / limit).max()), float(diff.max())


def phase_sweep_flash():
    """flash_attn kernel against flash_attn_plain on the card: every head
    dim, dtype, (H, KV) grouping, shape and mask of the FLASH_* grids."""
    import torch
    from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda
    from repro_torch.kernels.flash_attn.ref import flash_attn_plain

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(7)
    worst = {"float32": 0.0, "bfloat16": 0.0}
    sound = {"float32": 0.0, "bfloat16": 0.0}
    wrong = {"zeros": math.inf, "off_2^-6": math.inf}
    cases = 0
    for d in FLASH_D:
        for H, KV in FLASH_HEADS:
            for sq, sk in FLASH_SEQ:
                q32 = torch.randn((2, H, sq, d), generator=gen, device=DEVICE)
                k32, v32 = (torch.randn((2, KV, sk, d), generator=gen,
                                        device=DEVICE) for _ in range(2))
                for dtype in ("float32", "bfloat16"):
                    q, k, v = (t.to(getattr(torch, dtype))
                               for t in (q32, k32, v32))
                    for causal, window in FLASH_MASKS:
                        o = flash_attn_cuda(q, k, v, causal=causal,
                                            window=window)
                        want = flash_attn_plain(
                            q.float(), k.float(), v.float(), causal=causal,
                            window=window)
                        torch.cuda.synchronize()
                        ratio, raw = flash_ratio(o, want, dtype)
                        bad = {"zeros": flash_ratio(
                                   torch.zeros_like(o), want, dtype)[0],
                               "off_2^-6": flash_ratio(
                                   o * FLASH_WRONG_SCALE, want, dtype)[0]}
                        if min(bad.values()) <= 1:
                            raise AssertionError(
                                f"flash_attn d={d} H={H} KV={KV} sq={sq} "
                                f"sk={sk} {dtype} causal={causal} "
                                f"window={window}: the limit passes a wrong "
                                f"output ({bad})")
                        if ratio > 1 or o.dtype != q.dtype or \
                                o.shape != q.shape:
                            raise AssertionError(
                                f"flash_attn d={d} H={H} KV={KV} sq={sq} "
                                f"sk={sk} {dtype} causal={causal} "
                                f"window={window}: max err {raw}")
                        if causal and sq > sk and \
                                not bool((o[:, :, :sq - sk] == 0).all()):
                            raise AssertionError(
                                f"flash_attn sq={sq} > sk={sk}: rows that "
                                f"see no key are not 0")
                        worst[dtype] = max(worst[dtype], raw)
                        sound[dtype] = max(sound[dtype], ratio)
                        wrong = {n: min(wrong[n], r) for n, r in bad.items()}
                        cases += 1
    emit({"phase": "sweep_flash", "cases": cases, "d": list(FLASH_D),
          "heads_kv": [list(x) for x in FLASH_HEADS],
          "seq_q_k": [list(x) for x in FLASH_SEQ],
          "causal_window": [list(x) for x in FLASH_MASKS],
          "atol": FLASH_ATOL, "rtol": FLASH_RTOL, "worst_abs_err": worst,
          "worst_share_of_limit": sound,
          "wrong_output_least_multiple_of_limit": wrong})


def phase_sweep_gram():
    """gram kernel against gram_plain on the card: widths, ragged lengths,
    element strides through row-strided views of a wider buffer, and a
    contiguous (n, p) matrix; fp32, bf16 and fp32 rounded to bf16."""
    import torch
    from repro_torch.kernels.gram.kernel import gram_cuda
    from repro_torch.kernels.gram.ref import gram_plain

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(8)
    worst, cases = 0.0, 0

    def one(G, round_bf16=False):
        nonlocal worst, cases
        K, K2 = gram_cuda(G, round_bf16=round_bf16), gram_cuda(
            G, round_bf16=round_bf16)
        K_plain = gram_plain(G.to(torch.bfloat16) if round_bf16 else G)
        torch.cuda.synchronize()
        err = gram_err(K, K_plain)
        if not (err <= GRAM_TOL and torch.equal(K, K2)
                and torch.equal(K, K.T)):
            raise AssertionError(
                f"gram n={G.shape[0]} p={G.shape[1]} strides={G.stride()} "
                f"{G.dtype} round_bf16={round_bf16}: rel err {err} (tol "
                f"{GRAM_TOL}), run-to-run equal {torch.equal(K, K2)}")
        worst = max(worst, err)
        cases += 1

    for p in GRAM_P:
        for n in GRAM_N:
            for stride in GRAM_STRIDE:
                # a leaf of a (p, N) buffer: offset 5, every stride-th
                # column, transposed -- strides (stride, N)
                X = torch.randn((p, 5 + n * stride + 3), generator=gen,
                                device=DEVICE)
                G = X[:, 5:5 + n * stride:stride].T
                one(G)
                one(G, round_bf16=True)
                one(G.to(torch.bfloat16))
            one(torch.randn((n, p), generator=gen, device=DEVICE))
    torch.cuda.empty_cache()
    emit({"phase": "sweep_gram", "cases": cases, "p": list(GRAM_P),
          "n": list(GRAM_N), "stride_n": list(GRAM_STRIDE),
          "gram_rel_tol": GRAM_TOL, "worst_rel_err": worst})


def device_profile(fn, reps: int) -> dict:
    """``reps`` calls of ``fn`` on the host clock (ending in a
    synchronisation), then ``reps`` more under ``torch.profiler``: device
    busy time (the sum of the kernels' device times), the device's idle
    share against the unprofiled wall time, and CPU operator calls, each
    per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch.profile import _device_us
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0) / reps
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy_ms = sum(_device_us(e) for e in events
                  if e.device_type.name != "CPU") / 1e3 / reps
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "cpu_op_calls": sum(e.count for e in events
                                if e.device_type.name == "CPU") / reps}


def phase_serve():
    """The serving path at full width: (a) the serve CLI, (b) prefill of
    PREFILL_B x PREFILL_S tokens through the flash kernel, its launches
    counted, (c) prefill logits against the decode path's.  Returns the
    flash kernel's launches in one prefill call."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.serve_step import (build_prefill_step,
                                             build_serve_step)
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    counters = _counters()
    torch.cuda.reset_peak_memory_stats()
    argv = SERVE_ARGV + ["--device", DEVICE]
    for _, reset in counters.values():
        reset()
    out = serve.main(argv)
    decode_counts = {n: get() for n, (get, _) in counters.items()}
    prompts, gen_tokens = out["prompts"], out["tokens"]
    P = prompts.shape[1]
    max_len = P + gen_tokens.shape[1] + 1

    cfg = get_config("smollm-360m")
    params = transformer.init_params(cfg, seed=0, device=DEVICE)
    g = torch.Generator().manual_seed(9)
    rest = torch.randint(0, cfg.vocab_size, (PREFILL_B, PREFILL_S - P),
                         generator=g).to(DEVICE)
    tokens = torch.cat([prompts, rest], dim=1)
    prefill = build_prefill_step(cfg)
    times, flash_launches = [], None
    for i in range(3):
        for _, reset in counters.values():
            reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = {n: get() for n, (get, _) in counters.items()}
        want = {n: (cfg.num_layers if n == "flash_attn" else 0)
                for n in counts}
        if counts != want:
            raise AssertionError(f"serve prefill: kernel launches {counts}, "
                                 f"want {want} (one flash launch a layer)")
        flash_launches = counts["flash_attn"]
        if i < 2:
            del logits
    if logits.shape != (PREFILL_B, PREFILL_S, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"serve prefill: logits {tuple(logits.shape)}, "
                             f"finite {bool(torch.isfinite(logits).all())}")
    peak = torch.cuda.max_memory_allocated()
    pre = logits[:, P - 1].clone()
    del logits
    torch.cuda.empty_cache()

    caches = transformer.init_caches(cfg, PREFILL_B, max_len, torch.float32,
                                     device=DEVICE)
    with torch.no_grad():
        for t in range(P):
            dec, caches = transformer.decode_step(
                params, prompts[:, t:t + 1], caches, t, cfg, max_len=max_len)
    dec = dec[:, 0]
    delta = float((pre - dec).abs().max())
    top2 = pre.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    first = gen_tokens[:, 0].long()
    agree = (first == pre.argmax(-1)) | (margin <= SERVE_LOGIT_TOL)
    if delta > SERVE_LOGIT_TOL or not bool(agree.all()) or \
            not torch.equal(first, dec.argmax(-1)):
        raise AssertionError(
            f"serve: max |prefill - decode logit| {delta} (tol "
            f"{SERVE_LOGIT_TOL}); first tokens {first.tolist()}, prefill "
            f"argmax {pre.argmax(-1).tolist()}, decode argmax "
            f"{dec.argmax(-1).tolist()}, margins {margin.tolist()}")
    # one decode step (positions P, P + 1, ... of the same caches) and one
    # prefill call, profiled
    step_fn = build_serve_step(cfg, max_len=max_len)
    state = {"tok": first[:, None].to(torch.int32), "pos": P}

    def decode_one():
        state["tok"], _ = step_fn(params, caches, state["tok"], state["pos"])
        state["pos"] += 1
    decode_prof = device_profile(decode_one, 4)
    prefill_prof = device_profile(
        lambda: prefill(params, {"tokens": tokens}), 1)
    del params, caches
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "serve", "argv": argv,
          "decode_tok_per_s": out["tok_per_s"],
          "serve_prefill_s": out["prefill_s"],
          "serve_decode_s": out["decode_s"],
          "decode_path_launches": decode_counts,
          "prefill_tokens": [PREFILL_B, PREFILL_S],
          "prefill_s": times,
          "prefill_s_after_warmup": sum(times[1:]) / len(times[1:]),
          "prefill_flash_launches_per_call": flash_launches,
          "max_memory_allocated_bytes": peak,
          "max_abs_logit_delta_prefill_vs_decode": delta,
          "logit_tol": SERVE_LOGIT_TOL,
          "top2_margins": margin.tolist(),
          "first_tokens": first.tolist(),
          "prefill_argmax": pre.argmax(-1).tolist(),
          "decode_step_profile": decode_prof,
          "prefill_profile": prefill_prof})
    return flash_launches


def check_serve():
    """The serving path at the reduced size (fp32 compute), card (flash
    kernel) against CPU (plain version), from the same seeded weights and
    prompts: prefill logits, per-position decode logits, and the greedy
    token chain of decode_loop."""
    import torch
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.dist.serve_step import build_prefill_step, decode_loop
    from repro_torch.models import transformer

    cfg = reduce_for_smoke(get_config("smollm-360m"))
    g = torch.Generator().manual_seed(10)
    prompts = torch.randint(0, cfg.vocab_size, (3, 40), generator=g)
    out = {}
    for dev in (DEVICE, "cpu"):
        params = transformer.init_params(cfg, seed=0, device=dev)
        toks = prompts.to(dev)
        pre = build_prefill_step(cfg)(params, {"tokens": toks})
        caches = transformer.init_caches(cfg, 3, 48, torch.float32,
                                         device=dev)
        dec = []
        with torch.no_grad():
            for t in range(toks.shape[1]):
                lg, caches = transformer.decode_step(
                    params, toks[:, t:t + 1], caches, t, cfg, max_len=48)
                dec.append(lg)
        chain = decode_loop(params, cfg, toks[:, :30], num_steps=16,
                            max_len=48)
        out[dev] = (pre.cpu(), torch.cat(dec, 1).cpu(), chain.cpu())
    (pg, dg, cg), (pc, dc, cc) = out[DEVICE], out["cpu"]
    errs = {"prefill": float((pg - pc).abs().max()),
            "decode": float((dg - dc).abs().max()),
            "prefill_vs_decode_card": float((pg - dg).abs().max())}
    if max(errs.values()) > SMOKE_LOGIT_TOL or not torch.equal(cg, cc):
        raise AssertionError(f"check serve: logit errors {errs} (tol "
                             f"{SMOKE_LOGIT_TOL}); chains equal "
                             f"{torch.equal(cg, cc)}")
    return {**errs, "logit_tol": SMOKE_LOGIT_TOL, "chain_equal": True}


def check_looped_gram():
    """tree_gram(fused=False) on the card (the gram kernel per leaf)
    against the CPU (gram_plain per leaf), sketched and not."""
    import torch
    from repro_torch.dist.aggregation import tree_gram
    sizes = [300_000, 960, 7, 1, 123_457]
    X = torch.randn((MAIN_W, sum(sizes)),
                    generator=torch.Generator().manual_seed(11))
    worst = 0.0
    for stride in (1, 2, 7):
        for gram_dtype in ("float32", "bfloat16"):
            K = tree_gram(X.to(DEVICE), stride, gram_dtype=gram_dtype,
                          fused=False, leaf_sizes=sizes).cpu()
            K_cpu = tree_gram(X, stride, gram_dtype=gram_dtype, fused=False,
                              leaf_sizes=sizes)
            err = gram_err(K, K_cpu)
            if err > GRAM_TOL:
                raise AssertionError(f"check looped tree_gram stride "
                                     f"{stride} {gram_dtype}: rel err {err}")
            worst = max(worst, err)
    return {"leaf_sizes": sizes, "strides": [1, 2, 7], "rel_err": worst,
            "tol": GRAM_TOL}


def timing_flash(launches, rows):
    """One layer's prefill attention at full width against the plain
    version and the library's fused attention; appends the kernel row."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda
    from repro_torch.kernels.flash_attn.ref import flash_attn_plain

    B, H, KV, S, d = PREFILL_B, 15, 5, PREFILL_S, 64
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(12)
    q = torch.randn((B, H, S, d), generator=gen, device=DEVICE).bfloat16()
    k, v = (torch.randn((B, KV, S, d), generator=gen,
                        device=DEVICE).bfloat16() for _ in range(2))
    o = flash_attn_cuda(q, k, v, causal=True)
    want = flash_attn_plain(q.float(), k.float(), v.float(), causal=True)
    torch.cuda.synchronize()
    ratio, raw = flash_ratio(o, want, "bfloat16")
    if ratio > 1:
        raise AssertionError(f"timing: flash_attn max err {raw}, "
                             f"{ratio} of the limit")
    del o, want
    nbytes = 2 * (2 * B * H * S * d + 2 * B * KV * S * d)
    flops = 4 * B * H * d * S * (S + 1) // 2        # causal pairs
    t, by = bound(nbytes, flops, BF16_FLOP_PER_S)
    row = {
        "name": "flash_attn", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn.cu",
        "replaces": "src/repro/kernels/flash_attn/kernel.py:83",
        "launches": launches, "max_abs_err": raw,
        "ms": cuda_ms(lambda: flash_attn_cuda(q, k, v, causal=True), 20, 2),
        "plain_ms": cuda_ms(lambda: flash_attn_plain(q, k, v, causal=True),
                            5),
        "bound_ms": t, "bound_by": by,
        "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True, enable_gqa=True), 20, 2)}
    rows.append(row)
    # The bf16 body computes P V twice (P split into bf16 halves): its
    # tensor-core work is 6 d, not 4 d, FLOP a kept pair.
    tensor_flops = flops * 3 // 2
    out = {"shape": [B, H, KV, S, d], "dtype": "bfloat16", "causal": True,
           "flops": flops, "bytes": nbytes, "tensor_flops": tensor_flops,
           "fp32_core_bound_ms": 1e3 * flops / FP32_FLOP_PER_S,
           "split_bound_ms": 1e3 * tensor_flops / BF16_FLOP_PER_S,
           "useful_tflop_per_s": flops / row["ms"] / 1e9,
           "tensor_tflop_per_s": tensor_flops / row["ms"] / 1e9,
           "share_of_bound": row["bound_ms"] / row["ms"],
           "vs_library": row["ms"] / row["library_ms"],
           "share_of_limit": ratio,
           **{k_: row[k_] for k_ in ("ms", "plain_ms", "bound_ms",
                                     "library_ms", "max_abs_err")}}
    del q, k, v
    torch.cuda.empty_cache()
    return out


def timing_gram(X, rows):
    """The looped tree Gram over smollm-360m's leaves at the main path's
    shape: its gram launches counted on one call, checked against the
    plain version per leaf and against the fused kernel, timed beside the
    plain loop and a loop of one library call per leaf."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.aggregation import tree_gram
    from repro_torch.kernels.gram import kernel as gram_k
    from repro_torch.kernels.gram.ref import gram_plain
    from repro_torch.models.transformer import param_shapes_tree
    from repro_torch.weights import layout_of

    sizes = layout_of(param_shapes_tree(get_config("smollm-360m"))).sizes
    W, N = X.shape
    if sum(sizes) != N:
        raise AssertionError(f"timing: leaves sum to {sum(sizes)}, not {N}")

    def leaf_views():
        off = 0
        for n in sizes:
            yield X[:, off:off + n].T
            off += n

    def looped():
        return tree_gram(X, fused=False, leaf_sizes=sizes)

    def plain():
        return sum(gram_plain(G) for G in leaf_views())

    def library():
        return sum(G.T @ G for G in leaf_views())

    counters = _counters()
    for _, reset in counters.values():
        reset()
    K = looped()
    torch.cuda.synchronize()
    counts = {n: get() for n, (get, _) in counters.items()}
    want = {n: (len(sizes) if n == "gram" else 0) for n in counts}
    if counts != want:
        raise AssertionError(f"timing: looped tree_gram launches {counts}, "
                             f"want {want} (one gram launch a leaf)")
    K_plain = plain()
    K_fused = gram_k.tree_gram_cuda(X)
    torch.cuda.synchronize()
    err, err_fused = gram_err(K, K_plain), gram_err(K, K_fused)
    if max(err, err_fused) > GRAM_TOL:
        raise AssertionError(f"timing: looped tree_gram rel err {err} vs "
                             f"plain, {err_fused} vs fused")
    t, by = bound(W * N * 4 + len(sizes) * W * W * 4, W * (W + 1) * N)
    ms = cuda_ms(looped, 5, 1)
    rows.append({
        "name": "gram", "route": "cuda",
        "source": "src/repro_torch/csrc/gram.cu",
        "replaces": "src/repro/kernels/gram/kernel.py:51",
        "launches": counts["gram"],
        "max_abs_err": float((K - K_plain).abs().max()),
        "ms": ms, "plain_ms": cuda_ms(plain, 2), "bound_ms": t,
        "bound_by": by, "library_ms": cuda_ms(library, 3)})
    per_leaf = [cuda_ms(lambda G=G: gram_k.gram_cuda(G), 3)
                for G in leaf_views()]
    return {"leaf_sizes": list(sizes), "launches_per_call": counts["gram"],
            "ms_per_call": ms, "rel_err_vs_plain": err,
            "rel_err_vs_fused": err_fused, "per_leaf_ms": per_leaf,
            "kernel_ms": sum(per_leaf)}



def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from repro_torch.device import resolve_device
    resolve_device("cuda")                  # TF32 and reduced reductions off
    smi = phase_card()
    by_width = phase_build()
    phase_sweep()
    phase_sweep_coord()
    phase_sweep_select()
    phase_sweep_flash()
    phase_sweep_gram()
    launches, peaks, flag_hist = phase_train()
    phase_train_comm(peaks["flag"])
    phase_resume(flag_hist)
    flash_launches = phase_serve()
    phase_check()
    phase_byzantine(smi)
    rows = phase_timing(launches, flash_launches, smi, by_width)
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
