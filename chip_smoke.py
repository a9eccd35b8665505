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
                (``sweep_flash``, which also holds recurrentgemma-9b's
                attention layer exactly: MQA, d 256, window 2048 on 4,096
                tokens, bf16, mixtral-8x7b's: GQA 32 / 8, d 128,
                window 4096 on 8,192 tokens, deepseek-moe-16b's, and the
                2 x 4096 prefill layers of musicgen-medium, phi-3-vision
                (d 96), stablelm, starcoder2 and command-r,
                ATTN_FLASH); the per-matrix Gram over
                widths, ragged lengths, element strides, row-strided
                views, dtypes and bf16 rounding (``sweep_gram``);
     activations -- the activation kernel (``csrc/activations.cu``:
                JAX's primitives rounded after each, forward, gated and
                backward) against the eager composition on the card over
                all 65,536 bf16 bit patterns and 2^20 fp32 values, every
                form, 0 values may differ; strided and ragged views;
                ``repro_torch.models.activations`` on the card against
                the composition on the CPU over every finite bf16 value,
                forward and backward: the values that differ, printed
                (ACT_DIFFER_MAX); the kernel, the composition and
                ``F.silu`` timed at smollm-360m's MLP width, plain,
                gated and backward, with their bounds, and the host time
                a call at the decode width (ACT_SHAPES);
  4. train   -- the port's training path at full width:
                ``repro_torch.launch.train.main`` for smollm-360m (32
                layers, d_model 960, N = 361,821,120 parameters, random
                weights from seed 0), 15 workers, 3 sign-flipping
                Byzantine workers, a few steps, once per aggregator:
                ``flag`` (tree Gram + combine), ``bulyan`` (tree Gram +
                Bulyan selection + coordinate statistics) and
                ``multi_krum`` (tree Gram + Krum scores + combine); before
                each run the kernels' launch counters are zeroed, after it
                each of the run's kernels must have launched once per step,
                and the activation kernel's gated form once a layer and
                worker a step, forward and backward (its own counter);
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
     train_sharded -- the same main path with ``--sharded-agg``
                (``repro_torch.dist.sharded``): each rank holds its
                coordinate shard of the (15, N) stack, the (W, W) Gram
                meets in one all_reduce, d comes back by one all_gather.
                R = 1 in this process (NCCL, a world of one): losses, |g|
                and FA weights equal to the train phase's flag run bit for
                bit; step 1's d and parameters kept.  The controls, in
                this process: the unsharded flag run with its Gram (and
                under CountSketch its payload) summed by hand over the
                2 and 3 column blocks the ranks hold (``_blocked``), held
                against the unsharded runs, with how far step 1's d and
                parameters moved (coordinates that differ, d's sign
                flips, the largest change over lr).  Then worlds of R = 2
                (W = 15 is odd: every rank computes all workers) and
                R = 3 (split: 5 workers a rank, one all_to_all per worker
                index) ranks, each rank a process on this card (gloo,
                CUDA tensors), started by
                ``repro_torch.launch.ranks.spawn``, their runs one after
                another (SHARDED_WORLDS: steps each): R = 2 flag x
                countsketch (the sketch feeds the
                Gram; one all_reduce of the payload), and the decoding
                and EF codecs on the shards: flag x signsgd and
                multi_krum x topk (error feedback: each rank's (15,
                width) EF shard) and bulyan x countsketch (decoded), 2
                steps each, held against train_comm's unsharded run of
                the same rule and codec: steps 0-1's losses exactly,
                picks equal, the FA weights and |d| as below (flag x
                signsgd instead equal to its 2-block control bit for bit,
                SHARDED_BY_CONTROL), top-k's |d| and each worker's EF
                norm per leaf equal, signSGD's EF norms within
                SHARDED_EF_RTOL; R = 3 flag (a rank draws the weights once
                for its world's runs); and in the R = 2 world ZeRO-1
                (``train_sharded_zero1``: the AdamW moments cut over
                ``data``, ``repro_torch.dist.zero1``) as a twin of its
                flag x countsketch run: the parameters' SHA-256 equal to
                the twin's after every step, a rank's peak one moment
                (1,447,284,480 B) below the twin's and its optimizer
                bytes half, ``zero1_all_gather`` (a call a leaf) 723,642,240
                B a step (ZERO1_*).  Held
                against the unsharded runs: steps 0
                and 1 (lr 0 at step 0: one starting state) losses
                exactly, FA weights and |d| within SHARDED_C_ATOL /
                SHARDED_D_RTOL (a flag run with its control: plus twice
                the control's distance, itself under SHARDED_NEAR_CEILING,
                and within SHARDED_CONTROL_* of the control); the R = 2
                runs equal to their controls bit for bit; R = 3's flag
                run takes a third step, its loss (step 1's update) within
                SHARDED_SPREAD times the control's distance from the
                unsharded run (its FA weights and |d| printed: step 2's
                solve branches); multi_krum's and bulyan's picks, losses,
                |d| and FA weights equal at every step; every rank's FA
                weights the same bits; each of the run's kernels once a
                step on each rank and no other; each rank's peak below
                the unsharded run's; step times
                (the first with the run's set-up), each world's wall
                time, peaks and each collective's bytes and seconds a
                step; then the tree Gram and the combine against their
                plain versions at an R = 3 rank's (15, width);
     train_tp -- tensor parallelism over the mesh's ``model`` axis
                (``repro_torch.dist.tensor_parallel``): a world of 4
                ranks on this card (gloo, CUDA tensors), the host mesh
                (data 2, model 2).  smollm-360m at full width and depth,
                W = 15, 3 sign-flipping, 4 x 128 tokens a worker: each
                data group computes all 15 workers, each rank of a model
                group its half of the model (qkv split mid-head: q, k, v
                gathered; mlp and the tied 49,152-row table split); flag,
                TP_STEPS step.  The control in this
                process (``_tp_blocked``: the unsharded step with every
                product on the ranks' blocks, the vocabulary's
                log-softmax on its two blocks and the Gram over the four
                coordinate blocks): step 0's loss the same bits
                (TP_CONTROL_*), the FA weights and |d| within the stated
                tolerances; the run against the train phase's
                unsharded run (TP_LOSS_RTOL, TP_D_RTOL, TP_C_ATOL);
                then runs of the other families against their own
                unsharded runs here (TP_FAMILY_*): in the same world
                (the split path), xlstm-1.3b at one period (8 layers,
                its loss over each sequence's first 4 of 32 positions;
                one flag step, W = 2) and musicgen-medium at 2 layers
                with its 64-embedding prefix (heads split): 2 flag
                steps at W = 2 and 2 bulyan steps at W = 8, f = 1
                sign-flipping (the picks equal to the unsharded run's),
                the data groups' parameters SHA-256-equal after step 1;
                then the first two ranks as a world of their own, the
                mesh (data 1, model 2), one flag step each at W = 2:
                deepseek-moe-16b (its dense head and 1 MoE layer, the
                banks split over d_e), mixtral-8x7b (1 layer, the
                expert-parallel overrides: 4 experts a rank) and
                recurrentgemma-9b (its two RG-LRU blocks)
                (TP_FAMILIES), the MoE runs' routing against their
                references (a flip only at a near tie).  Each family
                run's AdamW first moment after step 0 (d, scaled) leaf
                by leaf against its unsharded run's: every replicated
                leaf (norms, convs, router, projector) within
                TP_LEAF_RTOL and the same bits on every rank, every
                split leaf's block norm within TP_LEAF_RTOL.  Every
                rank's metrics the same bits, smollm's data groups'
                parameters SHA-256-equal after its step, each of the
                run's kernels once a step on each rank;
                per rank the peak memory (below the unsharded run's), the
                parameter and AdamW bytes against the unsharded ones,
                step seconds, each tensor-parallel collective's calls,
                bytes and seconds a step; then the tree Gram and the
                combine against their plain versions at a rank's (15,
                width);
     serve_tp -- tensor-parallel serving inside train_tp's worlds, each
                run under ``launch.dryrun.rules_for(serving=True)`` and
                held against the unsharded port's run made first in
                this process (SERVE_TP): smollm-360m at full width and
                depth in (2, 2), a 4 x 2048 prefill (flash_fwd_tc on
                each rank, every head) and 8 + 4 tokens through
                ``decode_loop``, its KV cache split by head_dim;
                xlstm-1.3b (8 layers) and phi-3-vision-4.2b (2, its
                prefix) there; recurrentgemma-9b (3: KV 1, head_dim
                split, heads split) and mixtral-8x7b (1, expert-parallel)
                in (1, 2): a rank's cache bytes against the layout's
                arithmetic, prefill and decode logits within
                SERVE_TP_TOL, greedy tokens equal but at a near tie, the
                MoE's flips near ties, each collective kind's calls,
                bytes and seconds, flash launches, peaks against
                unsharded;
     dryrun -- ``repro_torch.launch.dryrun`` on fake CUDA tensors, three
                subprocesses started with train_tp: a fake world of 4 at
                (2, 2) tracing smollm's train_tp step and serve_tp
                prefill and serve step, its collectives and argument
                bytes equal to rank 0's, its peak within the stated
                slack of rank 0's (DRYRUN_PEAK_*); the CLI on the
                production mesh (256 fake ranks) for smollm-360m's four
                shapes, each ``[ok]``, its FLOPs, peak and collectives;
                and the CLI's ``--zero1`` train_4k: its argument bytes
                below the run without it by exactly the momentum bytes
                the cut removes from rank 0, a ``zero1_all_gather`` a leaf
                more (``dryrun_zero1``);
  5. serve   -- the port's serving path at full width, bf16 compute:
                (a) ``repro_torch.launch.serve.main`` with the JAX
                launcher's defaults (batch 4, prompt 64, 32 generated
                tokens): decode tok/s; (b) ``build_prefill_step`` scoring
                4 requests x 2048 tokens, the first 64 of each being (a)'s
                prompt: the flash-attention kernel and the gated
                activation must launch once per layer (32) per call and
                nothing else may launch (the activation also once a layer
                a decode step); (c) the prefill logits at (a)'s last
                prompt position against the decode path's logits there,
                and (a)'s first generated token against the prefill
                argmax; then one decode step and one prefill call under
                ``torch.profiler`` (device busy time, idle share,
                operator calls);
     analysis -- ``repro_torch.analysis`` on the card: the lint sweep
                (``run_sweep(device="cuda", sharded="skip")``, every entry
                under CUDA's sync-debug mode) clean but at the
                ``analysis.allowed`` sites, each printed with its runs;
                TRANSFER at full width, under sync-debug mode: one
                ``aggregate_tree`` each of flag, bulyan and multi_krum on
                a (15, N) stack and one smollm-360m decode step, every
                synchronisation printed by ``file:line`` and, where the
                CPU trace's dispatch-level rule would not flag it, printed
                as such; KBUDGET on the build's ptxas lines (no spills,
                shared memory within 227 KiB, for every instantiation
                but the allowed ones); and ``compute-sanitizer``
                (memcheck, racecheck, initcheck, in parallel children)
                over one launch of each kernel (and each form of the
                activation kernel) at a small case of its sweep, where a probe shows the tool can run a
                CUDA program on this card (where it answers "Device not
                supported" the phase prints that and runs none); a
                finding or a sanitizer error fails the run;
     serve_xlstm, serve_rgemma -- the same for xlstm-1.3b (8 of its
                48 layers, N = 420,716,544; a 4 x 2048 prefill) and
                recurrentgemma-9b (8 of 38 layers, N = 2,831,372,288; a
                2 x 4096 prefill, the flash kernel once an attention
                layer, 2 a call), both at full width (SERVE_RECURRENT):
                the serve CLI
                (decode tok/s, peak memory; no kernel launched), the
                prefill (seconds, peak memory, operator calls), prefill
                against decode logits position by position over the
                prompt in bf16 and in fp32 compute (SERVE_HOLD: the
                positions held), a decode step and a prefill profiled;
     train_xlstm -- xlstm-1.3b at full width over one period (8
                layers, N = 420,716,544) through the train launcher: 15
                workers, 3 sign-flipping, flag, at a per-worker batch of
                4 x 128 (2 steps: the sLSTM's gradient overflows, in the
                reference too: recorded) and 4 x 32 (4 steps, finite), the
                tree Gram and the combine once a step; step time, peak
                memory;
     serve_mixtral, serve_deepseek -- the Mixture-of-Experts family at
                full width, the depth cut: mixtral-8x7b at 1 of its 32
                layers (N = 1,713,418,240; a 2 x 8192 prefill, where its
                window of 4096 bites) and deepseek-moe-16b at its dense
                head and 1 MoE layer (N = 1,091,315,712; 2 x 4096): the
                serve CLI (no kernel launched), the prefill (the flash
                kernel once an attention layer, nothing else;
                the share of slots each MoE layer drops at capacity
                factor 1.25, each MoE block's output RMS over its
                input's), prefill against decode over the CLI's prompts
                with the config drop-free, in bf16 and fp32 (positions
                routed alike held to a tolerance, any other explained by
                a near tie of the router), a decode step and a prefill
                profiled;
     train_moe -- deepseek-moe-16b at full width over its dense head and
                one MoE layer (N = 1,091,315,712) through the train
                launcher: 8 workers, 2 sign-flipping, flag, 3 steps of
                4 x 128 tokens a worker, twice from the same seed; the
                tree Gram and the combine once a step, the router
                losses, step time, peak memory, and the final
                parameters' SHA-256 equal in the two runs;
     serve_musicgen, serve_phi3v, serve_dense -- attention models at
                full width (SERVE_ATTN): musicgen-medium (12 of 48
                layers, N = 349,811,712; sinusoidal positions, a
                (B, 64, 768) conditioning prefix) and phi-3-vision-4.2b
                (8 of 32 layers, N = 1,115,606,016; a (B, 256, 1024)
                patch prefix), then stablelm-1.6b (6 of 24 layers),
                starcoder2-15b (2 of 40) and command-r-35b (2 of 40):
                the serve CLI on the token path (no kernel launched), a
                2 x 4096 prefill (the frontends' prefix first) with the
                flash kernel once a layer and nothing else, prefill
                against decode over the CLI's 4 x 64 prompts in bf16
                and fp32, and for the frontends the prefix path in fp32:
                the training forward's loss (plain attention) equal to
                the loss from the prefill's logits (flash) with the
                labels padded and the prefix masked, and another prefix
                moving every token's logits;
     train_musicgen -- musicgen-medium at full width over 8 of its 48
                layers (N = 236,485,632) with its prefix: W = 15, f = 3
                sign_flip, flag, 3 steps of 4 x (64 + 128) a worker,
                twice from one seed (the launcher's setup and step, the
                batch ``lm_worker_batches`` plus a seeded prefix): the
                tree Gram and the combine once a step, the projector's
                rows of d non-zero, SHA-256 equal;
  6. check   -- the same train CLI at the reduced size on the card (the
                kernels) and on the CPU (the plain versions) from the same
                weights and tokens must agree, for flag and for each of the
                seven baseline rules; ``aggregate_tree`` under a mask, card
                against CPU, for each baseline rule; the serving path at
                the reduced size, card against CPU (prefill logits, decode
                logits, the greedy token chain); the reduced train CLI
                under every codec x {flag, multi_krum, bulyan},
                with and without EF where the codec allows it, and signSGD
                with EF under a crash and under churn, card against CPU
                (losses, d, parameters; the sketch maps equal on both);
                top-k on values rounded to a grid, k through a tie: the
                card's kept set equal to the CPU's;
                the looped ``tree_gram(fused=False)``, card against
                CPU; and the recurrent architectures at the reduced size,
                card against CPU: one flag train step, prefill logits,
                decode logits over a 70-token prompt (recurrentgemma's
                ring buffer wraps) and the greedy chain; the same for the
                MoE architectures (mixtral's ring wraps), with the router
                losses, d and the parameters of the train step and every
                MoE call's routing (experts and kept slots) equal; the
                two frontend architectures the same way, the train step
                and a prefill with a prefix, decode on the token path;
                and the dense trio's serving path;
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
                codec's encode, decode and EF round at full width, leaf
                range by leaf range as the round runs,
                ``compressed_aggregate`` for each
                train_comm run, the tree Gram at the sketch's shape
                (15 x 22,613,820) against its byte bound, and
                CountSketch's deterministic encode (the slot table) beside
                one atomic ``index_add_`` a row, each run twice;
     timing_recurrent -- flash attention at recurrentgemma-9b's layer
                against its band's bound, its plain version and the
                library's fused attention with the band as a boolean mask;
                the recurrences the port keeps in plain PyTorch (the
                chunkwise mLSTM, the sLSTM step loop, the RG-LRU and its
                scan) at the prefills' shapes, profiled (host time, device
                busy time, operator calls), and the RG-LRU's fp32
                products beside the same products in bf16;
     timing_moe -- flash attention at mixtral-8x7b's layer (B 2, H 32,
                KV 8, S 8192, d 128, window 4096, bf16) against its
                band's bound, its plain version and the library's fused
                attention with the band as a boolean mask;
     timing_frontends -- the same at phi-3-vision-4.2b's layer (MHA 32,
                d 96) and starcoder2-15b's (GQA 48 / 4 of 128), causal
                over 4,096 positions, beside the library's causal fused
                attention.

Then the ``nvidia-smi`` line, the ``{"kernels": [...]}`` line and, last,
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import functools
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
MAIN_LAYERS = 32                # smollm-360m's, each with one gated MLP
MAIN_F = 3
TRAIN_STEPS = 4
TRAIN_ARGV = ["--arch", "smollm-360m", "--workers", str(MAIN_W),
              "--byzantine", str(MAIN_F), "--attack", "sign_flip",
              "--steps", str(TRAIN_STEPS), "--log-every", "1"]
# aggregator -> the kernels its main-path run must launch once a step
TRAIN_RUNS = {"flag": ("tree_gram", "weighted_sum"),
              "bulyan": ("tree_gram", "bulyan_select", "coord_stats"),
              "multi_krum": ("tree_gram", "krum_scores", "weighted_sum")}
# steps of each (flag's TRAIN_STEPS: the sharded and resume phases hold
# theirs against it; bulyan and multi_krum 2 since the other families'
# train_tp runs came, 4 before: the script's time limit)
TRAIN_RUN_STEPS = {"flag": TRAIN_STEPS, "bulyan": 2, "multi_krum": 2}
# the codec runs at full width: (aggregator, codec, faults, steps, the
# kernels each step must launch once).  The churn run takes 6 steps: its
# default schedule drops worker 0 for steps 0-4 and, at step 5, takes it
# back (its frozen EF row resumes) and drops worker 1.  The others take 2,
# the steps train_sharded holds its codec runs against (4 before the
# train_tp phase came, 3 before its other families came: the script's
# time limit).
TRAIN_COMM_RUNS = (
    ("flag", "countsketch", "none", 2, ("tree_gram", "weighted_sum")),
    ("flag", "signsgd", "none", 2, ("tree_gram", "weighted_sum")),
    ("multi_krum", "topk", "none", 2, ("tree_gram", "krum_scores",
                                       "weighted_sum")),
    ("bulyan", "countsketch", "none", 2, ("tree_gram", "bulyan_select",
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
# train_sharded: the worlds of ranks on the one card (gloo), each with
# its runs (aggregator, codec, steps), one after another in one process
# group per rank; W = 15 is odd, so R = 2 is the replicated path, R = 3
# the split path (5 workers a rank, all_to_all).  The R = 2 runs take 2
# steps, the held steps (they are held to their controls bit for bit at
# every step); R = 3's flag run takes 3, so that the update of its step 1
# is held too (step 2's loss within SHARDED_SPREAD of the unsharded run).
# Cut when the
# train_tp phase came: the flag runs took 4 steps, the
# R = 2 flag x countsketch 3; R = 2's multi_krum run (its sharded path
# runs under top-k) and R = 3's bulyan run (3 steps; bulyan runs sharded
# under CountSketch at R = 2) went; and when train_tp's other families
# came, R = 2's flag run without a codec (3 steps, equal to its 2-block
# control bit for bit: R = 2's flag x signSGD and flag x CountSketch runs
# take the same replicated path and are held to their controls so).
# Every run keeps the schedule's horizon (--steps TRAIN_STEPS); one of
# fewer steps stops after its last.  A world's ranks draw each
# configuration's weights once for all its runs (``_drawn_once``).
# The R = 2 world also runs the decoding and EF codecs on the shards
# (flag x signSGD and multi_krum x top-k with error feedback, bulyan x
# CountSketch decoded), 2 steps each, held against train_comm's unsharded
# runs of the same rule and codec.
SHARDED_WORLDS = ((2, (("flag", "countsketch", 2),
                       ("flag", "signsgd", 2),
                       ("multi_krum", "topk", 2),
                       ("bulyan", "countsketch", 2))),
                  (3, (("flag", "none", 3),)))
# ZeRO-1 (TrainConfig(zero1=True): the AdamW moments cut over the mesh's
# data axis, repro_torch.dist.zero1) in the R = 2 world, mesh (data 2,
# model 1): a twin of that world's flag x countsketch run, the same argv
# and steps with the moments cut.  The optimizer is per coordinate, so
# the parameters' SHA-256 after every step must equal the twin's (the R =
# 2 world has had no flag x none run since train_tp's families came; its
# flag x countsketch run takes the same optimizer path).  Every smollm
# leaf has a dimension 2 divides: a rank holds half of each moment, so its
# peak must fall by one moment, ZERO1_PEAK_DROP (2 moments x 4 N / 2; the
# zero1 update's temporaries, one gather a leaf, are smaller than the
# whole update's), held to ZERO1_PEAK_SHARE of it (the allocator's
# rounding), and each step all-gathers the rank's 4 N / 2 = 723,642,240 B
# of parameter blocks over its data group, one call a leaf
# (ZERO1_GATHER_BYTES).  A first reading with one gather of the whole
# vector fell only 806,618,624 B (gloo gathers into a flat buffer and
# copies out: the update then held the vector three times).
ZERO1_WORLD, ZERO1_TWIN = 2, ("flag", "countsketch")
ZERO1_PEAK_DROP, ZERO1_PEAK_SHARE = 4 * MAIN_N, 0.98
ZERO1_GATHER_BYTES = 4 * MAIN_N // 2
SHARDED_KERNELS = {("flag", "none"): TRAIN_RUNS["flag"],
                   ("multi_krum", "none"): TRAIN_RUNS["multi_krum"],
                   ("bulyan", "none"): TRAIN_RUNS["bulyan"],
                   **{(a, c): k for a, c, f, _, k in TRAIN_COMM_RUNS
                      if f == "none"}}
# The decoding codecs' runs are held on steps 0-1 (SHARDED_HELD_STEPS),
# each worker's EF norm per leaf too (SHARDED_EF_RTOL, relative; top-k's
# exactly: its kept sets are exact and its decode shard-local).  flag x
# signSGD is held to its 2-block control (the unsharded run with its Gram
# and its scales summed over the 2 column blocks as the ranks sum them,
# ``_blocked``) bit for bit in place of the FA and |d| tolerances: on
# signSGD's decoded gradients the FA solve turns the Gram's reassociation
# alone into FA weights 2.6e-5 and |d| 2.0e-3 apart (read on an H100 80GB
# HBM3 at 700 W; a control with the Gram alone blocked shows the same).
SHARDED_BY_CONTROL = (("flag", "signsgd"),)
SHARDED_EF_RTOL = 1e-6
# Held against the unsharded runs.  The schedule's lr is 0 at step 0, so
# steps 0 and 1 start from the same parameters in both runs and differ
# only by the fp32 reassociation of the Gram's coordinate sum over the
# shards: their losses exactly, FA weights within SHARDED_C_ATOL and |d|
# within SHARDED_D_RTOL relative (13x and 12x the largest readings,
# 7.6e-8 and 8.1e-6, with torch's one-rounding silu; bulyan x CountSketch
# and multi_krum x top-k read 0).  Since the activations round as JAX's
# (models/activations.py) the FA solve on smollm's no-codec gradients at
# these steps turns the reassociation alone into FA weights 1.8e-4 and
# |d| 1.5e-2 apart: the 2- and 3-block controls of the flag run without a
# codec read so (5.0e-8 / 6.8e-6 with the one-rounding silu, ``dev28c``;
# the CountSketch and signSGD controls 5.1e-8 / 1.0e-5 and 1.7e-7 /
# 2.7e-5, ``final28``; H100 80GB HBM3, 700 W).  So a flag run with a
# control of its own rule is held there within those tolerances plus
# SHARDED_SPREAD times its control's distance from the unsharded run,
# a distance that must stay within SHARDED_NEAR_CEILING (about 5x the
# 1.8e-4 / 1.5e-2 readings: a control that drifts fails, it does not
# widen the check), and on the same steps within SHARDED_CONTROL_C_ATOL
# / SHARDED_CONTROL_D_RTOL of its control (the R = 3 run reads 1.46e-6 /
# 1.20e-4, ``final28``; the R = 2 runs must equal theirs).  Every other
# run keeps the fixed tolerances.
# From step 2 the parameters differ by step 1's update.  A control
# tells what the reassociation alone does there: the unsharded flag path
# with its Gram summed by hand, in shard order, over the tree Grams of
# the same R column blocks (CoordShards.local) on this one device (under
# CountSketch, its payload summed so over the blocks' sketches).  With 2
# blocks the sum has two addends, which commute: the R = 2 runs must equal
# their controls to the bit at every step.  With 3 the ranks' sum may
# group them otherwise, so a flag run's later steps hold the update of
# the step before: their loss (read before that step's FA solve) within
# SHARDED_SPREAD times the largest distance from the unsharded run that
# the controls of its codec show there, plus SHARDED_LOSS_RTOL.  Their FA
# weights and |d| are printed beside the same limits, not held: since the
# activations round as JAX's, step 2's FA solve turns R = 3's regrouping
# (1.2e-4 of |d| from its control at step 1) into FA weights 6.7e-3 and
# |d| 0.65 from the unsharded run where the control lands 8.5e-4 / 0.065
# (loss 1.20e-5 against 7.5e-6; H100 80GB HBM3, 700 W): a branch of the
# solve that no tolerance drawn from the control bounds.
# multi_krum's and bulyan's picks equal at every step, and then their
# losses, |d| and FA weights to the bit (equal picks give the same
# combine).
SHARDED_HELD_STEPS = 2
SHARDED_C_ATOL, SHARDED_D_RTOL, SHARDED_LOSS_RTOL = 1e-6, 1e-4, 1e-6
SHARDED_SPREAD = 2.0
SHARDED_NEAR_CEILING = {"fa": 1e-3, "d_rel": 0.1}
SHARDED_CONTROL_C_ATOL, SHARDED_CONTROL_D_RTOL = 1e-5, 1e-3
SHARDED_TIMEOUT = 600          # seconds a world may take, its runs included
# train_tp: tensor parallelism over the mesh's model axis in a world of
# TP_WORLD ranks on this card (gloo), the host mesh (data 2, model 2).
# smollm-360m at full width and depth, W = 15 (odd: each data group
# computes all 15 workers, each rank of a model group its half of the
# model), flag, TP_STEPS step, its parameters' SHA-256 after it equal
# across the data groups; then the other families (TP_FAMILIES).  Cut
# when the other families came (the script's time limit): smollm-360m's
# TP bulyan run (2 steps of 25.7-25.8 s: musicgen-medium's 2-layer bulyan
# run in this world now takes a coordinate rule under tensor parallelism
# past its first step, at 2.4-3.0 s a step), the flag run's second step
# (2 before; musicgen-medium's flag run takes 2 steps: the exchange's
# buffers opened again, the kept TPReturn, AdamW's second update of the
# TP blocks and the data groups' SHA-256 after it) and stablelm-1.6b's
# run (2 layers, W = 2, one step; the split path with its heads split
# over the ranks: musicgen-medium's runs now take that path, its 24 heads
# split, with biases and an untied table).
TP_WORLD, TP_STEPS = 4, 1
TP_TIMEOUT = 600
# Step 0 against the control (this process: the unsharded step with every
# product on the blocks the ranks hold -- wq / wk / wv / up / gate and the
# unembedding as two column blocks, wo / down as two row blocks of fp32
# partial products summed in the model order and cast once, the
# vocabulary's log-softmax as two blocks -- and its
# Gram summed over the four coordinate blocks, ``_tp_blocked``): the
# forward is the same arithmetic on the same shapes, and a sum of two
# operands does not depend on their order, so the loss should be the
# same bits; it is held within TP_CONTROL_LOSS_RTOL (a half-width product
# that cuBLAS ran on another kernel would round otherwise; a wrong block
# would move it by orders more) and ``equal_to_control`` printed.  The
# backward is not reproduced (a column-parallel product's input gradient
# is two fp32 partial products summed over the ranks) and gloo's 4-rank
# sum of the Gram may group its addends otherwise: the FA weights within
# TP_CONTROL_C_ATOL, |d| within TP_CONTROL_D_RTOL.
TP_CONTROL_LOSS_RTOL, TP_CONTROL_C_ATOL, TP_CONTROL_D_RTOL = 1e-4, 1e-3, 1e-2
# smollm-360m against the train phase's unsharded run, every step: bf16
# compute, each row-parallel output two fp32 partial products summed and
# rounded once, where the unsharded product sums in another order:
# losses within TP_LOSS_RTOL, |d|
# within TP_D_RTOL, FA weights within TP_C_ATOL (a wrong block moves them
# by O(1)).
TP_LOSS_RTOL, TP_D_RTOL, TP_C_ATOL = 1e-2, 5e-2, 2e-2
# The other families against their own unsharded runs in this process, at
# about 10x the largest readings of their first one-step runs (an H100
# 80GB HBM3 at 700 W: loss 1.4e-4, |d| 2.3e-3, FA 8.1e-4); bulyan's picks
# equal at every step.
TP_FAMILY_LOSS_RTOL, TP_FAMILY_D_RTOL, TP_FAMILY_C_ATOL = 1.5e-3, 2.5e-2, 1e-2
# ... and leaf by leaf, from the AdamW first moment after step 0 ((1 -
# b1) d on both sides): each replicated leaf's relative L2 distance, each
# split leaf's block norm's relative difference within TP_LEAF_RTOL.  A
# replicated leaf fed a partial gradient on each rank (a norm or a conv
# on a split value) moves its own leaf by O(1) and |d| by far less: the
# RG-LRU's conv so fed moved its weight 0.70 from the unsharded run's,
# within the loss, |d| and FA limits (a mutation, smoke size, CPU).  Read
# on an H100 80GB HBM3 at 700 W: replicated leaves 9.1e-3 (musicgen flag)
# to 0.126 (xlstm's conv bias: the mLSTM's exponential gates amplify the
# ranks' bf16 partial sums), 8.7e-2 under bulyan (MeaMed's near ties);
# split block norms up to 7.5e-2 (xlstm), 7.1e-4 elsewhere under flag.
# A leaf whose gradient is nothing but rounding (attention's key bias:
# the softmax does not see it) is held relative to TP_LEAF_FLOOR times
# the whole moment's norm in place of its own.
TP_LEAF_RTOL, TP_LEAF_FLOOR = 0.3, 1e-4
BASELINES = ("krum", "multi_krum", "median", "trimmed_mean", "meamed",
             "phocas", "bulyan")
SOURCES = ("gram", "weighted_sum", "coord_stats", "krum_select",
           "flash_attn", "activations")
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
# their steps: 40 since the analysis phase came (the driver's default 60
# before: the script's time limit)
BYZ_RUN_STEPS = 40
BYZ_AUGMENT = ("lotka_volterra", "cat_map", "smooth_cat_map")
# (40 steps since the analysis phase came, 60 since the serve_tp phase,
# 100 before: the time limit)
BYZ_AUGMENT_KW = {"f": 0, "aggregator": "flag", "steps": 40,
                  "attack": "none", "augment_workers": 3,
                  "gaussian_sigma": 0.10}
# card against CPU: the same driver, weights and draws at a small size
BYZ_CHECK_KW = {"p": 7, "f": 1, "batch": 8, "steps": 4, "eval_every": 2}
BYZ_CHECK_RULES = ("flag", "pca", "mean", "geomed", "krum", "multi_krum",
                   "median", "trimmed_mean", "meamed", "phocas", "bulyan")
# benchmarks/comm_loss.py's codec rows: p = 15, f = 3, random x5, each
# codec under each rule, 50 steps (100 in that script and here before the
# train_tp phase's other families came: the script's time limit); then
# card against CPU per codec
BYZ_COMM_CODECS = ("none", "signsgd", "topk", "countsketch")
BYZ_COMM_RULES = ("flag", "multi_krum", "mean")
# 20 steps since the analysis phase came (30 since the serve_tp phase,
# 50 before: the time limit)
BYZ_COMM_KW = {"p": 15, "f": 3, "steps": 20, "attack": "random",
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
# run verifies 12 steps killed at 5 and 9, checkpointed every 3.  flag x
# CountSketch (fed to the Gram, no state to resume) and krum x identity
# went when train_tp's other families came (the script's time limit).
ELASTIC_ARGV = ["--verify", "--steps", "12", "--kill-at", "5,9",
                "--ckpt-every", "3"]
ELASTIC_RUNS = (
    ["--aggregator", "flag", "--attack", "sign_flip", "--byzantine", "1",
     "--codec", "signsgd"],
    ["--aggregator", "flag", "--codec", "signsgd", "--faults", "rejoin",
     "--fault-arg", "at=3", "--fault-arg", "down=4"],
    # the sketch decoded (no Gram feed) into the coordinate statistics
    ["--aggregator", "bulyan", "--workers", "8", "--byzantine", "1",
     "--codec", "countsketch"])
# the recurrent family at full width: xLSTM (7 mLSTM : 1 sLSTM) and
# RecurrentGemma ((rglru, rglru, attn) x 12 + 2 rglru), each with its
# parameter count at full depth (JAX's count_params_analytic).
XLSTM, RGEMMA = "xlstm-1.3b", "recurrentgemma-9b"
XLSTM_N, RGEMMA_N = 1_494_063_104, 9_396_195_328
# Their serve phases run at a cut depth since the train_sharded phase's
# codec runs came (the script's time limit): xlstm-1.3b at 8 of 48
# layers (one of its 6 periods, its sLSTM layer included; 16 before the
# train_tp phase came), recurrentgemma-9b at 8 of 38 ((rglru, rglru,
# attn) x 2 + 2 rglru: 2 attention layers), with JAX's
# count_params_analytic of the cut configs.  At full depth the two phases
# took 75.3 s and 46.0 s (H100 80GB HBM3, 700 W); at 24 and 14 layers
# 41.3 s and 25.7 s on a host 1.2x slower; at 16 and 8 25.5 s and 12.6 s.
# Cut to 4 and 5 when the serve_tp and dryrun phases came (the script's
# time limit; 8 and 8 before): xlstm's 4 hold its sLSTM (layer 3),
# recurrentgemma's 5 its attention layer (layer 2) and its ring.
SERVE_RECURRENT = {XLSTM: (4, 319_619_072), RGEMMA: (5, 2_174_889_984)}
# (batch, tokens) of each prefill; the serve CLI as SERVE_ARGV
XLSTM_PREFILL, RGEMMA_PREFILL = (4, 2048), (2, 4096)
# xlstm-1.3b trains at full width over one whole period (the sLSTM too)
TRAIN_XLSTM_LAYERS, TRAIN_XLSTM_N = 8, 420_716_544
TRAIN_XLSTM_ARGV = ["--workers", str(MAIN_W), "--byzantine", str(MAIN_F),
                    "--attack", "sign_flip", "--aggregator", "flag",
                    "--steps", str(TRAIN_STEPS), "--log-every", "1"]
# Per-worker batch 4 x seq.  At 128 tokens (the launcher's default) the
# sLSTM's backward through time overflows: under the JAX package's init
# its gradient grows ~1.7x a step at this width, in the reference as in
# the port (tests/test_torch_recurrent_models.py: over 1e3x from 16 to 32
# tokens in both), ~1e29 over 128 steps, so the step's gradient and the
# FA weights come out non-finite; that run is recorded and held to its
# launches and a finite first loss.  At 32 the gradient stays finite and
# the run must train with finite numbers.
TRAIN_XLSTM_SEQS, TRAIN_XLSTM_FINITE_SEQ = (128, 32), 32
# steps a length: the overflowing 128-token run 1 (4 before the train_tp
# phase came, 2 before its other families came: the script's time
# limit), the finite run TRAIN_STEPS
# (the finite run 2 since the serve_tp phase came, TRAIN_STEPS before)
TRAIN_XLSTM_STEPS = {128: 1, 32: 2}
# Prefill logits against decode logits at each prompt position, bf16
# compute, fp32 caches.  As SERVE_LOGIT_TOL argues, plus one more rounding
# a layer: with fp32 caches the decode path's conv output (mLSTM, RG-LRU)
# is fp32, as in the JAX package, where the prefill's is bf16, so the conv
# output differs by a bf16 rounding in every recurrent layer, and the
# recurrences carry it on.  16 ulps of the largest logits (2^-5 in [4, 8)).
RECURRENT_LOGIT_TOL = 0.5
# The same two paths in fp32 compute over the serve CLI's prompt: sums in
# another order only (the chunked against the stepwise mLSTM, the scan
# against the step), 48 / 38 layers deep.
RECURRENT_FP32_LOGIT_TOL = 1e-3
# Prompt positions held to those tolerances, (bf16, fp32).  xLSTM's sLSTM
# is chaotic under the JAX package's init (its recurrent r has fan-in 4,
# std 0.5, so a unit's recurrent input has std ~0.5 sqrt(dh)): it
# amplifies a difference ~1.7x a step, in the reference as in the port
# (tests/test_torch_recurrent_models.py holds that growth in both).  Read
# on an H100 80GB HBM3 at 700 W, at full width the gap doubles a
# position: fp32 2.3e-5 at position 0, 1.5e-4 at 3, 1.9e-3 at 7, O(6)
# from 20 on; bf16 0.17 at 0, 0.60 at 2.  So xLSTM's paths are held at
# position 0 (every layer's step from the zero state) and, in fp32, where
# the carried state is first read (positions 1-3), before the growth
# reaches the tolerance; the gaps at every position are printed.
# RecurrentGemma's linear recurrence has no such gain: all 64 positions
# are held in both.
SERVE_HOLD = {XLSTM: (1, 4), RGEMMA: (64, 64)}
# card against CPU at the reduced size, fp32, over 70 positions: as
# SMOKE_LOGIT_TOL, but the reduced sLSTM (dh 64) amplifies the two
# devices' rounding differences ~1.06x a position (~60x over 70; read on
# the H100: 4.6e-4, where recurrentgemma-smoke stays at 8e-6)
RECURRENT_SMOKE_LOGIT_TOL = {XLSTM: 2e-3, RGEMMA: SMOKE_LOGIT_TOL}
# recurrentgemma-9b's attention layer: (B, H, KV, S, d, window), bf16
RG_FLASH = (2, 16, 1, 4096, 256, 2048)
# card against CPU at the reduced size: prompt 70 past the reduced window
# of 64, so recurrentgemma-smoke's decode wraps its ring (max_len 80)
RECURRENT_CHECK_PROMPT, RECURRENT_CHECK_GEN, RECURRENT_CHECK_MAX = 70, 8, 80
# the Mixture-of-Experts family at full width with the depth cut:
# arch -> (layers, parameter count (JAX's count_params_analytic of the cut
# config), the prefill's (batch, tokens)).  mixtral-8x7b (8 experts
# top-2, GQA 32 / 8 of 128, window 4096) runs layers 0-1 of 32 (1.451e9 a
# layer, 0.262e9 of embeddings: 12.7 GB of fp32 weights; 187 GB at full
# depth; 4 layers until the train_sharded phase came, see SERVE_ATTN);
# deepseek-moe-16b (64 routed experts top-6 and 2 shared, MHA 16 of 128)
# its dense head and 3 MoE layers, 4 of 28 (65.5 GB at full depth).
# mixtral's 2 x 8192 prefill is where its window of 4096 bites.
MIXTRAL, DEEPSEEK = "mixtral-8x7b", "deepseek-moe-16b"
# mixtral-8x7b runs 1 layer since the serve_tp phase came (2 before),
# deepseek-moe-16b its head and 1 MoE layer since the analysis phase came
# (head + 2 since the serve_tp phase, head + 3 before): the script's time
# limit.
MOE_SERVE = {MIXTRAL: (1, 1_713_418_240, (2, 8192)),
             DEEPSEEK: (2, 1_091_315_712, (2, 4096))}
# Prefill against decode over the serve CLI's prompts, the config made
# drop-free (capacity_factor = E / k: at 1.25 the prefill drops slots
# and the decode's T = 4 tokens never do, so the two would compute
# different functions).  Routing is discrete: where the two paths' router
# inputs differ by rounding, a token whose k-th and (k+1)-th router logits
# are that close picks another expert, and its MoE output changes by
# O(its size) -- under JAX's bank init (fan-in E) ~1e4 times the block's
# input RMS at mixtral's width, so the position's logits are unrelated
# from there on.  A position is held to the logit tolerance where every
# layer routed it alike in the two paths; at a position that was routed
# differently the first layer that differs must show such a near tie (the
# prefill's gap between the k-th and (k+1)-th router logit at most twice
# the paths' largest router-logit difference at that token: the least a
# swap needs), and at most MOE_FLIP_SHARE of the positions may differ.
# bf16: SERVE_LOGIT_TOL's argument; fp32: sums in another order only.
MOE_LOGIT_TOL = {"bfloat16": SERVE_LOGIT_TOL, "float32": 1e-3}
MOE_FLIP_SHARE = {"bfloat16": 0.25, "float32": 1 / 64}
# deepseek-moe-16b trains at full width over its dense head and 1 MoE
# layer (N = 1,091,315,712) through the train launcher with its default
# 8 workers, 2 sign-flipping, flag, 3 steps of 4 x 128 tokens a worker,
# twice from the same seed: the parameters' SHA-256 must be equal (no
# float atomics in the MoE forward or backward).  Its (8, N) fp32 buffer
# is 34.9 GB; at W = 15 it would be 65.5 GB beside 13.1 GB of weights and
# AdamW moments: more than the card holds.
# 2 steps since the serve_tp phase came (3 before: the time limit)
TRAIN_MOE_LAYERS, TRAIN_MOE_N, TRAIN_MOE_STEPS = 2, 1_091_315_712, 2
TRAIN_MOE_ARGV = ["--workers", "8", "--byzantine", "2", "--attack",
                  "sign_flip", "--aggregator", "flag", "--steps",
                  str(TRAIN_MOE_STEPS), "--log-every", "1"]
# mixtral-8x7b's attention layer: (B, H, KV, S, d, window), bf16
MIXTRAL_FLASH = (2, 32, 8, 8192, 128, 4096)
# deepseek-moe-16b's attention layer in serve_deepseek's prefill: MHA 16
# of 128, causal over 4,096 tokens, no window
DEEPSEEK_FLASH = (2, 16, 16, 4096, 128, None)
# The MoE block's dropping path (positions at or past capacity, a dropped
# slot's zero row), card against CPU: the reduced configs at the full
# configs' capacity factor.  There the train check's 64 tokens a worker
# and the serve check's 3 x 70 prompt drop slots (read on the CPU: up to
# 10 % (mixtral-smoke) and 19 % (deepseek-smoke) of a train call's slots,
# 0.5 % and 8 % of a prefill layer's).
MOE_DROP_FACTOR = 1.25
# The multimodal frontends and the dense trio, served at full width:
# arch -> (layers on the card, parameter count: JAX's count_params_analytic
# of that depth).  musicgen-medium (12 of its 48 layers; sinusoidal
# positions, a (B, 64, 768) conditioning prefix), phi-3-vision-4.2b (8
# of its 32 layers; a (B, 256, 1024) patch prefix), stablelm-1.6b at 6
# of its 24, starcoder2-15b at 2 of 40 (24, 16, 12 and 4 before the
# train_tp phase came).  musicgen's
# and stablelm's depths (and mixtral's 2 layers,
# MOE_SERVE) were cut when the train_sharded phase came: at full depth
# the whole script took 1,220 s of its 1,200 on a slow host (H100 80GB
# HBM3, 700 W); phi-3-vision-4.2b's (27.1 s at 32 layers, 16.9 s at 16)
# when its sharded codec runs came, with SERVE_RECURRENT's;
# starcoder2-15b at 4 (now 2) of 40 layers (63.8 GB of fp32 weights at full
# depth) and command-r-35b at 2 of 40 (121 GB at full depth; its tied
# 256,000-token table makes 8.4 GB of fp32 logits a 2 x 4096 prefill).
# The weights are drawn on the host at ~9 ns a weight: at 8 and 4 layers
# the whole script took 1,100 s of its 1,200 (H100 80GB HBM3, 700 W), so
# these two depths were halved to keep ~10 % of the limit in hand.
MUSICGEN, PHI3V = "musicgen-medium", "phi-3-vision-4.2b"
STABLELM, STARCODER2, COMMAND_R = ("stablelm-1.6b", "starcoder2-15b",
                                   "command-r-35b")
ATTN_SHORT = {MUSICGEN: "musicgen", PHI3V: "phi3v", STABLELM: "stablelm",
              STARCODER2: "starcoder2", COMMAND_R: "command_r"}
# Cut when the serve_tp and dryrun phases came (the script's time
# limit): musicgen 12 -> 8, phi-3-vision 8 -> 4, stablelm 6 -> 4,
# starcoder2 and command-r 2 -> 1 layers (one attention layer each still
# runs its flash prefill and its decode).
SERVE_ATTN = {MUSICGEN: (8, 236_485_632), PHI3V: (4, 662_596_608),
              STABLELM: (4, 616_599_552), STARCODER2: (1, 987_839_488),
              COMMAND_R: (1, 2_801_844_224)}
# (batch, positions) of each prefill, the prefix included where there is
# one; and of the fp32 check of the prefix path
ATTN_PREFILL, PREFIX_CHECK = (2, 4096), (2, 1024)
# Each model's attention layer in that prefill, (B, H, KV, S, d, window),
# bf16, causal: held exactly in sweep_flash (phi-3-vision's head dim 96 is
# the kernel's 64-byte-swizzle case), and phi-3-vision's and
# starcoder2's (GQA 12 : 1) timed in timing_frontends.
ATTN_FLASH = {MUSICGEN: (2, 24, 24, 4096, 64, None),
              PHI3V: (2, 32, 32, 4096, 96, None),
              STABLELM: (2, 32, 32, 4096, 64, None),
              STARCODER2: (2, 48, 4, 4096, 128, None),
              COMMAND_R: (2, 64, 8, 4096, 128, None)}
# The prefix path in fp32 at full width: the training forward's loss
# (plain attention) against the loss from the prefill's logits (the flash
# kernel's fp32 body), the same padded labels and mask.  The two differ
# by the attention's sums taken in another order: fp32 logits agree to
# ~1e-5 (RECURRENT_FP32_LOGIT_TOL's argument), a token's NLL moves by at
# most twice its largest logit difference, and the loss is the mean over
# ~1,900 tokens; 2e-4 absolute on a loss of ~ln V (7.6 to 10.4).
PREFIX_LOSS_TOL = 2e-4
# musicgen-medium trains at full width over 8 of its 48 layers
# (N = 236,485,632; 16 before the train_tp phase came: the script's time
# limit) in the paper's main setting: W = 15, f = 3
# sign_flip, flag with lambda = W; each worker 4 x (64 prefix frames +
# 128 tokens), the prefix drawn from a seed beside lm_worker_batches' tokens
# (the launcher's synthetic data has none, in the JAX package too); 3
# steps, twice from the same seed.  Peak ~(W + 7) x 4 B x N = 41 GB.
TRAIN_MUSICGEN_LAYERS, TRAIN_MUSICGEN_N = 8, 236_485_632
TRAIN_MUSICGEN_STEPS = 3
# train_tp's other families: flag steps at full width with the depth
# cut, W = TP_FAMILY_W, each run against its own unsharded run in this
# process at the TP_FAMILY_* tolerances and TP_LEAF_RTOL.  mixtral-8x7b
# (1 of 32 layers), deepseek-moe-16b (its dense head and 1 MoE layer) and recurrentgemma-9b (its first 2 layers, the two
# RG-LRU blocks) hold 3.4 / 2.2 / 3.0 GB of parameters a rank on 2 ranks:
# four such ranks with their AdamW moments and shards would not fit the
# card, so they run in a world of TP_FAMILY_WORLD ranks, the mesh (data 1,
# model 2) (the launcher's host mesh of 2 ranks is (2, 1), with no model
# axis: ``_run_opts`` gives it this one); xlstm-1.3b (8 of 48 layers: one
# period, its sLSTM included) and musicgen-medium (2 of 48, with its
# 64-embedding prefix) join the world of 4.  mixtral runs under the
# expert-parallel rules (TP_EP: repro_torch.launch.dryrun.rules_for, as
# JAX's dryrun gives them; its 8 experts divide over model: 4 a rank), the others under the
# default rules (deepseek's banks split over d_e); xlstm at 32 tokens a
# sequence (the sLSTM's gain, TRAIN_XLSTM_SEQS) with its loss masked to
# each sequence's first TP_XLSTM_FIRST positions: the sLSTM amplifies a
# difference ~1.7x a position (SERVE_HOLD), so the ranks' bf16 partial
# sums would move the later positions' outputs by O(1), in the step and
# in its reference alike; over the first positions the loss and its
# gradient are held.  The MoE runs record their routing: a token routed
# otherwise than unsharded must show a near tie (``_tp_routing``).
# musicgen-medium runs twice in the world of 4, 2 steps each: flag at W =
# TP_FAMILY_W and bulyan at W = TP_BULYAN_W with TP_BULYAN_F
# sign-flipping workers (W >= 4f + 3): the second step and a coordinate
# rule under tensor parallelism (its MeaMed stage on each rank's
# shard); (arch, layers, world, rules overrides, extra argv, aggregator,
# steps).
TP_FAMILY_W, TP_FAMILY_WORLD, TP_XLSTM_FIRST = 2, 2, 4
TP_BULYAN_W, TP_BULYAN_F = 8, 1
# a family's rules TP_EP: repro_torch.launch.dryrun.rules_for(cfg, mesh,
# serving=False) on its mesh (mixtral-8x7b's 8 experts on 2 ranks:
# expert-parallel)
TP_EP = "rules_for"
TP_FAMILIES = (("xlstm-1.3b", 8, TP_WORLD, None, ("--seq", "32"), "flag", 1),
               ("musicgen-medium", 2, TP_WORLD, None, (), "flag", 2),
               ("musicgen-medium", 2, TP_WORLD, None, (), "bulyan", 2),
               ("deepseek-moe-16b", 2, TP_FAMILY_WORLD, None, (), "flag", 1),
               ("mixtral-8x7b", 1, TP_FAMILY_WORLD, TP_EP, (), "flag", 1),
               ("recurrentgemma-9b", 2, TP_FAMILY_WORLD, None, (), "flag",
                1))
TRAIN_MUSICGEN_ARGV = ["--workers", str(MAIN_W), "--byzantine", str(MAIN_F),
                       "--attack", "sign_flip", "--aggregator", "flag",
                       "--steps", str(TRAIN_MUSICGEN_STEPS), "--seq", "128",
                       "--log-every", "1"]
# card against CPU at the reduced size: one flag train step with a prefix
# (W = 8, f = 2 sign_flip, lambda = W, SGD, 2 x (8 prefix + 32 tokens) a
# worker, as check_recurrent's launcher run)
FRONTEND_CHECK_W, FRONTEND_CHECK_F, FRONTEND_CHECK_BS = 8, 2, (2, 32)


T0 = time.perf_counter()
# the card's name and power limit (nvidia-smi), once the card phase read it
CARD = {"nvidia_smi": None}


def emit(obj) -> None:
    """One JSON line; a phase's line also carries ``t_s``, the seconds
    since the script started (where the time limit goes), and ``card``,
    the card's name and power limit beside its numbers."""
    if "phase" in obj:
        obj = {**obj, "t_s": round(time.perf_counter() - T0, 1)}
        if CARD["nvidia_smi"] is not None:
            obj.setdefault("card", CARD["nvidia_smi"])
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
    line = CARD["nvidia_smi"] = nvidia_smi()
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
    # flash attention's two bodies (fp32 flash_fwd, bf16 flash_fwd_tc),
    # one line a head dim
    for line in built["flash_attn"].ptxas:
        if "flash_fwd" in line:
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
    aggregator, each run's peak memory, and each run's history (losses,
    |g|, FA weights, step seconds)."""
    import torch
    from repro_torch.launch import train

    counters = _counters()
    launches, peaks, hists = {}, {}, {}
    for agg, kernels in TRAIN_RUNS.items():
        steps = TRAIN_RUN_STEPS[agg]
        argv = TRAIN_ARGV + ["--aggregator", agg, "--device", DEVICE,
                             "--steps", str(steps)]
        torch.cuda.reset_peak_memory_stats()
        for _, reset in counters.values():
            reset()
        _act_reset()
        hist = train.main(argv)
        counts = {n: get() for n, (get, _) in counters.items()}
        act = _act_counts()
        peak = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in hist]
        if len(hist) != steps or not all(math.isfinite(x) for x in losses):
            raise AssertionError(f"train {agg}: losses {losses}")
        # one gated activation a layer and worker, forward and backward
        sites = steps * MAIN_W * MAIN_LAYERS
        act_want = {"act": 0, "act_gated": sites, "act_grad": 0,
                    "act_gated_grad": sites}
        if act != act_want:
            raise AssertionError(f"train {agg}: activation launches {act}, "
                                 f"want {act_want}")
        if agg == "flag":
            for form in ("act_gated", "act_gated_grad"):
                ACT_ROWS[form]["launches"] = act[form]
                ACT_ROWS[form]["launches_run"] = f"train {agg}"
        for h in hist:
            c = h["fa_weights"]
            if len(c) != MAIN_W or not all(math.isfinite(x) for x in c):
                raise AssertionError(f"train {agg}: fa_weights {c}")
        if any(counts[n] != steps for n in kernels):
            raise AssertionError(
                f"train {agg}: kernel launches {counts}, want {steps} "
                f"each of {kernels} (one per step)")
        for n in kernels:
            launches.setdefault(n, (counts[n], agg))
        peaks[agg] = peak
        hists[agg] = [{k: h[k] for k in ("loss", "lr", "grad_global_norm",
                                         "fa_weights", "step_s")}
                      for h in hist]
        steady = [h["step_s"] for h in hist[1:]]
        emit({"phase": "train", "aggregator": agg, "argv": argv,
              "losses": losses,
              "grad_global_norm": [h["grad_global_norm"] for h in hist],
              "fa_weights_last": hist[-1]["fa_weights"],
              "step_s": [h["step_s"] for h in hist],
              "step_s_after_warmup": sum(steady) / len(steady),
              "max_memory_allocated_bytes": peak, "launches": counts,
              "act_launches_per_step": {k: v // steps
                                        for k, v in act.items()}})
        del hist
        gc.collect()
        torch.cuda.empty_cache()
    return launches, peaks, hists


def _ef_parts(ef, cols) -> list:
    """[w][j]: the float64 sum of the squares of worker w's EF memory over
    columns ``cols[j]`` = (first column, count) of ``ef``."""
    import torch
    return [[float(torch.sum(ef[w, a:a + m].square(), dtype=torch.float64))
             for a, m in cols] for w in range(ef.shape[0])]


def _ef_norms(parts_by_shard) -> list:
    """(W, leaves) EF norms from each shard's ``_ef_parts`` over its range
    of every leaf, summed in shard order."""
    W, L = len(parts_by_shard[0]), len(parts_by_shard[0][0])
    return [[math.sqrt(sum(p[w][i] for p in parts_by_shard))
             for i in range(L)] for w in range(W)]


def phase_train_comm(flag_peak: int):
    """The main path under each codec run of TRAIN_COMM_RUNS at full
    width; returns, per (aggregator, codec) of the runs without faults,
    the run's history, its peak and, for the EF runs, each worker's EF
    norm per leaf after steps 0 and 1 (summed over the leaves' two
    coordinate ranges of R = 2, as train_sharded's ranks hold them): every
    listed kernel launched once a step and no other; the
    Gram-feed run (flag x countsketch) never decodes and peaks below the
    no-codec flag run's peak plus SKETCH_PEAK_MARGIN; comm_bits and
    comm_ratio are the cost models' exact counts (scaled by the active
    fraction under churn); under churn worker 0's EF row stays frozen (at
    zero) while it is out and resumes at step 5, when worker 1's freezes."""
    import torch
    from repro_torch.comm import compressors
    from repro_torch.dist.sharding import CoordShards
    from repro_torch.launch import train

    counters = _counters()
    decodes = {"n": 0}
    real_decode = compressors.CountSketchCodec.decode_range
    halves = CoordShards(tuple(_smollm_leaf_sizes()), 2)
    refs = {}

    def counting_decode(self, *a, **k):
        decodes["n"] += 1
        return real_decode(self, *a, **k)
    compressors.CountSketchCodec.decode_range = counting_decode
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
            ef_rows, ef_norms = [], []

            def on_step(t, state, m):
                if faults == "churn":
                    ef_rows.append((float(state.ef[0].abs().max()),
                                    float(state.ef[1].abs().max()),
                                    float(state.ef[1].double().sum())))
                elif state.ef is not None and t < SHARDED_HELD_STEPS:
                    ef_norms.append(_ef_norms([_ef_parts(state.ef, [
                        (a + lo, hi - lo) for (_, _, lo, hi), a in zip(
                            halves.cols(r), halves.flat_offsets)])
                        for r in range(2)]))
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
            if faults == "none":
                refs[agg, codec] = ([{k: h[k] for k in (
                    "loss", "lr", "grad_global_norm", "fa_weights", "step_s")}
                    for h in hist], peak, ef_norms)
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
                  "ef_norms_by_leaf_steps_0_1": ef_norms,
                  "launches": counts})
            del hist
    finally:
        compressors.CountSketchCodec.decode_range = real_decode
    gc.collect()
    torch.cuda.empty_cache()
    return refs


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
    return hashlib.sha256(memoryview(state.flat.detach().cpu().numpy())
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
    in each resumed step and nothing else (the resumed steps write no
    checkpoint of their own).  One line: save and load
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
            # the resumed steps save nothing: the launcher would write
            # step 4 again, a third save of the same state (the first
            # execution's two saves are the ones timed)
            args.ckpt_dir = None
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


def _sharded_argv(agg: str, codec: str, sharded: bool = True) -> list:
    return TRAIN_ARGV + ["--aggregator", agg, "--codec", codec, "--device",
                         DEVICE] + (["--sharded-agg"] if sharded else [])


class _Stop(Exception):
    """Ends a run from its step hook after its last wanted step."""


def _sharded_run(argv, counters, steps: int = TRAIN_STEPS,
                 sha_at: int | None = None, keep_step1: bool = False,
                 timed_from: int = 0, opts: dict | None = None) -> dict:
    """One run through the launcher on this rank, stopped after ``steps``
    steps (the schedule's horizon stays ``--steps``): each step's loss,
    |d|, FA weights, lr and seconds (from the end of the previous step's
    hook: step 0's include the set-up), launches (counters zeroed just
    before, read just after), peak memory, collective counts; with
    ``sha_at``, the parameters' SHA-256 after that step; with
    ``keep_step1``, step 1's d (as the aggregation returns it) and the
    parameters after step 1, on the card; with a sharded EF memory, its
    ``_ef_parts`` over the rank's range of every leaf after steps 0 and
    1.  Collectives are timed from step ``timed_from`` on (``timed_steps``
    of them; a sync before and after each call).  ``opts`` as
    :func:`_run_opts`; with ``routing``, every MoE call's router logits
    and top-k experts on the CPU (``routing``); with ``leaves``, the AdamW
    first moment after step 0 leaf by leaf (``_leaf_moments``); with
    ``sha_steps``, the parameters' SHA-256 after every step
    (``sha256_steps``)."""
    import torch
    import torch.distributed as dist
    from repro_torch.dist import sharded, train_step
    from repro_torch.launch import train

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    sharded.reset_comm_stats()
    sharded.comm_stats_timed(timed_from == 0)
    out = {"hist": [], "sha256": None, "timed_steps": steps - timed_from}
    clock = [0.0]

    def hook(t, state, m):
        if not out["hist"]:             # the state the run holds
            from repro_torch.launch.dryrun import argument_bytes
            out["state_bytes"] = argument_bytes(state)
            out["param_bytes"] = state.flat.numel() * state.flat.element_size()
            out["opt_bytes"] = sum(v.numel() * v.element_size()
                                   for v in state.opt_state.values()
                                   if v.dim())
            out["tp_dims"] = None if state.tp is None else state.tp.dims
        out["hist"].append({"loss": float(m["loss"]), "lr": float(m["lr"]),
                            "grad_global_norm": float(
                                m["grad_global_norm"]),
                            "fa_weights": m["fa_weights"].tolist(),
                            "step_s": time.perf_counter() - clock[0]})
        if t == sha_at:
            out["sha256"] = _flat_sha256(state)
        if sha_steps:
            out.setdefault("sha256_steps", []).append(_flat_sha256(state))
        if leaves is not None and t == 0:
            out["leaves"] = _leaf_moments(state, leaves)
        if keep_step1 and t == 1:
            out["theta1"] = state.flat.detach().clone()
        if state.ef_shard is not None and t < SHARDED_HELD_STEPS:
            _, shards, s = state.ef_shard
            out["shard"] = s
            out.setdefault("ef_parts", []).append(_ef_parts(state.ef, [
                (off, hi - lo) for _, off, lo, hi in shards.cols(s)]))
        out["backend"] = dist.get_backend() if dist.is_initialized() \
            else None
        out["device"] = str(state.flat.device)
        if t + 1 == timed_from:
            sharded.comm_stats_timed(True)
        if t == steps - 1 and steps < TRAIN_STEPS:
            raise _Stop
        clock[0] = time.perf_counter()

    aggregate = train_step.compressed_aggregate
    calls = [0]

    def keeping(*a, **k):
        d, aux, ef = aggregate(*a, **k)
        if calls[0] == 1:
            out["d1"] = d.detach().clone()
        calls[0] += 1
        return d, aux, ef
    for _, reset in counters.values():
        reset()
    if keep_step1:
        train_step.compressed_aggregate = keeping
    clock[0] = time.perf_counter()
    opts = dict(opts or {})
    routed = opts.pop("routing", False)
    leaves = opts.pop("leaves", None)
    sha_steps = opts.pop("sha_steps", False)
    try:
        with _run_opts(**opts), (Routing() if routed
                                 else contextlib.nullcontext()) as rt:
            try:
                train.main(argv, on_step=hook)
            except _Stop:
                pass
    finally:
        train_step.compressed_aggregate = aggregate
    if routed:
        out["routing"] = [{k: c[k].cpu() for k in ("logits", "top_e",
                                                  "kept")}
                          for c in rt.calls]
    out["launches"] = {n: get() for n, (get, _) in counters.items()}
    out["peak"] = torch.cuda.max_memory_allocated()
    out["comm"] = {k: dict(v) for k, v in sharded.comm_stats.items()}
    if len(out["hist"]) != steps:
        raise AssertionError(f"{argv}: {len(out['hist'])} steps, want "
                             f"{steps}")
    gc.collect()
    torch.cuda.empty_cache()        # the next run may be another process
    return out


def _leaf_moments(state, leaves) -> dict:
    """The AdamW first moment of ``state`` leaf by leaf, for
    ``_tp_leaves``: a replicated leaf whole on the CPU, a split leaf's
    norm.  ``leaves`` is ``True`` for a tensor-parallel state (its own
    split, and its model index), else the (dims, parts) of the split it
    is held against: each split leaf's norms of its ``parts`` blocks."""
    import torch
    from repro_torch.weights import leaf_items
    mu, lay = state.opt_state["mu"], state.layout
    if leaves is True:
        dims, parts, index = state.tp.dims, state.tp.parts, state.tp.index
    else:
        (dims, parts), index = leaves, None
    def norm(t) -> float:
        # float64 a block of rows at a time: no float64 copy of a whole
        # leaf (a tied table's block of AdamW's moment is 3.9 GB so)
        rows = max(1, (1 << 26) // max(1, t[0].numel())) if t.dim() else 1
        sq = sum(float(torch.linalg.vector_norm(
            t[i:i + rows], dtype=torch.float64)) ** 2
            for i in range(0, t.shape[0], rows)) if t.dim() else \
            float(t.double()) ** 2
        return math.sqrt(sq)

    out = []
    for o, n, shape, d in zip(lay.offsets, lay.sizes, lay.shapes, dims):
        v = mu[o:o + n].view(shape)
        if d is None:
            out.append(v.reshape(-1).cpu().clone())
        elif index is not None:
            out.append(norm(v))
        else:
            k = shape[d] // parts
            out.append([norm(v.narrow(d, m * k, k)) for m in range(parts)])
    return {"index": index, "leaves": out,
            "paths": ["/".join(map(str, p)) for p, _ in
                      leaf_items(state.params)]}


def _tp_leaves(per_rank, ref, what) -> dict:
    """A train_tp run's AdamW first moments after step 0 (``leaves``)
    against its unsharded run's: each replicated leaf's relative L2
    distance and its bits on every rank, each split leaf's block norm's
    relative difference (TP_LEAF_RTOL; a leaf's own norm floored at
    TP_LEAF_FLOOR times the whole moment's) -> the phase line's fields."""
    import torch
    want, first = ref["leaves"]["leaves"], per_rank[0]["leaves"]["leaves"]
    paths = ref["leaves"]["paths"]
    rep, split, same = (0.0, None), (0.0, None), True
    n_rep = sum(not isinstance(b, list) for b in want)
    norms = [b if isinstance(b, list) else
             [float(torch.linalg.vector_norm(b.double()))] for b in want]
    floor = TP_LEAF_FLOOR * math.sqrt(sum(x * x for b in norms for x in b))

    def rel(a, b):
        return a / max(b, floor)
    for r in per_rank:
        m = r["leaves"]["index"]
        for i, (a, b) in enumerate(zip(r["leaves"]["leaves"], want)):
            if isinstance(b, list):
                x = rel(abs(a - b[m]), b[m])
                if x >= split[0]:
                    split = (x, paths[i])
                continue
            same = same and torch.equal(a, first[i])
            x = rel(float(torch.linalg.vector_norm((a - b).double())),
                    float(torch.linalg.vector_norm(b.double())))
            if x >= rep[0]:
                rep = (x, paths[i])
    out = {"replicated_leaves": n_rep, "split_leaves": len(want) - n_rep,
           "replicated_worst_rel": rep[0], "replicated_worst_leaf": rep[1],
           "split_block_norm_worst_rel": split[0],
           "split_worst_leaf": split[1],
           "replicated_same_bits_on_every_rank": same,
           "leaves_under_the_floor": sum(max(b) < floor for b in norms),
           "tol_rel": TP_LEAF_RTOL, "floor": floor}
    if not same or rep[0] > TP_LEAF_RTOL or split[0] > TP_LEAF_RTOL:
        raise AssertionError(f"{what}: leaves against the unsharded run "
                             f"{out}")
    return out


def _sharded_rank(rank, runs, archs=(), then=(), then_ranks=0):
    """One rank of a train_sharded or train_tp world (started by
    ``repro_torch.launch.ranks.spawn``): the world's process group is made
    once from the torchrun-like environment, and each run of ``runs``
    ((argv, steps, sha_at, timed_from[, opts])) goes through
    ``train.main`` inside it, one after another (a run ("serve", arch,
    reference path) is a serve_tp run, ``_serve_tp_rank``); ``archs`` are (arch,
    layers) depth cuts registered first (``_arch_at_depth``).  Each
    configuration's weights are drawn once for the world's runs
    (``_drawn_once``).  With ``then``, the first ``then_ranks`` ranks
    then make a world of their own (a port from rank 0) and run those
    runs in it, the others leave: one start of the processes for both
    worlds."""
    import os

    import torch.distributed as dist
    from repro_torch.launch import train
    from repro_torch.launch.ranks import free_port
    for arch, layers in archs:
        _arch_at_depth(arch, layers)
    counters = _counters()

    def world(runs):
        return [_serve_tp_rank(rank, *run[1:]) if run[0] == "serve" else
                _sharded_run(run[0], counters, run[1], run[2],
                             timed_from=run[3],
                             opts=run[4] if len(run) > 4 else None)
                for run in runs]
    with _drawn_once():
        port = [free_port() if rank == 0 else None]
        with train.open_world(train._parser().parse_args(runs[0][0])):
            out = world(runs)
            if then:
                dist.broadcast_object_list(port, src=0)
        if rank >= then_ranks:
            return out
        os.environ.update(WORLD_SIZE=str(then_ranks),
                          LOCAL_WORLD_SIZE=str(then_ranks),
                          MASTER_PORT=str(port[0]))
        with train.open_world(train._parser().parse_args(then[0][0])):
            return out + world(then)


@contextlib.contextmanager
def _run_opts(mesh=None, rules=None, prefix=None, first=None, zero1=False):
    """A launcher run's setting, while the context lasts: ``mesh`` (a
    shape of (data, model)) replaces the host mesh the launcher builds (2
    ranks give (2, 1) there: a ``model`` axis of 1); ``zero1`` builds the
    step and the state with the optimizer moments cut over ``data``
    (``TrainConfig(zero1=True)``; the launcher has no flag for it, as
    JAX's has none); ``rules`` (overrides of
    the default rules) are active on that mesh, which the launcher keeps;
    ``prefix`` (an arch with a frontend) gives every worker batch a
    seeded prefix (``frontend_worker_batch``; the launcher's synthetic
    data has none); ``first`` gives it a loss mask over each sequence's
    first ``first`` positions (the loss and the gradient then depend on
    those positions alone)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import use_sharding
    from repro_torch.launch import mesh as mesh_lib, train
    saved = (train.make_host_mesh, train.lm_worker_batches,
             train.TrainConfig, train.init_train_state)
    if zero1:
        train.TrainConfig = functools.partial(train.TrainConfig, zero1=True)
        train.init_train_state = functools.partial(train.init_train_state,
                                                   zero1=True)
    if mesh is not None:
        train.make_host_mesh = lambda n=None: mesh_lib.Mesh(
            tuple(mesh), ("data", "model"))
    if prefix is not None:
        cfg = get_config(prefix)
        train.lm_worker_batches = (
            lambda task, wdc, step, seq, device=None:
            frontend_worker_batch(cfg, task, wdc, step, seq, device))
    if first is not None:
        plain = train.lm_worker_batches

        def masked(task, wdc, step, seq, device=None):
            batch = plain(task, wdc, step, seq, device=device)
            pos = torch.arange(batch["tokens"].shape[-1], device=device)
            batch["loss_mask"] = (pos < first).expand(
                batch["tokens"].shape)
            return batch
        train.lm_worker_batches = masked
    try:
        with (use_sharding(train.make_host_mesh(), rules) if rules
              else contextlib.nullcontext()):
            yield
    finally:
        (train.make_host_mesh, train.lm_worker_batches, train.TrainConfig,
         train.init_train_state) = saved


@contextlib.contextmanager
def _drawn_once():
    """While the context lasts, ``transformer.init_params`` draws each
    (configuration, seed, layout) once on the host and later calls copy
    that draw to the device: a seed gives the same weights, so the runs
    of one configuration need not draw them again (one draw kept at a
    time; smollm-360m's takes seconds)."""
    from repro_torch.models import transformer
    from repro_torch.weights import pack, unflatten
    draw, cache = transformer.init_params, {}

    def init_params(cfg, *, seed=0, device="cpu", layout=None):
        key = (cfg, seed, None if layout is None else (
            layout.dims, layout.parts, layout.index))
        if key not in cache:
            cache.clear()
            cache[key] = pack(draw(cfg, seed=seed, device="cpu",
                                   layout=layout))
        flat, lay = cache[key]
        return unflatten(flat.to(device), lay)
    transformer.init_params = init_params
    try:
        yield
    finally:
        transformer.init_params = draw
        cache.clear()


def _blocked(R: int, codec: str):
    """The control's patch, while the context lasts: the unsharded path's
    Gram (``aggregation.tree_gram`` of the (W, N) stack) or CountSketch's
    payload (``CountSketchCodec.sketch``, the Gram feed) becomes the sum in
    shard order of the same function of each of R coordinate shards'
    (W, width) buffers (the tree Gram kernel, or ``sketch_cols`` of the
    shard's leaf ranges): the buffers a world of R ranks holds, made here
    one at a time on this one device.  Under signSGD the Gram and the
    scales: each shard's ``scale_parts`` summed in shard order, the rows
    a shard boundary cuts divided by their length, as the ranks do."""
    import contextlib

    from repro_torch.comm.compressors import (CountSketchCodec, LeafCols,
                                              SignSGDCodec, cut_rows,
                                              leaf_cols)
    from repro_torch.dist import aggregation
    from repro_torch.dist.sharding import CoordShards

    shards = CoordShards(tuple(_smollm_leaf_sizes()), R)

    def in_order(parts):
        total = None
        for part in parts:
            total = part if total is None else total + part
        return total

    def gram(X, sketch_stride=1, **kw):
        return in_order(tree_gram(shards.local(X, s), sketch_stride, **kw)
                        for s in range(R))

    def sketch(self, X, layout):
        return in_order(self.sketch_cols(shards.local(X, s),
                                         leaf_cols(layout, shards, s))
                        for s in range(R))

    def scales(self, X, cols, reduce=None):
        # each shard's ranges read in place: columns c.off + [lo, hi)
        S = in_order(self.scale_parts(X, [
            LeafCols(c.i, c.off + lo, lo, hi, c.n, c.shape)
            for (_, _, lo, hi), c in zip(shards.cols(s), cols)])[0]
            for s in range(R))
        out, ro = [], 0
        for c in cols:
            last = c.shape[-1] if c.shape else 1
            out.append(S[:, ro:ro + c.n // last])
            for r in sorted({r for s in range(R) for r in cut_rows(
                    *shards.cols(s)[c.i][2:], last)}):
                out[-1][:, r].div_(last)
            ro += c.n // last
        return out

    tree_gram = aggregation.tree_gram
    patches = {"none": [(aggregation, "tree_gram", gram)],
               "countsketch": [(CountSketchCodec, "sketch", sketch)],
               "signsgd": [(aggregation, "tree_gram", gram),
                           (SignSGDCodec, "encode_range", scales)]}[codec]

    @contextlib.contextmanager
    def patched():
        saved = [(owner, name, getattr(owner, name))
                 for owner, name, _ in patches]
        for owner, name, fn in patches:
            setattr(owner, name, fn)
        try:
            yield
        finally:
            for owner, name, fn in saved:
                setattr(owner, name, fn)
    return patched()


def _step1_change(ref: dict, run: dict) -> dict:
    """How far step 1 of ``run`` moved from ``ref`` (both from
    ``keep_step1``): d's relative distance, the coordinates of d that
    differ and that change sign (and the largest |d| among those), the
    parameters after step 1 that differ, the largest |change| over the
    step's lr, and those that moved by more than one lr."""
    import torch
    a, b = run.pop("d1"), ref["d1"]
    flip = torch.sign(a) != torch.sign(b)
    n_flip = int(flip.sum())
    out = {"d_rel_diff": float(torch.linalg.vector_norm(a - b)
                               / torch.linalg.vector_norm(b)),
           "d_coords_differ": int((a != b).sum()),
           "d_sign_flips": n_flip,
           "d_max_abs_at_flips": float(b.abs()[flip].max()) if n_flip
           else 0.0,
           "d_rms": float(torch.linalg.vector_norm(b) / math.sqrt(
               b.numel()))}
    del a, flip
    lr = ref["hist"][1]["lr"]
    dt = (run.pop("theta1") - ref["theta1"]).abs()
    out.update({"params_differ": int((dt > 0).sum()),
                "params_max_abs_change_over_lr": float(dt.max()) / lr,
                "params_moved_over_lr": int((dt > lr).sum()),
                "lr_step1": lr})
    return out


def _diffs(hs, gs) -> dict:
    """Largest FA weight |diff|, |d| and loss relative diff over the steps
    of two runs' records (zip: the shorter run's steps)."""
    pairs = list(zip(hs, gs))
    if not pairs:
        return {"fa": 0.0, "d_rel": 0.0, "loss_rel": 0.0}
    return {"fa": max(abs(a - b) for h, g in pairs
                      for a, b in zip(h["fa_weights"], g["fa_weights"])),
            "d_rel": max(abs(h["grad_global_norm"] - g["grad_global_norm"])
                         / g["grad_global_norm"] for h, g in pairs),
            "loss_rel": max(abs(h["loss"] - g["loss"]) / abs(g["loss"])
                            for h, g in pairs)}


def _picks(c) -> list:
    return [i for i, x in enumerate(c) if x != 0.0]


def _check_sharded(R, agg, codec, per_rank, ref_hist, ref_peak,
                   control, spread, ref_ef=None) -> dict:
    """A sharded run's ranks against the unsharded run (SHARDED_*
    tolerances), a flag run against ``control`` (the history of the
    unsharded flag run with the R-block Gram or sketch) and its later
    steps against ``spread`` (the largest distance of its codec's
    controls from the unsharded run there), a decoding codec's run's EF
    norms against ``ref_ef`` (the unsharded run's, steps 0-1), and the
    ranks against each other; -> the phase line's fields (raises on a
    failure)."""
    what = f"train_sharded R={R} {agg} x {codec}"
    h0 = per_rank[0]["hist"]
    steps = len(h0)
    want = {n: (steps if n in SHARDED_KERNELS[(agg, codec)] else 0)
            for n in per_rank[0]["launches"]}
    if not all(math.isfinite(h["loss"]) for h in h0):
        raise AssertionError(f"{what}: losses {[h['loss'] for h in h0]}")
    for r in per_rank:
        if r["launches"] != want:
            raise AssertionError(f"{what}: launches {r['launches']}, "
                                 f"want {want}")
        if [h["fa_weights"] for h in r["hist"]] != [h["fa_weights"]
                                                   for h in h0] or \
                [h["loss"] for h in r["hist"]] != [h["loss"] for h in h0] \
                or r["sha256"] != per_rank[0]["sha256"]:
            raise AssertionError(f"{what}: the ranks' FA weights, losses or "
                                 f"parameters differ")
    held = SHARDED_HELD_STEPS
    if [g["lr"] for g in ref_hist[:held - 1]] != [0.0] * (held - 1):
        raise AssertionError(f"{what}: the unsharded run's lr "
                             f"{[g['lr'] for g in ref_hist]}: steps 0-"
                             f"{held - 1} no longer start from one state")
    early = _diffs(h0[:held], ref_hist)
    late = _diffs(h0[held:], ref_hist[held:])
    own = agg == "flag" and control is not None    # its own rule's control
    near = _diffs(control[:held], ref_hist) if own else \
        {"fa": 0.0, "d_rel": 0.0}
    if any(near[k] > SHARDED_NEAR_CEILING[k] for k in SHARDED_NEAR_CEILING):
        raise AssertionError(f"{what}: the control is {near} from the "
                             f"unsharded run on steps 0-{held - 1}, over "
                             f"the ceiling {SHARDED_NEAR_CEILING}")
    c_atol = SHARDED_C_ATOL + SHARDED_SPREAD * near["fa"]
    d_rtol = SHARDED_D_RTOL + SHARDED_SPREAD * near["d_rel"]
    held_vs_control = _diffs(h0[:held], control) if own else None
    picks = [_picks(h["fa_weights"]) for h in h0]
    ref_picks = [_picks(g["fa_weights"]) for g in ref_hist[:steps]]
    line = {"steps": steps, "losses": [h["loss"] for h in h0],
            "unsharded_losses": [g["loss"] for g in ref_hist[:steps]],
            "held_steps": held, "held_losses_equal": True,
            "fa_equal_on_every_rank": True,
            "held_fa_max_abs_diff": early["fa"],
            "held_grad_norm_max_rel_diff": early["d_rel"],
            "held_control_vs_unsharded": near,
            "held_limit": {"fa": c_atol, "d_rel": d_rtol},
            "held_vs_control": held_vs_control,
            "later_fa_max_abs_diff": late["fa"],
            "later_grad_norm_max_rel_diff": late["d_rel"],
            "later_loss_max_rel_diff": late["loss_rel"]}
    by_control = (agg, codec) in SHARDED_BY_CONTROL
    if [h["loss"] for h in h0[:held]] != [g["loss"] for g in
                                          ref_hist[:held]] \
            or not by_control and (early["fa"] > c_atol
                                   or early["d_rel"] > d_rtol):
        raise AssertionError(
            f"{what}: losses {[h['loss'] for h in h0]} vs "
            f"{[g['loss'] for g in ref_hist]}; steps 0-{held - 1}: FA "
            f"weights max |diff| {early['fa']} (tol {c_atol}), |d| "
            f"rel diff {early['d_rel']} (tol {d_rtol})")
    if own and (held_vs_control["fa"] > SHARDED_CONTROL_C_ATOL
                or held_vs_control["d_rel"] > SHARDED_CONTROL_D_RTOL):
        raise AssertionError(
            f"{what}: steps 0-{held - 1} vs its control {held_vs_control}, "
            f"over FA {SHARDED_CONTROL_C_ATOL} / |d| rel "
            f"{SHARDED_CONTROL_D_RTOL}")
    if agg in ("multi_krum", "bulyan"):
        if picks != ref_picks:
            raise AssertionError(f"{what}: picks {picks}, unsharded "
                                 f"{ref_picks}")
        # equal picks give the same combine of the same estimates; a
        # decoded sketch sums its buckets over the ranks (held above)
        if codec in ("none", "topk") and _max_diff(h0, ref_hist[:steps]):
            raise AssertionError(f"{what}: equal picks, yet the losses, |d| "
                                 f"or FA weights differ: "
                                 f"{_diffs(h0, ref_hist)}")
        line.update(picks=picks, unsharded_picks=ref_picks,
                    equal_to_unsharded=_max_diff(h0, ref_hist[:steps]) == 0)
    elif control is not None:
        limit = {"fa": SHARDED_SPREAD * spread["fa"] + SHARDED_C_ATOL,
                 "d_rel": SHARDED_SPREAD * spread["d_rel"] + SHARDED_D_RTOL,
                 "loss_rel": SHARDED_SPREAD * spread["loss_rel"]
                 + SHARDED_LOSS_RTOL}
        equal = _max_diff(h0, control[:steps]) == 0
        line.update(controls_later_vs_unsharded=spread, later_limit=limit,
                    vs_control_all_steps=_diffs(h0, control),
                    equal_to_control=equal)
        if R == 2 and not equal:
            raise AssertionError(f"{what}: two blocks, yet the run differs "
                                 f"from its control: "
                                 f"{_diffs(h0, control)}")
        if late["loss_rel"] > limit["loss_rel"]:
            raise AssertionError(f"{what}: steps {held}-{steps - 1} vs the "
                                 f"unsharded run {late}, the loss over the "
                                 f"limit {limit} (the control's spread "
                                 f"{spread})")
    if ref_ef is not None:
        ranks = sorted(per_rank, key=lambda r: r["shard"])
        norms = [_ef_norms([r["ef_parts"][t] for r in ranks])
                 for t in range(held)]
        rel = max(abs(a - b) / b for t in range(held)
                  for x, y in zip(norms[t], ref_ef[t]) for a, b in zip(x, y))
        line.update(ef_norms_by_leaf_steps_0_1=norms,
                    ef_norms_max_rel_diff=rel)
        if rel > (0.0 if codec == "topk" else SHARDED_EF_RTOL):
            raise AssertionError(f"{what}: EF norms per leaf {rel} apart "
                                 f"(relative) from the unsharded run's")
    peaks = [r["peak"] for r in per_rank]
    if R > 1 and max(peaks) >= ref_peak:
        raise AssertionError(f"{what}: peaks {peaks} B, unsharded "
                             f"{ref_peak} B")
    comm = per_rank[0]["comm"]
    line.update({
        "launches_per_rank": [r["launches"] for r in per_rank],
        "step0_s_with_setup_per_rank": [r["hist"][0]["step_s"]
                                        for r in per_rank],
        "step_s_after_warmup_per_rank": [
            sum(h["step_s"] for h in r["hist"][1:]) / (steps - 1)
            for r in per_rank],
        "unsharded_step_s_after_warmup": sum(
            g["step_s"] for g in ref_hist[1:]) / (len(ref_hist) - 1),
        "peak_bytes_per_rank": peaks, "unsharded_peak_bytes": ref_peak,
        "collective_bytes_per_step": {
            k: v["bytes"] / steps for k, v in comm.items()},
        "collective_s_per_step": {
            k: v["s"] / steps for k, v in comm.items()},
        "backend": per_rank[0]["backend"],
        "devices": [r["device"] for r in per_rank],
        "params_sha256": [r["sha256"] for r in per_rank]})
    return line


def _check_zero1(twin: list, zero1: list) -> dict:
    """The ZeRO-1 run's ranks against its twin's (ZERO1_*): the
    parameters' SHA-256 after every step, each rank's peak and optimizer
    bytes, the kernels' launches, the all-gather of the parameter blocks
    -> the phase line's fields (raises on a failure)."""
    what = f"train_sharded zero1 {ZERO1_TWIN}"
    steps = len(twin[0]["hist"])
    drops = [t["peak"] - z["peak"] for t, z in zip(twin, zero1)]
    ag = [z["comm"].get("zero1_all_gather", {}) for z in zero1]
    line = {
        "steps": steps, "losses": [h["loss"] for h in zero1[0]["hist"]],
        "sha256_steps_equal_twin": [t["sha256_steps"] == z["sha256_steps"]
                                    for t, z in zip(twin, zero1)],
        "params_sha256_steps": zero1[0]["sha256_steps"],
        "peak_bytes_per_rank": [z["peak"] for z in zero1],
        "twin_peak_bytes_per_rank": [t["peak"] for t in twin],
        "peak_drop_bytes_per_rank": drops,
        "peak_drop_want_at_least": ZERO1_PEAK_DROP,
        "opt_bytes_per_rank": [z["opt_bytes"] for z in zero1],
        "twin_opt_bytes_per_rank": [t["opt_bytes"] for t in twin],
        "zero1_all_gather_calls": [a.get("calls") for a in ag],
        "zero1_all_gather_bytes": [a.get("bytes") for a in ag],
        "zero1_all_gather_s": [a.get("s") for a in ag],
        "step_s_per_rank": [[h["step_s"] for h in z["hist"]]
                            for z in zero1],
        "twin_step_s_per_rank": [[h["step_s"] for h in t["hist"]]
                                 for t in twin],
        "launches_per_rank": [z["launches"] for z in zero1]}
    if not all(line["sha256_steps_equal_twin"]) or \
            len(zero1[0]["sha256_steps"]) != steps:
        raise AssertionError(f"{what}: the parameters differ from the "
                             f"twin's: {line['sha256_steps_equal_twin']}")
    if [z["launches"] for z in zero1] != [t["launches"] for t in twin]:
        raise AssertionError(f"{what}: launches {line['launches_per_rank']}"
                             f", the twin's {[t['launches'] for t in twin]}")
    if min(drops) < ZERO1_PEAK_SHARE * ZERO1_PEAK_DROP or any(
            2 * z["opt_bytes"] != t["opt_bytes"] for t, z in zip(twin,
                                                                 zero1)):
        raise AssertionError(f"{what}: peaks {line['peak_bytes_per_rank']}"
                             f" against {line['twin_peak_bytes_per_rank']}"
                             f", optimizer bytes {line['opt_bytes_per_rank']}"
                             f" against {line['twin_opt_bytes_per_rank']}")
    calls = steps * len(_smollm_leaf_sizes())       # every leaf is cut
    if any(a.get("calls") != calls or a.get("bytes") != steps
           * ZERO1_GATHER_BYTES for a in ag):
        raise AssertionError(f"{what}: zero1_all_gather {ag}, want "
                             f"{calls} calls, {ZERO1_GATHER_BYTES} B a "
                             f"step")
    return line


def phase_train_sharded(hists, peaks, comm_refs):
    """The sharded main path (``--sharded-agg``) at full width, held
    against the train and train_comm phases' unsharded runs: R = 1 in
    this process (NCCL, a world of one) bit for bit; the controls (the
    unsharded flag path with the Gram of 2 and of 3 column blocks, in this
    process); then the worlds of SHARDED_WORLDS, each rank a process on
    this card (gloo), one world per rank count, its runs one after
    another; then the tree Gram and the combine against their plain
    versions at a rank's (W, width) of R = 3."""
    from repro_torch.dist.sharded import coord_shards
    from repro_torch.launch import ranks
    from repro_torch.launch.mesh import Mesh

    counters = _counters()
    one = _sharded_run(_sharded_argv("flag", "none"), counters,
                       keep_step1=True)
    diff = _max_diff(one["hist"], hists["flag"])
    want = {n: (TRAIN_STEPS if n in TRAIN_RUNS["flag"] else 0)
            for n in one["launches"]}
    emit({"phase": "train_sharded", "ranks": 1, "aggregator": "flag",
          "codec": "none", "path": "one shard", "backend": one["backend"],
          "argv": _sharded_argv("flag", "none"),
          "losses": [h["loss"] for h in one["hist"]],
          "max_abs_diff_vs_train_phase": diff, "launches": one["launches"],
          "step_s_after_warmup": [h["step_s"] for h in one["hist"][1:]],
          "peak_bytes": one["peak"], "unsharded_peak_bytes": peaks["flag"],
          "collective_bytes_per_step": {
              k: v["bytes"] / TRAIN_STEPS for k, v in one["comm"].items()},
          "collective_s_per_step": {
              k: v["s"] / TRAIN_STEPS for k, v in one["comm"].items()}})
    if diff != 0 or one["launches"] != want:
        raise AssertionError(f"train_sharded R=1: diff vs the train phase "
                             f"{diff}, launches {one['launches']}, want "
                             f"{want}")
    controls, spread, held = {}, {}, SHARDED_HELD_STEPS
    for R, runs in SHARDED_WORLDS:
        for codec in sorted({c for a, c, _ in runs if a == "flag"}):
            steps = max(n for a, c, n in runs if (a, c) == ("flag", codec))
            ref_hist = comm_refs["flag", codec][0] if codec != "none" \
                else hists["flag"]
            with _blocked(R, codec):
                run = _sharded_run(
                    _sharded_argv("flag", codec, sharded=False), counters,
                    steps, keep_step1=codec == "none")
            controls[R, codec] = run["hist"]
            later = _diffs(run["hist"][held:], ref_hist[held:])
            spread[codec] = {k: max(v, spread.get(codec, {}).get(k, 0.0))
                             for k, v in later.items()}
            emit({"phase": "train_sharded_control", "blocks": R,
                  "aggregator": "flag", "codec": codec,
                  "losses": [h["loss"] for h in run["hist"]],
                  "grad_norms": [h["grad_global_norm"]
                                 for h in run["hist"]],
                  "held_vs_unsharded": _diffs(run["hist"][:held], ref_hist),
                  "later_vs_unsharded": later,
                  "step1_vs_unsharded": (_step1_change(one, run)
                                         if codec == "none" else None),
                  "peak_bytes": run["peak"]})
            del run
    del one
    gc.collect()
    import torch
    torch.cuda.empty_cache()
    for R, runs in SHARDED_WORLDS:
        t0 = time.perf_counter()
        specs = [(_sharded_argv(agg, codec), steps, None, 0,
                  {"sha_steps": R == ZERO1_WORLD and (agg, codec)
                   == ZERO1_TWIN}) for agg, codec, steps in runs]
        twin = next((i for i, (a, c, _) in enumerate(runs)
                     if R == ZERO1_WORLD and (a, c) == ZERO1_TWIN), None)
        if twin is not None:
            specs.append(specs[twin][:4] + ({"sha_steps": True,
                                             "zero1": True},))
        res = ranks.spawn(_sharded_rank, R, specs, timeout=SHARDED_TIMEOUT)
        world_s = time.perf_counter() - t0
        if twin is not None:
            emit({"phase": "train_sharded_zero1", "ranks": R,
                  "aggregator": ZERO1_TWIN[0], "codec": ZERO1_TWIN[1],
                  "world_s": world_s,
                  **_check_zero1([r[twin] for r in res],
                                 [r[len(runs)] for r in res])})
        for i, (agg, codec, steps) in enumerate(runs):
            ref_hist, ref_peak, ref_ef = (comm_refs[agg, codec]
                                          if codec != "none" else
                                          (hists[agg], peaks[agg], None))
            line = _check_sharded(R, agg, codec, [r[i] for r in res],
                                  ref_hist, ref_peak,
                                  controls.get((R, codec)),
                                  spread.get(codec), ref_ef or None)
            emit({"phase": "train_sharded", "ranks": R, "aggregator": agg,
                  "codec": codec, "argv": _sharded_argv(agg, codec),
                  "path": "split" if MAIN_W % R == 0 else "replicated",
                  "world_s": world_s, **line})
        del res
    width = coord_shards(
        [n for n in _smollm_leaf_sizes()], Mesh((3, 1), ("data", "model"))
    ).width
    emit({"phase": "train_sharded_kernels",
          **hold_gram_combine(MAIN_W, width, 17)})


def _tp_blocked(parts: int):
    """The control's patch of the unsharded forward, while the context
    lasts: every product on the blocks ``parts`` ranks hold under
    tensor parallelism -- ``layers.linear`` (wq / wk / wv / up / gate) on
    ``parts`` column blocks of ``w`` (and ``b``), concatenated;
    ``layers.row_linear`` (wo / down) on ``parts`` row blocks, the fp32
    partial products (``layers.product_f32``) summed in model order, cast
    to the compute dtype once and the bias added after;
    ``layers.unembed`` on ``parts`` blocks of the vocabulary -- and the
    NLL's log-softmax on ``parts`` blocks of the vocabulary as
    ``TensorParallel.vocab_nll`` computes it (the maxima's maximum, the
    blocks' sums of exponentials and target logits summed)."""
    import contextlib

    import torch
    from repro_torch.models import layers, transformer

    def cols(w, m):
        k = w.shape[-1] // parts
        return w[..., m * k:(m + 1) * k].contiguous()

    def linear(p, x, cdt):
        x = x.to(cdt)
        ys = []
        for m in range(parts):
            y = torch.matmul(x, cols(p["w"], m).to(cdt))
            if "b" in p:
                y = y + cols(p["b"], m).to(cdt)
            ys.append(y)
        return torch.cat(ys, dim=-1)

    def row_linear(p, x, cdt, tp=None):
        k = p["w"].shape[0] // parts
        y = None
        for m in range(parts):
            part = layers.product_f32(cols(x, m).to(cdt),
                                      p["w"][m * k:(m + 1) * k].to(cdt))
            y = part if y is None else y + part
        y = y.to(cdt)
        if "b" in p:
            y = y + p["b"].to(cdt)
        return y

    def unembed(p, x, cdt, tp=None):
        t = p["table"]
        k = t.shape[0] // parts
        x = x.to(cdt)
        return torch.cat([torch.matmul(x, t[m * k:(m + 1) * k].to(cdt).T)
                          for m in range(parts)], dim=-1)

    def nll(logits, labels, cfg, tp=None):
        k = logits.shape[-1] // parts
        blocks = [cols(logits, m) for m in range(parts)]
        gmax = blocks[0].amax(dim=-1)
        for b in blocks[1:]:
            gmax = torch.maximum(gmax, b.amax(dim=-1))
        total = None
        for m, b in enumerate(blocks):
            z = b - gmax[..., None]
            inside = (labels >= m * k) & (labels < (m + 1) * k)
            zt = torch.gather(z, -1, torch.where(inside, labels - m * k, 0)[
                ..., None])[..., 0]
            part = torch.stack([torch.exp(z).sum(dim=-1),
                                torch.where(inside, zt, torch.zeros_like(zt))])
            total = part if total is None else total + part
        return torch.log(total[0]) - total[1]

    patches = [(layers, "linear", linear), (layers, "row_linear", row_linear),
               (layers, "unembed", unembed), (transformer, "_nll", nll)]

    @contextlib.contextmanager
    def patched():
        saved = [(owner, name, getattr(owner, name))
                 for owner, name, _ in patches]
        for owner, name, fn in patches:
            setattr(owner, name, fn)
        try:
            yield
        finally:
            for owner, name, fn in saved:
                setattr(owner, name, fn)
    return patched()


def _tp_argv(arch: str, sharded: bool, extra=(), agg: str = "flag") -> list:
    """A train_tp run of ``arch`` (TP_FAMILIES): flag at TP_FAMILY_W
    workers, bulyan at TP_BULYAN_W with TP_BULYAN_F sign-flipping; the
    schedule's horizon TRAIN_STEPS."""
    workers = (["--workers", str(TP_BULYAN_W), "--byzantine",
                str(TP_BULYAN_F), "--attack", "sign_flip"]
               if agg == "bulyan" else ["--workers", str(TP_FAMILY_W)])
    return ["--arch", arch, *workers, "--steps", str(TRAIN_STEPS),
            "--log-every", "1", "--aggregator", agg, "--device", DEVICE,
            *extra] + (["--sharded-agg"] if sharded else [])


def _tp_routing(got, want, k: int, what: str) -> dict:
    """A tensor-parallel run's MoE calls (``_sharded_run``'s ``routing``)
    against its unsharded run's: the same calls; a token routed to
    another set of experts (the ranks' row-parallel sums round otherwise,
    so the router's input differs in its last bits) must show a near tie
    (the unsharded run's gap between its k-th and (k+1)-th router logit
    at most twice the two runs' largest difference of that token's
    logits: the least a swap needs), and at most MOE_FLIP_SHARE of the
    tokens may flip; with no flip the kept slots are equal."""
    import torch
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} MoE calls, unsharded "
                             f"{len(want)}")
    flips, tokens, kept_diff, delta = [], 0, 0, 0.0
    for i, (a, b) in enumerate(zip(got, want)):
        same = (a["top_e"].sort(-1).values == b["top_e"].sort(-1).values
                ).all(-1)
        srt = b["logits"].sort(-1, descending=True).values
        gap = srt[:, k - 1] - srt[:, k]
        dl = (a["logits"] - b["logits"]).abs().amax(-1)
        delta = max(delta, float(dl.max()))
        tokens += same.numel()
        kept_diff += int((a["kept"] != b["kept"]).sum())
        flips += [{"call": i, "token": t, "gap": float(gap[t]),
                   "reach": float(2 * dl[t])}
                  for t in (~same).nonzero()[:, 0].tolist()]
    out = {"tokens": tokens, "flipped": len(flips), "flips": flips[:16],
           "kept_slots_differing": kept_diff,
           "max_router_logit_delta": delta,
           "flip_share_limit": MOE_FLIP_SHARE["bfloat16"]}
    if any(f["gap"] > f["reach"] for f in flips) or len(flips) > \
            MOE_FLIP_SHARE["bfloat16"] * tokens or (not flips and kept_diff):
        raise AssertionError(f"{what}: routing against the unsharded run "
                             f"{out}")
    return out


def _tp_line(what, per_rank, ref_hist, ref_peak, n_full, kernels,
             steps, tol) -> dict:
    """A train_tp run's ranks: the same metric bits on every rank, every
    rank tensor-parallel, each kernel of ``kernels`` once a step on each
    rank and no other, each rank's peak below the unsharded run's; its
    history against the unsharded run's ``ref_hist`` (``tol``: the loss's
    relative, |d|'s relative and the FA weights' absolute limit); ->
    the phase line's fields (raises on a failure)."""
    h0 = per_rank[0]["hist"]
    want = {n: (steps if n in kernels else 0) for n in per_rank[0]["launches"]}
    keys = ("loss", "grad_global_norm", "fa_weights")
    for r in per_rank:
        if r["tp_dims"] is None:
            raise AssertionError(f"{what}: a rank holds the whole model")
        if r["launches"] != want:
            raise AssertionError(f"{what}: launches {r['launches']}, want "
                                 f"{want}")
        if [[h[k] for k in keys] for h in r["hist"]] != [
                [h[k] for k in keys] for h in h0]:
            raise AssertionError(f"{what}: the ranks' metrics differ")
    if not all(math.isfinite(h["loss"]) for h in h0):
        raise AssertionError(f"{what}: losses {[h['loss'] for h in h0]}")
    vs = _diffs(h0, ref_hist)
    if vs["loss_rel"] > tol[0] or vs["d_rel"] > tol[1] or vs["fa"] > tol[2]:
        raise AssertionError(f"{what}: against the unsharded run {vs} (tol "
                             f"loss {tol[0]}, |d| {tol[1]}, FA {tol[2]})")
    peaks = [r["peak"] for r in per_rank]
    if max(peaks) >= ref_peak:
        raise AssertionError(f"{what}: peaks {peaks} B, unsharded "
                             f"{ref_peak} B")
    comm, timed = per_rank[0]["comm"], per_rank[0]["timed_steps"]
    return {
        "steps": steps, "losses": [h["loss"] for h in h0],
        "unsharded_losses": [g["loss"] for g in ref_hist[:steps]],
        "grad_norms": [h["grad_global_norm"] for h in h0],
        "unsharded_grad_norms": [g["grad_global_norm"]
                                 for g in ref_hist[:steps]],
        "vs_unsharded": vs, "metrics_equal_on_every_rank": True,
        "picks": [_picks(h["fa_weights"]) for h in h0],
        "unsharded_picks": [_picks(g["fa_weights"])
                            for g in ref_hist[:steps]],
        "launches_per_rank": [r["launches"] for r in per_rank],
        "step_s_per_rank": [[h["step_s"] for h in r["hist"]]
                            for r in per_rank],
        "unsharded_step_s": [g["step_s"] for g in ref_hist[:steps]],
        "peak_bytes_per_rank": peaks, "unsharded_peak_bytes": ref_peak,
        "param_bytes_per_rank": [r["param_bytes"] for r in per_rank],
        "opt_bytes_per_rank": [r["opt_bytes"] for r in per_rank],
        "unsharded_param_bytes": 4 * n_full,
        "unsharded_opt_bytes": 8 * n_full,
        "split_leaves": sum(d is not None for d in per_rank[0]["tp_dims"]),
        "leaves": len(per_rank[0]["tp_dims"]),
        "collectives_timed_steps": timed,
        "tp_collectives_per_step": {
            k: {"calls": v["calls"] / steps, "bytes": v["bytes"] / steps,
                "s": v["s"] / timed if timed else None}
            for k, v in sorted(comm.items()) if k.startswith("tp_")},
        "other_collectives_per_step": {
            k: {"calls": v["calls"] / steps, "bytes": v["bytes"] / steps,
                "s": v["s"] / timed if timed else None}
            for k, v in sorted(comm.items()) if not k.startswith("tp_")},
        "backend": per_rank[0]["backend"],
        "devices": [r["device"] for r in per_rank]}


# serve_tp: tensor-parallel serving in the worlds train_tp starts (no new
# process start), each run under launch.dryrun.rules_for(cfg, mesh,
# serving=True) (sub_batch on data: each data group serves its rows) and
# held against the unsharded port's run in the main process on the same
# weights (seed 0): arch -> (layers, or None for the full depth, world
# (4: mesh (2, 2), 2: mesh (1, 2)), the prefill's (batch, tokens), the
# prompt's tokens, the tokens generated).  recurrentgemma-9b runs 3 layers
# (rglru, rglru, attn), one more than train_tp's 2: its attention layer
# is the hard cache layout.  smollm-360m at full width and
# depth (a 4 x 2048 prefill through flash_fwd_tc on each rank, every head
# on every rank: 15 heads on 2; its KV cache split by head_dim, 5 KV heads
# on 2); recurrentgemma-9b (KV 1: head_dim split, its 16 heads split) and
# mixtral-8x7b (expert-parallel; 8 KV heads split) in the world of 2;
# xlstm-1.3b (mLSTM / sLSTM heads split) and phi-3-vision-4.2b with its
# prefix (32 KV heads split) in the world of 4.
# smollm-360m's decode: 8 + 4 tokens since the analysis phase came (16 + 8
# before: the script's time limit)
SERVE_TP = {"smollm-360m": (None, 4, (4, 2048), 8, 4),
            XLSTM: (8, 4, (4, 256), 8, 4),
            PHI3V: (2, 4, (4, 256), 8, 4),
            RGEMMA: (3, 2, (2, 512), 8, 4),
            MIXTRAL: (1, 2, (2, 512), 8, 4)}
# prefill positions held against the unsharded logits: every
# SERVE_TP_EVERY-th and the last (the whole (B, S, V) logits do not cross
# processes)
SERVE_TP_EVERY = 64
# TP against unsharded logits, bf16 compute: the ranks' partial sums
# round their bf16 activations after sums in another order, the argument
# of SERVE_LOGIT_TOL; xlstm-1.3b's sLSTM amplifies any difference ~1.7x
# a position (SERVE_HOLD), so it is held at its first position only, and
# the gaps at the others are printed.  A generated token may differ from
# the unsharded run's only where that run's top-2 margin is within twice
# the tolerance; the first such step ends the comparison.  An MoE prefill
# token routed otherwise must show a near tie (_tp_routing); its logits
# are then not held (one layer: no later token reads it).
SERVE_TP_TOL = SERVE_LOGIT_TOL
SERVE_TP_HOLD = {XLSTM: 1}
# dryrun: the fake world of 4 traces smollm's train_tp run and its
# serve_tp prefill and serve step on fake CUDA tensors; its collectives
# (calls and bytes a kind) and argument bytes must equal rank 0's to the
# byte, its peak at most DRYRUN_PEAK_SLACK + DRYRUN_PEAK_RTOL below rank
# 0's torch.cuda.max_memory_allocated and at most DRYRUN_PEAK_RTOL above
# it: cuBLAS's workspace (a constant 64 MiB more in every reading on the
# H100 80GB HBM3 at 700 W: 68.1 MB at the train step, 67.1 MB at the
# prefill and the serve step) and the allocator's 512-byte rounding are
# no fake storage.  Then
# the CLI on the production mesh (256 fake ranks) for smollm-360m at each
# of its four shapes, DRYRUN_JOBS at once.  The three processes start
# before the train phase, on the host at a lower priority, and are
# collected after train_tp: they overlap the phases that keep one host
# core busy (train, train_comm, resume, train_sharded).  Started with
# train_tp, they outlasted its gloo world by ~64 s (the CLI's wall 222 s
# against the world's 158 on an H100 80GB HBM3 host at 700 W).
DRYRUN_PEAK_SLACK, DRYRUN_PEAK_RTOL = 96 * 2 ** 20, 0.01
DRYRUN_JOBS, DRYRUN_TIMEOUT = 1, 400


def _serve_tp_arch(arch: str) -> str:
    layers = SERVE_TP[arch][0]
    return arch if layers is None else _arch_at_depth(arch, layers)


def _serve_tp_inputs(cfg, arch: str) -> dict:
    """Seeded prompts, prefill tokens (and a prefix) on the CPU."""
    import torch
    _, _, (B, S), P, _ = SERVE_TP[arch]
    g = torch.Generator().manual_seed(17)
    out = {"prompts": torch.randint(0, cfg.vocab_size, (B, P), generator=g),
           "tokens": torch.randint(0, cfg.vocab_size, (B, S), generator=g)}
    if cfg.frontend is not None:
        out["prefix_embeds"] = torch.randn(
            (B, cfg.num_prefix_embeds, cfg.d_frontend), generator=g)
    return out


def _held_positions(S: int) -> list:
    return sorted(set(range(0, S, SERVE_TP_EVERY)) | {S - 1})


class _StepLogits:
    """While entered, keeps every ``transformer.decode_step``'s last
    logits (fp32, on the CPU)."""

    def __enter__(self):
        from repro_torch.models import transformer
        self.logits, self._mod = [], transformer
        self._fn = transformer.decode_step

        def recorded(*a, **k):
            logits, caches = self._fn(*a, **k)
            self.logits.append(logits[:, -1].float().cpu())
            return logits, caches
        transformer.decode_step = recorded
        return self

    def __exit__(self, *exc):
        self._mod.decode_step = self._fn
        return False


def _serve_tp_reference(arch: str) -> dict:
    """The unsharded port's serve_tp run of ``arch`` (main process, this
    card): prefill logits at the held positions, each decode step's
    logits, the greedy tokens, peaks and seconds; the MoE prefill's
    routing."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.serve_step import build_prefill_step, decode_loop
    from repro_torch.models import transformer
    name = _serve_tp_arch(arch)
    cfg = get_config(name)
    _, _, (B, S), P, G = SERVE_TP[arch]
    inp = {k: v.to(DEVICE) for k, v in _serve_tp_inputs(cfg, arch).items()}
    params = transformer.init_params(cfg, seed=0, device=DEVICE)
    batch = {k: v for k, v in inp.items() if k != "prompts"}
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with (Routing() if cfg.moe is not None
          else contextlib.nullcontext()) as rt:
        logits = build_prefill_step(cfg)(params, batch)
    torch.cuda.synchronize()
    out = {"prefill_s": time.perf_counter() - t0,
           "prefill_peak": torch.cuda.max_memory_allocated(),
           "prefill": logits[:, _held_positions(logits.shape[1])].cpu()}
    if rt is not None:
        out["routing"] = [{k: c[k].cpu() for k in ("logits", "top_e",
                                                  "kept")}
                          for c in rt.calls]
    del logits
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _StepLogits() as rec:
        toks = decode_loop(params, cfg, inp["prompts"], num_steps=G,
                           max_len=P + G)
    torch.cuda.synchronize()
    out.update(decode_s=time.perf_counter() - t0,
               decode_peak=torch.cuda.max_memory_allocated(),
               tokens=toks.cpu(), steps=torch.stack(rec.logits, dim=1))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def _expected_cache_bytes(cfg, mesh_shape, rules, B: int, max_len: int,
                          itemsize: int = 4) -> int:
    """A rank's cache bytes from the configuration's arithmetic (not from
    the port's layout code): each leaf's dimension split where ``rules``
    put it and it divides; the rank's rows of the batch."""
    data, model = mesh_shape

    def part(n, axis, parts):
        return n // parts if rules.get(axis) and parts > 1 and \
            n % parts == 0 else n
    b = part(B, "sub_batch", data)
    total = 0
    for kind in cfg.layer_kinds():
        if kind == "attn":
            clen = cfg.window if cfg.window and cfg.window < max_len \
                else max_len
            kv = part(cfg.num_kv_heads, "kv_heads", model)
            hd = part(cfg.head_dim, "head_dim", model)
            total += 2 * b * kv * clen * hd * itemsize
        elif kind == "mlstm":
            d_in = int(cfg.mlstm_proj_factor * cfg.d_model)
            H, dk = cfg.num_heads, d_in // cfg.num_heads
            h = part(H, "heads", model)
            total += 4 * b * h * (dk * dk + dk + 1) + itemsize * b * (
                cfg.conv_width - 1) * part(d_in, "state", model)
        elif kind == "slstm":
            dh = cfg.d_model // cfg.num_heads
            total += 4 * 4 * b * part(cfg.num_heads, "heads", model) * dh
        elif kind == "rglru":
            d_rnn = part(cfg.rglru_width or cfg.d_model, "state", model)
            total += 4 * b * d_rnn + itemsize * b * (cfg.conv_width - 1) \
                * d_rnn
    return total


def _serve_tp_rank(rank: int, arch: str, ref_path: str) -> dict:
    """``arch``'s serve_tp run on this rank of its world (SERVE_TP), held
    against the unsharded run in ``ref_path``: cache bytes, the prefill
    (launches, collectives, seconds, peak, logits at the held positions,
    the MoE's routing), the greedy decode loop (logits a step, tokens,
    collectives, seconds, peak); for smollm-360m also one serve step and
    the prefill as the fake trace of the dryrun phase sees them
    (collectives and argument bytes, the step's peak)."""
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.dist import sharded, tensor_parallel
    from repro_torch.dist.serve_step import (build_prefill_step,
                                             build_serve_step, decode_loop)
    from repro_torch.dist.sharding import (local_block, resolve_rules,
                                           use_sharding)
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer
    from repro_torch.weights import leaf_items
    name = _serve_tp_arch(arch)
    cfg = get_config(name)
    _, world, (B, S), P, G = SERVE_TP[arch]
    mesh = Mesh((world // 2, 2), ("data", "model"))
    rules = dryrun.rules_for(cfg, mesh, serving=True)
    ref = torch.load(ref_path, weights_only=False)
    counters = _counters()
    tp = tensor_parallel.for_mesh(mesh, rank)
    lay = transformer.tp_layout(cfg, mesh, resolve_rules(mesh, rules), rank)
    params = transformer.init_params(cfg, seed=0, device=DEVICE, layout=lay)
    inp = _serve_tp_inputs(cfg, arch)
    Vl = cfg.vocab_size // 2
    vb = slice(tp.index * Vl, (tp.index + 1) * Vl)
    out = {"rank": rank, "data": mesh.coords(rank)["data"]}

    def measured(fn):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        sharded.reset_comm_stats()
        sharded.comm_stats_timed(True)
        for _, reset in counters.values():
            reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        sharded.comm_stats_timed(False)
        return res, {"s": time.perf_counter() - t0,
                     "peak": torch.cuda.max_memory_allocated(),
                     "launches": {n: get() for n, (get, _) in
                                  counters.items() if get()},
                     "comm": {k: dict(v) for k, v in
                              sharded.comm_stats.items()}}
    with use_sharding(mesh, rules):
        rows = local_block((B, S), ("sub_batch", None))[0]
        out["rows"] = (rows.start, rows.stop)
        caches = transformer.init_caches(cfg, B, P + G, torch.float32,
                                         device=DEVICE)
        out["cache_bytes"] = sum(t.numel() * t.element_size()
                                 for _, t in leaf_items(caches))
        out["cache_bytes_want"] = _expected_cache_bytes(
            cfg, mesh.axis_sizes, resolve_rules(mesh, rules),
            B, P + G)
        del caches
        batch = {k: v[rows].contiguous().to(DEVICE) for k, v in inp.items()
                 if k != "prompts"}
        prefill = build_prefill_step(cfg, tp=tp)
        with (Routing() if cfg.moe is not None
              else contextlib.nullcontext()) as rt:
            logits, out["prefill"] = measured(lambda: prefill(params, batch))
        Sq = logits.shape[1]            # a prefix's positions included
        held = _held_positions(Sq)
        got = logits[:, held].float().cpu()
        want = ref["prefill"][rows][..., vb]
        out["prefill"]["finite"] = bool(torch.isfinite(logits).all())
        out["prefill"]["shape"] = list(logits.shape)
        del logits
        keep = torch.ones(got.shape[:2], dtype=torch.bool)
        if rt is not None:
            k = cfg.moe.top_k
            lo, hi = rows.start * Sq, rows.stop * Sq
            mine = [{"logits": c["logits"][lo:hi], "top_e": c["top_e"][lo:hi],
                     "kept": c["kept"][lo * k:hi * k]}
                    for c in ref["routing"]]
            out["routing"] = _tp_routing(
                [{n: c[n].cpu() for n in ("logits", "top_e", "kept")}
                 for c in rt.calls], mine, k, f"serve_tp {name} prefill")
            for f in out["routing"]["flips"]:
                b, s = divmod(f["token"], Sq)
                if s in held:
                    keep[b, held.index(s)] = False
            if out["routing"]["flipped"] > len(out["routing"]["flips"]):
                keep[:] = False      # more flips than listed: hold none
        gap = (got - want).abs().amax(-1)
        keep[:, SERVE_TP_HOLD.get(arch, len(held)):] = False
        out["prefill"]["max_abs_diff"] = float(gap[keep].max()) \
            if bool(keep.any()) else None
        out["prefill"]["gaps"] = gap.amax(0).tolist()
        out["prefill"]["ref_max_abs"] = float(want.abs().max())
        out["prefill"]["held_positions"] = len(held)
        with _StepLogits() as rec:
            toks, out["decode"] = measured(lambda: decode_loop(
                params, cfg, inp["prompts"].to(DEVICE), num_steps=G,
                max_len=P + G, tp=tp))
        steps = torch.stack(rec.logits, dim=1)
        out["tokens"] = toks.cpu()
        out["step_gaps"] = (steps - ref["steps"][rows][..., vb]).abs() \
            .amax(dim=(0, 2)).tolist()
        if arch == "smollm-360m":
            # the dryrun phase's counterparts: the prefill call above, and
            # one serve step against fresh caches
            out["prefill_args"] = dryrun.argument_bytes(params, batch)
            caches = transformer.init_caches(cfg, B, P + G, torch.float32,
                                             device=DEVICE)
            tok = inp["prompts"][rows, :1].to(DEVICE, torch.int32)
            serve = build_serve_step(cfg, max_len=P + G, tp=tp)
            _, out["serve_step"] = measured(
                lambda: serve(params, caches, tok, P))
            out["serve_step"]["args"] = dryrun.argument_bytes(
                params, caches, tok)
            del caches
    del params
    gc.collect()
    torch.cuda.empty_cache()
    out["backend"] = dist.get_backend()
    return out


def _check_serve_tp(arch: str, per_rank: list, ref: dict) -> dict:
    """serve_tp's checks on one arch's ranks; -> its phase line."""
    name = _serve_tp_arch(arch)
    _, world, (B, S), P, G = SERVE_TP[arch]
    what = f"serve_tp {name}"
    hold = SERVE_TP_HOLD.get(arch)
    for r in per_rank:
        if r["cache_bytes"] != r["cache_bytes_want"]:
            raise AssertionError(f"{what}: rank {r['rank']} holds "
                                 f"{r['cache_bytes']} B of caches, its "
                                 f"layout {r['cache_bytes_want']} B")
        pf = r["prefill"]
        if not pf["finite"]:
            raise AssertionError(f"{what}: non-finite prefill logits")
        if pf["max_abs_diff"] is not None and \
                pf["max_abs_diff"] > SERVE_TP_TOL:
            raise AssertionError(f"{what}: prefill logits "
                                 f"{pf['max_abs_diff']} from unsharded "
                                 f"(tol {SERVE_TP_TOL})")
        n = hold or len(r["step_gaps"])
        lo, hi = r["rows"]
        ref_tok = ref["tokens"][lo:hi]
        same = (r["tokens"] == ref_tok).all(0)
        first = int((~same).nonzero()[0]) if not bool(same.all()) else G
        if first < G:                   # a near tie, or a fault
            lg = ref["steps"][lo:hi, P - 1 + first]
            top2 = lg.topk(2, dim=-1).values
            margin = float((top2[:, 0] - top2[:, 1]).min())
            if margin > 2 * SERVE_TP_TOL:
                raise AssertionError(f"{what}: greedy token {first} differs "
                                     f"from unsharded (margin {margin})")
        n = min(n, P + first)
        if max(r["step_gaps"][:n]) > SERVE_TP_TOL:
            raise AssertionError(f"{what}: decode logits {r['step_gaps']} "
                                 f"from unsharded over the first {n} steps "
                                 f"(tol {SERVE_TP_TOL})")
        r["held_steps"], r["tokens_equal_steps"] = n, first
        want_flash = _cfg_layers(name, "attn")
        if r["prefill"]["launches"].get("flash_attn", 0) != want_flash or \
                any(v for k, v in r["prefill"]["launches"].items()
                    if k != "flash_attn"):
            raise AssertionError(f"{what}: prefill launches "
                                 f"{r['prefill']['launches']}, want "
                                 f"flash_attn {want_flash}")
    r0 = per_rank[0]
    kinds = sorted({k for r in per_rank for k in r["decode"]["comm"]})
    return {
        "ranks": world, "mesh": {"data": world // 2, "model": 2},
        "prefill_batch": B, "prefill_tokens": S, "prompt": P, "gen": G,
        "cache_bytes_per_rank": [r["cache_bytes"] for r in per_rank],
        "prefill_max_abs_diff": [r["prefill"]["max_abs_diff"]
                                 for r in per_rank],
        "prefill_ref_max_abs": r0["prefill"]["ref_max_abs"],
        "prefill_gaps_rank0": r0["prefill"]["gaps"],
        "decode_step_gaps_rank0": r0["step_gaps"],
        "held_steps": [r["held_steps"] for r in per_rank],
        "tokens_equal_steps": [r["tokens_equal_steps"] for r in per_rank],
        "tol": SERVE_TP_TOL,
        "flash_launches_per_rank": [r["prefill"]["launches"].get(
            "flash_attn", 0) for r in per_rank],
        "prefill_s_per_rank": [r["prefill"]["s"] for r in per_rank],
        "decode_s_per_rank": [r["decode"]["s"] for r in per_rank],
        "unsharded_prefill_s": ref["prefill_s"],
        "unsharded_decode_s": ref["decode_s"],
        "prefill_peak_per_rank": [r["prefill"]["peak"] for r in per_rank],
        "decode_peak_per_rank": [r["decode"]["peak"] for r in per_rank],
        "unsharded_prefill_peak": ref["prefill_peak"],
        "unsharded_decode_peak": ref["decode_peak"],
        "prefill_collectives_rank0": r0["prefill"]["comm"],
        "decode_collectives_rank0": {k: r0["decode"]["comm"].get(k)
                                     for k in kinds},
        "routing": r0.get("routing"), "backend": r0["backend"]}


def _cfg_layers(name: str, kind: str) -> int:
    from repro_torch.configs import get_config
    return sum(k == kind for k in get_config(name).layer_kinds())


_FAKE_WORLD = """
import json, sys
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from repro_torch.configs import get_config
from repro_torch.dist.sharding import use_sharding
from repro_torch.launch import dryrun, train
from repro_torch.launch.mesh import Mesh
argv, batch, serve, device = json.loads(sys.argv[1])
out = {}
with dryrun.fake_world(4), FakeTensorMode():
    run = train.setup(train._parser().parse_args(argv))
    shapes = {k: torch.empty(batch, dtype=torch.int32, device=device)
              for k in ("tokens", "labels")}
    with use_sharding(run.mesh, run.rules):
        out["train"] = dryrun.trace(
            lambda: run.step_fn(run.state, shapes, 0),
            (run.state, shapes), (run.state,))
    cfg = get_config(serve["arch"])
    mesh = Mesh((2, 2), ("data", "model"))
    with use_sharding(mesh, dryrun.rules_for(cfg, mesh, serving=True)):
        out["prefill"] = dryrun.trace_prefill(
            cfg, {"tokens": (tuple(serve["prefill"]), torch.int64)},
            device=device)
        out["serve_step"] = dryrun.trace_decode(
            cfg, serve["batch"], serve["max_len"], serve["step"],
            device=device, cache_dtype=torch.float32)
print(json.dumps(out))
"""


def _start_dryrun(tmp: str) -> dict:
    """The dryrun phase's subprocesses, started (they run on the host
    while the main path's phases run, from train to train_tp): the fake
    world of 4, the CLI on the production mesh and its ``--zero1`` run."""
    import os
    env = {**os.environ, "PYTHONPATH": str(Path(__file__).resolve().parent
                                           / "src")}
    _, _, (B, S), P, G = SERVE_TP["smollm-360m"]
    spec = [_sharded_argv("flag", "none"), [MAIN_W, 4, 128],
            {"arch": "smollm-360m", "prefill": [B, S], "batch": B,
             "max_len": P + G, "step": P}, DEVICE]
    t0 = time.perf_counter()

    # each in a session of its own, so that _stop ends the CLI's children,
    # and at a lower priority: they run on the host beside the TP world's
    # gloo ranks, which come first
    def start(args):
        return subprocess.Popen(
            [sys.executable, *args], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True, start_new_session=True,
            preexec_fn=_lower_priority)
    cli = ["-m", "repro_torch.launch.dryrun", "--arch", "smollm-360m",
           "--mesh", "single", "--device", DEVICE, "--out", tmp]
    return {"t0": t0,
            "fake": start(["-c", _FAKE_WORLD, json.dumps(spec)]),
            "cli": start(cli + ["--shape", "all", "--jobs",
                                str(DRYRUN_JOBS)]),
            "cli_zero1": start(cli + ["--shape", "train_4k", "--zero1",
                                      "--tag", "zero1"]), "tmp": tmp}


def _lower_priority() -> None:
    import os
    os.nice(10)


def _stop(proc) -> None:
    """End ``proc`` and every process of its session."""
    import os
    import signal
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except ProcessLookupError:
        pass
    proc.wait()


def _finish(proc, what: str):
    try:
        out, err = proc.communicate(timeout=DRYRUN_TIMEOUT)
    finally:
        _stop(proc)
    if proc.returncode != 0:
        raise AssertionError(f"dryrun {what}: exit {proc.returncode}: "
                             f"{(out or '')[-1500:]} {(err or '')[-3000:]}")
    return out


def _kinds(comm) -> dict:
    return {k: {"calls": v["calls"], "bytes": v["bytes"]}
            for k, v in sorted(comm.items())}


def phase_dryrun(started: dict, real: dict) -> None:
    """The dryrun phase (see DRYRUN_PEAK_RTOL): the fake world of 4's
    traces against rank 0's real counts, then the CLI's four
    combinations."""
    fake = json.loads(_finish(started["fake"], "fake world").strip()
                      .splitlines()[-1])
    lines = {}
    for kind, (comm, args, peak) in real.items():
        f = fake[kind]
        got = {k: {"calls": f["collectives"]["per_kind_count"][k],
                   "bytes": f["collectives"]["per_kind_bytes"][k]}
               for k in f["collectives"]["per_kind_count"]}
        want = _kinds(comm)
        short = peak - f["memory"]["peak_bytes"]      # what no storage shows
        rel = short / peak
        lines[kind] = {"collectives_equal": got == want,
                       "argument_bytes": f["memory"]["argument_bytes"],
                       "real_argument_bytes": args,
                       "peak_bytes": f["memory"]["peak_bytes"],
                       "real_max_memory_allocated": peak,
                       "real_minus_fake_peak": short, "peak_rel": rel,
                       "flops": f["flops_per_device"],
                       "flops_dots_raw": f["flops_dots_raw_per_device"],
                       "collectives": got}
        if got != want or f["memory"]["argument_bytes"] != args or \
                not -DRYRUN_PEAK_RTOL * peak <= short <= \
                DRYRUN_PEAK_SLACK + DRYRUN_PEAK_RTOL * peak:
            raise AssertionError(f"dryrun {kind}: fake {got}, "
                                 f"{f['memory']}; real {want}, args {args},"
                                 f" peak {peak}")
    emit({"phase": "dryrun_fake_world", "mesh": {"data": 2, "model": 2},
          "device": DEVICE, "peak_slack": DRYRUN_PEAK_SLACK,
          "peak_rtol": DRYRUN_PEAK_RTOL, **lines})
    out = _finish(started["cli"], "cli")
    seconds = time.perf_counter() - started["t0"]    # started before train
    from repro_torch.configs.shapes import SHAPES
    rows = {}
    for shape in SHAPES:
        path = Path(started["tmp"]) / f"smollm-360m_{shape}_single.json"
        res = json.loads(path.read_text())
        if not res.get("ok") or f"[ok]    smollm-360m_{shape}_single" \
                not in out:
            raise AssertionError(f"dryrun cli {shape}: {out[-2000:]} "
                                 f"{res.get('error')}")
        rows[shape] = {"flops_per_device": res["flops_per_device"],
                       "flops_dots_raw": res["flops_dots_raw_per_device"],
                       "peak_bytes": res["memory"]["peak_bytes"],
                       "argument_bytes": res["memory"]["argument_bytes"],
                       "collectives": res["collectives"],
                       "elapsed_s": res["elapsed_s"],
                       "variant": res["variant"]}
    emit({"phase": "dryrun_cli", "arch": "smollm-360m", "mesh": "16x16",
          "device": DEVICE, "jobs": DRYRUN_JOBS,
          "collected_after_s": seconds,
          "combinations": rows})
    emit({"phase": "dryrun_zero1", **_dryrun_zero1(started, rows)})


def _dryrun_zero1(started: dict, rows: dict) -> dict:
    """The CLI's ``--zero1`` train_4k against its train_4k without it:
    argument bytes lower by exactly the SGD momentum's bytes that the cut
    removes from rank 0 (``dist.zero1.zero1_layout`` on the production
    mesh), one ``zero1_all_gather`` a cut leaf of its parameter blocks
    more and every other collective the same (raises otherwise)."""
    from repro_torch.configs import get_config
    from repro_torch.dist.sharding import resolve_rules
    from repro_torch.dist.zero1 import zero1_layout
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer
    out = _finish(started["cli_zero1"], "cli --zero1")
    res = json.loads((Path(started["tmp"])
                      / "smollm-360m_train_4k_single_zero1.json").read_text())
    if not res.get("ok"):
        raise AssertionError(f"dryrun cli --zero1: {out[-2000:]} "
                             f"{res.get('error')}")
    cfg, mesh = get_config("smollm-360m"), Mesh((16, 16), ("data", "model"))
    tp = transformer.tp_layout(cfg, mesh, resolve_rules(
        mesh, rules_for(cfg, mesh, serving=False)), 0)
    z = zero1_layout(tp.local, tp.dims, mesh, 0)
    removed = 4 * (z.full.numel - z.local.numel)
    base, coll = rows["train_4k"], dict(res["collectives"]["per_kind_count"])
    n_cut = sum(d is not None for d in z.dims)
    line = {"argument_bytes": res["memory"]["argument_bytes"],
            "without_zero1_argument_bytes": base["argument_bytes"],
            "momentum_bytes_removed": removed,
            "peak_bytes": res["memory"]["peak_bytes"],
            "without_zero1_peak_bytes": base["peak_bytes"],
            "zero1_all_gather": {
                "calls": coll.get("zero1_all_gather"),
                "bytes": res["collectives"]["per_kind_bytes"].get(
                    "zero1_all_gather")},
            "flops_per_device": res["flops_per_device"],
            "elapsed_s": res["elapsed_s"]}
    coll.pop("zero1_all_gather", None)
    if base["argument_bytes"] - line["argument_bytes"] != removed or \
            line["zero1_all_gather"]["calls"] != n_cut or \
            coll != base["collectives"]["per_kind_count"]:
        raise AssertionError(f"dryrun cli --zero1: {line}, collectives "
                             f"{coll} against {base['collectives']}")
    return line


def phase_train_tp(hists, peaks, started) -> dict:
    """Tensor parallelism over ``model`` at full width (the module
    docstring's ``train_tp``; TP_* settings); ``started`` the dry run's
    processes (``_start_dryrun``), checked at its end.  Returns, per
    kernel, its launches on rank 0 over the worlds' runs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.sharded import coord_shards
    from repro_torch.dist.sharding import resolve_rules
    from repro_torch.launch import ranks
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer

    import shutil
    import tempfile

    tmp = tempfile.mkdtemp(prefix="chip_smoke_serve_tp_")
    try:
        return _train_serve_tp(hists, peaks, tmp, started)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _train_serve_tp(hists, peaks, tmp, started) -> dict:
    import os

    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.sharded import coord_shards
    from repro_torch.dist.sharding import resolve_rules
    from repro_torch.launch import ranks
    from repro_torch.launch.dryrun import rules_for
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import transformer

    refs, paths = {}, {}

    def serve_ref(arch):
        """serve_tp's unsharded run of ``arch`` (the draw the run before
        it made, where it was this configuration's), kept in a file the
        ranks read."""
        refs[arch] = _serve_tp_reference(arch)
        paths[arch] = os.path.join(tmp, f"{arch}.pt")
        torch.save(refs[arch], paths[arch])

    counters = _counters()
    with _tp_blocked(TP_WORLD // 2), _blocked(TP_WORLD, "none"):
        control = _sharded_run(_sharded_argv("flag", "none", sharded=False),
                               counters, 1)
    serve_ref("smollm-360m")
    fams = []     # (name, world, opts, argv, reference, aggregator, steps)
    for arch, layers, world, rules, extra, agg, steps in TP_FAMILIES:
        name = _arch_at_depth(arch, layers)
        cfg = get_config(name)
        mesh = Mesh((world // 2, 2), ("data", "model"))
        if rules == TP_EP:
            rules = rules_for(cfg, mesh, serving=False)
        lay = transformer.tp_layout(cfg, mesh, resolve_rules(mesh, rules), 0)
        opts = {"prefix": name} if cfg.frontend else {}
        if cfg.moe is not None:
            opts["routing"] = True
        if arch == "xlstm-1.3b":
            opts["first"] = TP_XLSTM_FIRST
        ref = _sharded_run(_tp_argv(name, False, extra, agg), counters, steps,
                           opts={**opts, "leaves": (lay.dims, 2)})
        if arch in SERVE_TP and arch not in refs and \
                SERVE_TP[arch][0] == layers:
            serve_ref(arch)
        opts["leaves"] = True
        if world != TP_WORLD:
            opts["mesh"] = (1, world)
        if rules:
            opts["rules"] = rules
        fams.append((name, world, opts, _tp_argv(name, True, extra, agg), ref,
                     agg, steps))
    for arch in SERVE_TP:
        if arch not in refs:
            serve_ref(arch)
    gc.collect()
    torch.cuda.empty_cache()
    # each world's runs, a serve_tp run right after its configuration's
    # train_tp run (the ranks' draw is reused) or at the end
    served = set()

    def serve_after(arch, world, runs):
        if arch in SERVE_TP and SERVE_TP[arch][1] == world and \
                arch not in served and (arch == "smollm-360m" or any(
                    a == arch and d == SERVE_TP[arch][0]
                    for a, d, *_ in TP_FAMILIES)):
            served.add(arch)
            runs.append(("serve", arch, paths[arch]))
    runs = [(_sharded_argv("flag", "none"), TP_STEPS, TP_STEPS - 1,
             TP_STEPS - 1)]
    serve_after("smollm-360m", TP_WORLD, runs)
    small, index = [], {}
    for (arch, *_), (n, w, o, x, _, _, k) in zip(TP_FAMILIES, fams):
        if w == TP_WORLD:
            # each run of more than one step keeps its parameters'
            # SHA-256 after its last and times its collectives from step 1
            runs.append((x, k, k - 1 if k > 1 else None, min(k - 1, 1), o))
            index[n, x[x.index("--aggregator") + 1]] = (len(runs) - 1, w)
            serve_after(arch, w, runs)
        else:       # the second world: its first ranks after the first
            small.append((x, k, None, 0, o))
            index[n, x[x.index("--aggregator") + 1]] = (len(small) - 1, w)
            serve_after(arch, w, small)
    for arch, (_, w, *_) in SERVE_TP.items():
        if arch not in served:
            served.add(arch)
            (runs if w == TP_WORLD else small).append(
                ("serve", arch, paths[arch]))
    t0 = time.perf_counter()
    res = ranks.spawn(_sharded_rank, TP_WORLD, runs,
                      tuple((a, d) for a, d, *_ in TP_FAMILIES) + tuple(
                          (a, v[0]) for a, v in SERVE_TP.items()
                          if v[0] is not None), small,
                      TP_FAMILY_WORLD, timeout=TP_TIMEOUT)
    world_s = time.perf_counter() - t0
    launches = {}
    jobs = [("smollm-360m", "flag", TP_WORLD, 0, hists["flag"],
             peaks["flag"], MAIN_N, TP_STEPS, {})]
    for name, world, opts, argv, ref, agg, steps in fams:
        i, w = index[name, agg]
        jobs.append((name, agg, world, i if w == TP_WORLD else len(runs) + i,
                     ref["hist"], ref["peak"],
                     get_config(name).param_count(), steps,
                     {"opts": opts, "ref": ref, "argv": argv}))
    for name, agg, world, i, ref_hist, ref_peak, n, steps, fam in jobs:
        per_rank = [r[i] for r in res[:world]]
        what = f"train_tp {name} {agg}"
        tol = ((TP_FAMILY_LOSS_RTOL, TP_FAMILY_D_RTOL, TP_FAMILY_C_ATOL)
               if fam else (TP_LOSS_RTOL, TP_D_RTOL, TP_C_ATOL))
        line = _tp_line(what, per_rank, ref_hist, ref_peak, n,
                        SHARDED_KERNELS[(agg, "none")], steps, tol)
        if world == TP_WORLD and per_rank[0]["sha256"] is not None:
            shas = [r["sha256"] for r in per_rank]
            if shas[0] != shas[2] or shas[1] != shas[3]:
                raise AssertionError(f"{what}: the data groups' parameters "
                                     f"differ after step {steps - 1}: "
                                     f"{shas}")
            line["params_sha256"] = shas
        if agg == "bulyan" and line["picks"] != line["unsharded_picks"]:
            raise AssertionError(f"{what}: picks {line['picks']}, unsharded "
                                 f"{line['unsharded_picks']}")
        if name == "smollm-360m":
            c0, g0 = control["hist"][0], per_rank[0]["hist"][0]
            vs = _diffs([g0], [c0])
            line.update(control_step0={
                "loss": c0["loss"], "grad_norm": c0["grad_global_norm"],
                "equal_to_control": g0["loss"] == c0["loss"]
                and g0["fa_weights"] == c0["fa_weights"]
                and g0["grad_global_norm"] == c0["grad_global_norm"],
                "loss_equal": g0["loss"] == c0["loss"],
                "loss_rel_diff": vs["loss_rel"], "fa_max_abs_diff": vs["fa"],
                "grad_norm_rel_diff": vs["d_rel"],
                "tol": {"loss_rel": TP_CONTROL_LOSS_RTOL,
                        "fa": TP_CONTROL_C_ATOL,
                        "grad_norm_rel": TP_CONTROL_D_RTOL}})
            if vs["loss_rel"] > TP_CONTROL_LOSS_RTOL \
                    or vs["fa"] > TP_CONTROL_C_ATOL \
                    or vs["d_rel"] > TP_CONTROL_D_RTOL:
                raise AssertionError(f"{what}: step 0 against its control "
                                     f"{vs}")
        else:
            line["leaves_step0"] = _tp_leaves(per_rank, fam["ref"], what)
        if fam.get("opts", {}).get("routing"):
            rts = [r["routing"] for r in per_rank]
            for r in rts[1:]:
                if any(not torch.equal(a["top_e"], b["top_e"])
                       for a, b in zip(r, rts[0])):
                    raise AssertionError(f"{what}: the ranks route "
                                         "differently")
            line["routing"] = _tp_routing(
                rts[0], fam["ref"]["routing"],
                get_config(name).moe.top_k, what)
        for k, v in per_rank[0]["launches"].items():
            launches[k] = launches.get(k, 0) + v
        opts = fam.get("opts", {})
        emit({"phase": "train_tp", "arch": name, "aggregator": agg,
              "ranks": world, "mesh": {"data": world // 2, "model": 2},
              "rules": "expert-parallel" if opts.get("rules")
              else "default",
              "prefix": bool(opts.get("prefix")),
              "loss_positions": opts.get("first"),
              "workers": (MAIN_W if name == "smollm-360m" else TP_BULYAN_W
                          if agg == "bulyan" else TP_FAMILY_W),
              "path": ("replicated" if name == "smollm-360m" or world == 2
                       else "split"),
              "argv": fam.get("argv", runs[0][0]), "worlds_s": world_s,
              "tol": {"loss_rel": tol[0], "grad_norm_rel": tol[1],
                      "fa": tol[2]}, **line})
    real = {}
    for arch, (_, world, *_) in SERVE_TP.items():
        entries = runs if world == TP_WORLD else small
        i = next(j for j, e in enumerate(entries)
                 if e[0] == "serve" and e[1] == arch)
        i = i if world == TP_WORLD else len(runs) + i
        per_rank = [r[i] for r in res[:world]]
        emit({"phase": "serve_tp", "arch": _serve_tp_arch(arch),
              **_check_serve_tp(arch, per_rank, refs[arch])})
        for k, v in per_rank[0]["prefill"]["launches"].items():
            launches[k] = launches.get(k, 0) + v
        if arch == "smollm-360m":
            r0 = per_rank[0]
            real["prefill"] = (r0["prefill"]["comm"], r0["prefill_args"],
                               r0["prefill"]["peak"])
            real["serve_step"] = (r0["serve_step"]["comm"],
                                  r0["serve_step"]["args"],
                                  r0["serve_step"]["peak"])
    from repro_torch.launch.dryrun import argument_bytes
    r0 = res[0][0]
    batch = torch.empty((MAIN_W, 4, 128), dtype=torch.int32, device="meta")
    real["train"] = (r0["comm"], r0["state_bytes"] + 2 * argument_bytes(
        batch), r0["peak"])
    del res
    width = coord_shards(_smollm_leaf_sizes(),
                         Mesh((2, 2), ("data", "model"))).width
    emit({"phase": "train_tp_kernels",
          **hold_gram_combine(MAIN_W, width, 18)})
    phase_dryrun(started, real)
    return launches


def _smollm_leaf_sizes() -> list:
    from repro_torch.configs import get_config
    from repro_torch.models import transformer
    from repro_torch.weights import layout_of
    return list(layout_of(transformer.param_shapes_tree(
        get_config("smollm-360m"))).sizes)


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
    # 2 steps (3 before the serve_tp and dryrun phases came: the
    # script's time limit): the second step reads the first's state
    common = ["--debug", "--steps", "2", "--seq", "32", "--workers", "8",
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
          "topk_ties": check_topk_ties(),
          "train_comm": check_train_comm(),
          "serve": check_serve(), "looped_tree_gram": check_looped_gram(),
          "recurrent": check_recurrent(), "moe": check_moe(),
          "frontends": check_frontends()})


def check_topk_ties() -> dict:
    """Top-k where the k-th |g| of a row is tied: (15, 1,000,003) normals
    rounded to 0.1, k = 62,500, the tie cut in most rows.  The card's kept
    set (the payload's indices, ``lax.top_k``'s rule: lowest index first
    among the ties) must be the CPU's, and the EF round's decode the same
    bits."""
    import torch
    from repro_torch.comm import CommConfig, ef_encode_decode, get_codec
    from repro_torch.weights import Layout

    n = 1_000_003
    gen = torch.Generator().manual_seed(41)
    X = torch.round(torch.randn((MAIN_W, n), generator=gen) * 10) / 10
    codec = get_codec(CommConfig(codec="topk"))
    k = codec._k(n)
    a = X.abs()
    t = a.topk(k, dim=1).values[:, -1:]
    cut = int((((a > t).sum(1) < k) & ((a >= t).sum(1) > k)).sum())
    idx = codec.encode_leaf(X, 0, (n,))["idx"]
    idx_card = codec.encode_leaf(X.to(DEVICE), 0, (n,))["idx"].cpu()
    layout = Layout(0, ((),), ((n,),))
    dec = ef_encode_decode(codec, X.clone(), layout)[0]
    dec_card = ef_encode_decode(codec, X.to(DEVICE), layout)[0].cpu()
    out = {"shape": [MAIN_W, n], "k": k, "rows_cutting_a_tie": cut,
           "kept_sets_equal": torch.equal(idx, idx_card),
           "decode_equal": torch.equal(dec, dec_card)}
    if cut < MAIN_W // 2 or not (out["kept_sets_equal"]
                                 and out["decode_equal"]):
        raise AssertionError(f"check topk ties: {out}")
    return out


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
             for agg in ("flag", "multi_krum", "bulyan")
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
    weights and tokens, for every codec under flag, multi_krum and bulyan
    (the median's own codec cases went when train_tp's other families
    came: the script's time limit; Bulyan's MeaMed keeps the coordinate
    statistics under every codec), with and without error feedback where
    the CLI allows it (signSGD and top-k carry it unless --no-ef); then
    signSGD with EF under a crash at step 2 and under churn with period 2,
    over 6 steps (a leave and a rejoin inside the run), under the
    median.  f = 1 of
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
    runs = [dict(p=p, f=f, aggregator=a, steps=BYZ_RUN_STEPS, **kw)
            for p, f, kw in BYZ_RUNS for a in BYZ_RULES]
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
        # the plain version timed on the call that checks the kernel (one
        # call since the analysis phase came, the mean of 2 more before:
        # the script's time limit)
        torch.cuda.synchronize()
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        want = coord_stat_plain(X, op, f, **kw)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
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
            "plain_ms": plain_ms,
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
    codec the encode (``encode_range``, its cross-rank step the identity
    here), the decode (``decode_range``) and the EF round, as the round
    runs them (every worker row of one leaf at a time, temporaries in
    blocks of rows), and ``compressed_aggregate``
    for each run of TRAIN_COMM_RUNS (host clock, ``host_ms``); then the
    tree Gram at the sketch's shape (W x sum_i k_i = 15 x 22,613,820),
    checked against its plain version and timed with CUDA events beside it
    and the library's product, against its byte bound.  Overwrites X."""
    import torch
    from repro_torch.comm import CommConfig, ef_encode_decode, get_codec
    from repro_torch.comm.compressors import leaf_cols
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

        cols = leaf_cols(layout)

        def encode_all(codec=codec, cols=cols):
            return codec.encode_range(X, cols)
        payload = encode_all()          # CountSketch draws its maps here

        def decode_all(codec=codec, payload=payload, cols=cols):
            for c, p in zip(cols, payload):
                codec.decode_range(p, X[:, c.off:c.off + c.hi - c.lo], c)
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
        return [cs.sketch(X, layout)]

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


def flash_plain_by_rows(q, k, v, window, rows: int = 1024):
    """``flash_attn_plain`` (causal, ``window``) one block of ``rows``
    queries at a time against the keys up to the block's end: the same
    function (queries align to the tail of the keys) without the whole
    (S, S) score matrix, 17 GB in fp32 at mixtral's layer."""
    import torch
    from repro_torch.kernels.flash_attn.ref import flash_attn_plain
    S = q.shape[2]
    return torch.cat([flash_attn_plain(q[:, :, a:a + rows],
                                       k[:, :, :a + rows],
                                       v[:, :, :a + rows], causal=True,
                                       window=window)
                      for a in range(0, S, rows)], dim=2)


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
    # the model layers exactly, bf16: recurrentgemma-9b's (MQA, d 256, a
    # window of 2,048 on 4,096 tokens), mixtral-8x7b's (GQA 32 / 8, d 128,
    # a window of 4,096 on 8,192 tokens), deepseek-moe-16b's (MHA 16,
    # d 128, causal over 4,096 tokens) and ATTN_FLASH's five (musicgen,
    # phi-3-vision at d 96, stablelm, starcoder2, command-r; causal over
    # 4,096 positions)
    layers = {}
    for key, shape in (("recurrentgemma_layer", RG_FLASH),
                       ("mixtral_layer", MIXTRAL_FLASH),
                       ("deepseek_layer", DEEPSEEK_FLASH),
                       *((ATTN_SHORT[a] + "_layer", sh)
                         for a, sh in ATTN_FLASH.items())):
        B, H, KV, S, d, win = shape
        q = torch.randn((B, H, S, d), generator=gen,
                        device=DEVICE).bfloat16()
        k, v = (torch.randn((B, KV, S, d), generator=gen,
                            device=DEVICE).bfloat16() for _ in range(2))
        o = flash_attn_cuda(q, k, v, causal=True, window=win)
        want = flash_plain_by_rows(q.float(), k.float(), v.float(), win)
        torch.cuda.synchronize()
        ratio, raw = flash_ratio(o, want, "bfloat16")
        bad = {"zeros": flash_ratio(torch.zeros_like(o), want,
                                    "bfloat16")[0],
               "off_2^-6": flash_ratio(o * FLASH_WRONG_SCALE, want,
                                       "bfloat16")[0]}
        if min(bad.values()) <= 1 or ratio > 1 or o.shape != q.shape:
            raise AssertionError(f"flash_attn at {shape}: max err {raw}, "
                                 f"{ratio} of the limit; wrong outputs "
                                 f"{bad}")
        layers[key] = {"b_h_kv_s_d_window": list(shape),
                       "max_abs_err": raw, "share_of_limit": ratio,
                       "wrong_output_multiple_of_limit": bad}
        del q, k, v, o, want
        torch.cuda.empty_cache()
    emit({"phase": "sweep_flash", "cases": cases, "d": list(FLASH_D),
          "heads_kv": [list(x) for x in FLASH_HEADS],
          "seq_q_k": [list(x) for x in FLASH_SEQ],
          "causal_window": [list(x) for x in FLASH_MASKS],
          "atol": FLASH_ATOL, "rtol": FLASH_RTOL, "worst_abs_err": worst,
          "worst_share_of_limit": sound,
          "wrong_output_least_multiple_of_limit": wrong, **layers})


# activations: the activation kernel (csrc/activations.cu, one pass of
# JAX's primitives with their roundings) against the eager composition
# (kernels/activations/ref.py, one kernel an op) on the card, over all
# 65,536 bf16 bit patterns and a seeded fp32 sample of ACT_F32_N values
# (normal sigma 4, uniform on [-100, 100], normal sigma 1e-3, the
# specials), forward, backward with a seeded cotangent, and the gated
# form up * f(gate) with both cotangents: the same bits, 0 values may
# differ (NaN equal to NaN).  Then the card (the kernel) against the
# composition on the CPU (held against JAX there,
# tests/test_torch_activations.py) over every finite bf16 value: CUDA's
# exp / tanh / log1p and the CPU's vectorised ones are other fp32
# approximations, so a rounding may flip where an fp32 result sits next to
# a bf16 tie: a handful of values, printed.  More than ACT_DIFFER_MAX of
# them fails: a composition that rounds once (F.silu's way) differs on
# ~1.9k.  Then the kernel, the composition and F.silu timed at
# smollm-360m's MLP width (the gate's silu over a 4 x 2048 prefill and one
# 4-token decode step), plain and gated, with each form's byte bound, and
# the host time a call at the decode width (host-bound there).
ACT_NAMES = ("sigmoid", "silu", "gelu", "softplus", "log_sigmoid", "tanh")
ACT_DIFFER_MAX = 64
ACT_SHAPES = {"prefill": (4, 2048, 2560), "decode": (4, 1, 2560)}
ACT_F32_N = 1 << 20
ACT_HOST_CALLS = 200
# the kernels line's rows of the activation kernel (phase_activations),
# their launches filled in by the main-path runs that launch them
ACT_ROWS: dict = {}
ACT_REPLACES = "src/repro/models/mlp.py:34"
ACT_REPLACES_NOTE = "XLA's fused activation loop; no Pallas kernel"


def _act_reset():
    from repro_torch.kernels.activations import kernel as act_k
    for k in act_k.launches:
        act_k.launches[k] = 0


def _act_counts() -> dict:
    from repro_torch.kernels.activations import kernel as act_k
    return dict(act_k.launches)


def _act_differ(a, b) -> int:
    """Values whose bits differ, NaN equal to NaN."""
    import torch
    iv = torch.int16 if a.dtype == torch.bfloat16 else torch.int32
    differ = (a.view(iv) != b.view(iv)) & ~(a.isnan() & b.isnan())
    return int(differ.sum())


def _act_pair(name, x, up, g):
    """(kernel, composition) results on the card for ``name`` at ``x``:
    the forward and its cotangent, and the gated form with both of its
    cotangents (``up`` the other factor, ``g`` the output's cotangent)."""
    from repro_torch.kernels.activations import ops, ref

    def run(fwd, gated):
        a = x.clone().requires_grad_(True)
        y = fwd(a)
        y.backward(g)
        u = up.clone().requires_grad_(True)
        b = x.clone().requires_grad_(True)
        yg = gated(u, b)
        yg.backward(g)
        return {"forward": y.detach(), "backward": a.grad,
                "gated": yg.detach(), "gated_d_up": u.grad,
                "gated_d_gate": b.grad}
    kern = run(lambda a: ops.act(name, a),
               lambda u, b: ops.gated(name, u, b))
    plain = run(ref.PLAIN[name], lambda u, b: ref.gated_plain(name, u, b))
    return kern, plain


def _act_times(shape, gen) -> dict:
    """Kernel, composition and library times of silu, plain and gated, and
    of the gated backward, at ``shape`` in bf16, with each form's bound."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.activations import kernel as act_k
    from repro_torch.kernels.activations import ref
    x, up, g = (torch.randn(shape, generator=gen, device=DEVICE).bfloat16()
                for _ in range(3))
    nbytes = x.numel() * x.element_size()
    out = {"shape": list(shape), "dtype": "bfloat16"}
    # the composition's backward alone: its recorded graph, replayed
    a, u, b = (t.clone().requires_grad_(True) for t in (x, up, x))
    y, yg = ref.silu_plain(a), ref.gated_plain("silu", u, b)
    forms = {
        # form: (kernel, composition, one library call or None, tensors
        # moved)
        "act": (lambda: act_k.act(x, "silu"), lambda: ref.silu_plain(x),
                lambda: F.silu(x), 2),
        "act_gated": (lambda: act_k.act_gated(up, x, "silu"),
                      lambda: ref.gated_plain("silu", up, x), None, 3),
        "act_grad": (lambda: act_k.act_grad(g, x, None, "silu"),
                     lambda: torch.autograd.grad(y, a, g, retain_graph=True),
                     lambda: torch.ops.aten.silu_backward(g, x), 3),
        "act_gated_grad": (lambda: act_k.act_gated_grad(g, up, x, "silu"),
                           lambda: torch.autograd.grad(yg, (u, b), g,
                                                       retain_graph=True),
                           None, 5)}
    kern_out, plain_out = _act_pair("silu", x, up, g)
    errs = {"act": ("forward",), "act_gated": ("gated",),
            "act_grad": ("backward",),
            "act_gated_grad": ("gated_d_up", "gated_d_gate")}
    for form, (kern, plain, lib, tensors) in forms.items():
        err = max(float((kern_out[k].float() - plain_out[k].float()).abs()
                        .max()) for k in errs[form])
        if err != 0:
            raise AssertionError(f"activations {form} at {list(shape)}: "
                                 f"max |kernel - composition| {err}")
        t, by = bound(tensors * nbytes, 0)
        ms = cuda_ms(kern, 20, 2)
        out[form] = {"ms": ms, "max_abs_err": err,
                     "plain_ms": cuda_ms(plain, 20, 2),
                     "library_ms": cuda_ms(lib, 20, 2) if lib else None,
                     "bytes": tensors * nbytes, "bound_ms": t,
                     "bound_by": by, "share_of_bound": t / ms}
    # no one library call computes up * silu(gate): F.silu and a product
    out["act_gated"]["F_silu_mul_ms"] = cuda_ms(lambda: up * F.silu(x), 20,
                                                2)
    out["library_calls"] = {"act": "F.silu",
                            "act_grad": "aten.silu_backward"}
    return out


def _act_host_us(gen) -> dict:
    """Host microseconds a call at the decode width, where the device
    waits on the host: ACT_HOST_CALLS back-to-back calls on the host
    clock, synchronised once at the end, for the public entry (the
    kernel's custom operator), the composition and F.silu, plain and
    gated."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels.activations import ref
    from repro_torch.models import activations
    x, up = (torch.randn(ACT_SHAPES["decode"], generator=gen,
                         device=DEVICE).bfloat16() for _ in range(2))
    fns = {"kernel_silu": lambda: activations.silu(x),
           "composition_silu": lambda: ref.silu_plain(x),
           "F_silu": lambda: F.silu(x),
           "kernel_gated": lambda: activations.gated("silu", up, x),
           "composition_gated": lambda: ref.gated_plain("silu", up, x),
           "F_silu_mul": lambda: up * F.silu(x)}
    out = {}
    with torch.no_grad():
        for name, fn in fns.items():
            for _ in range(20):
                fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(ACT_HOST_CALLS):
                fn()
            torch.cuda.synchronize()
            out[name] = 1e6 * (time.perf_counter() - t0) / ACT_HOST_CALLS
    return out


def phase_activations():
    import torch
    from repro_torch.kernels.activations import kernel as act_k
    from repro_torch.kernels.activations import ops, ref
    from repro_torch.models import activations
    t0 = time.perf_counter()
    _act_reset()
    # kernel against composition on the card: every bf16 bit pattern
    bits = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(
        torch.int16)
    xall = bits.view(torch.bfloat16).to(DEVICE)
    cg = torch.Generator(device=DEVICE).manual_seed(5)
    cards = {}
    for dtype, x in (("bfloat16", xall), ("float32", None)):
        if x is None:
            n = ACT_F32_N - 8
            x = torch.cat([
                torch.randn(n // 2, generator=cg, device=DEVICE) * 4,
                torch.rand(n // 4, generator=cg, device=DEVICE) * 200 - 100,
                torch.randn(n - n // 2 - n // 4, generator=cg,
                            device=DEVICE) * 1e-3,
                torch.tensor([0.0, -0.0, math.inf, -math.inf, math.nan,
                              1e-40, -1e-40, 88.7], device=DEVICE)])
        up = torch.randn(x.shape, generator=cg, device=DEVICE).to(x.dtype)
        g = torch.randn(x.shape, generator=cg, device=DEVICE).to(x.dtype)
        line = {"values": x.numel()}
        for name in ACT_NAMES:
            kern, plain = _act_pair(name, x, up, g)
            line[name] = {k: _act_differ(kern[k], plain[k]) for k in kern}
            bad = {k: v for k, v in line[name].items() if v}
            if bad:
                raise AssertionError(f"activations {dtype} {name}: the "
                                     f"kernel differs from the composition "
                                     f"on the card: {bad}")
        cards[dtype] = line
    # strided inputs: the sLSTM's g[:, k] rows and the RG-LRU's chunks in
    # place, a transposed view through a copy
    z = torch.randn((4, 4, 8, 64), generator=cg, device=DEVICE).bfloat16()
    c2 = torch.randn((4, 33, 512), generator=cg, device=DEVICE).bfloat16()
    lo, hi = c2.chunk(2, dim=-1)
    views = {"rows": (ops.act("log_sigmoid", z[:, 2]),
                      ref.PLAIN["log_sigmoid"](z[:, 2])),
             "chunks": (ops.gated("gelu", lo, hi),
                        ref.gated_plain("gelu", lo, hi)),
             "transposed": (ops.act("tanh", z[0].transpose(0, 1)),
                            ref.PLAIN["tanh"](z[0].transpose(0, 1)))}
    strided = {k: _act_differ(a, b.contiguous()) for k, (a, b) in
               views.items()}
    if any(strided.values()) or act_k.rows_view(z[:, 2]) != (4, 512, 2048):
        raise AssertionError(f"activations strided: {strided}, rows_view "
                             f"{act_k.rows_view(z[:, 2])}")
    # the card against the CPU's composition, every finite bf16 value
    x = bits.view(torch.bfloat16)
    x = x[torch.isfinite(x.float())].contiguous()
    xc = x.to(DEVICE)
    cot = torch.randn(x.shape, generator=torch.Generator().manual_seed(3)
                      ).bfloat16()
    line = {"values": x.numel()}

    def grad(fn, a, g):
        a = a.clone().requires_grad_(True)
        fn(a).backward(g)
        return a.grad

    for name in ACT_NAMES:
        fn = getattr(activations, name)
        for what, cpu, card in (
                (name, fn(x), fn(xc).cpu()),
                (f"{name}_grad", grad(fn, x, cot),
                 grad(fn, xc, cot.to(DEVICE)).cpu())):
            differ = (cpu.view(torch.int16) != card.view(torch.int16)) & ~(
                cpu.isnan() & card.isnan())
            n = int(differ.sum())
            line[what] = {"differ": n, "x": x[differ].float().tolist()[:16],
                          "card": card[differ].float().tolist()[:16],
                          "cpu": cpu[differ].float().tolist()[:16]}
            if n > ACT_DIFFER_MAX:
                raise AssertionError(f"activations {what}: the card differs"
                                     f" from the CPU on {n} bf16 values")
    checks = _act_counts()
    gen = torch.Generator(device=DEVICE).manual_seed(7)
    times = {where: _act_times(shape, gen)
             for where, shape in ACT_SHAPES.items()}
    host = _act_host_us(gen)
    for form in act_k.launches:
        t = times["prefill"][form]
        ACT_ROWS[form] = {
            "name": form, "route": "cuda",
            "source": "src/repro_torch/csrc/activations.cu",
            "replaces": ACT_REPLACES, "replaces_note": ACT_REPLACES_NOTE,
            "launches": None,
            **{k: t[k] for k in ("max_abs_err", "ms", "plain_ms",
                                 "bound_ms", "bound_by", "library_ms")}}
    _act_reset()
    emit({"phase": "activations", "kernel_vs_composition": cards,
          "strided_differ": strided, "card_vs_cpu": line,
          "check_launches": checks, "times": times, "host_us": host,
          "seconds": time.perf_counter() - t0})


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


def profile_totals(prof) -> tuple[float, int]:
    """(device busy ms, CPU-side operator calls) of a finished
    ``torch.profiler`` run, read from its raw events: the sum of the
    device events' durations and the count of CPU events, which is what
    ``key_averages()`` sums, without building its tables (~60 us an event:
    minutes for a prefill of ~900,000 calls)."""
    import torch
    busy_ns, calls = 0, 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == torch.autograd.DeviceType.CPU:
            calls += 1
        else:
            busy_ns += e.duration_ns()
    return busy_ns / 1e6, calls


def device_profile(fn, reps: int) -> dict:
    """``reps`` calls of ``fn`` on the host clock (ending in a
    synchronisation), then ``reps`` more under ``torch.profiler``: device
    busy time (the sum of the kernels' device times), the device's idle
    share against the unprofiled wall time, and CPU operator calls, each
    per call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
    busy_ms, calls = profile_totals(prof)
    busy_ms /= reps
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1.0 - busy_ms / wall_ms,
            "cpu_op_calls": calls / reps}


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
    _act_reset()
    out = serve.main(argv)
    decode_counts = {n: get() for n, (get, _) in counters.items()}
    decode_act = _act_counts()
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
    act_want = {n: (cfg.num_layers if n == "act_gated" else 0)
                for n in _act_counts()}
    for i in range(3):
        for _, reset in counters.values():
            reset()
        _act_reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = {n: get() for n, (get, _) in counters.items()}
        want = {n: (cfg.num_layers if n == "flash_attn" else 0)
                for n in counts}
        prefill_act = _act_counts()
        if counts != want or prefill_act != act_want:
            raise AssertionError(
                f"serve prefill: kernel launches {counts}, activation "
                f"launches {prefill_act}, want {want}, {act_want} (one "
                f"flash launch and one gated activation a layer)")
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
    _act_reset()
    decode_one()
    torch.cuda.synchronize()
    step_act = _act_counts()
    if step_act != act_want:
        raise AssertionError(f"serve decode step: activation launches "
                             f"{step_act}, want {act_want}")
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
          "decode_path_act_launches": decode_act,
          "prefill_act_launches_per_call": prefill_act,
          "decode_step_act_launches": step_act,
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


def _arch_at_depth(arch: str, layers: int) -> str:
    """``arch`` cut to ``layers`` layers, registered as
    ``<arch>-<layers>l`` (the launchers resolve ``--arch`` through the
    registry); returns that name."""
    from repro_torch.configs import ARCHS, get_config
    name = f"{arch}-{layers}l"
    ARCHS[name] = get_config(arch).replace(name=name, num_layers=layers)
    return name


def _decode_logits(params, cfg, prompts, max_len):
    """The decode path over ``prompts`` (fp32 caches): its logits at every
    prompt position (B, P, V), and the caches."""
    import torch
    from repro_torch.models import transformer
    caches = transformer.init_caches(cfg, prompts.shape[0], max_len,
                                     torch.float32, device=prompts.device)
    out = []
    with torch.no_grad():
        for t in range(prompts.shape[1]):
            dec, caches = transformer.decode_step(
                params, prompts[:, t:t + 1], caches, t, cfg, max_len=max_len)
            out.append(dec)
    return torch.cat(out, dim=1), caches


def _position_gaps(pre, dec, hold: int, tol: float, what: str) -> list:
    """max |pre - dec| at each position of (B, P, V) logits; the first
    ``hold`` positions must be within ``tol``."""
    gaps = (pre - dec).abs().amax(dim=(0, 2)).tolist()
    if max(gaps[:hold]) > tol:
        raise AssertionError(f"{what}: max |prefill - decode logit| by "
                             f"position {gaps[:hold]} (tol {tol} over the "
                             f"first {hold})")
    return gaps


def _serve_cli_keeping_weights(argv, counters, phase: str):
    """The serve CLI on ``argv`` with every kernel counter zeroed before
    it: none may launch (decode runs no kernel).  Its weights (seed 0, on
    the card) are kept for the phase's prefill and comparisons: a second
    draw of the same seed would repeat minutes of host work.  Returns
    ``(prompts, generated tokens, cli, params, decode launches, decode
    peak memory)``, ``cli`` holding the CLI's tok/s and seconds, the
    whole call's and the weights' draw."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.models import transformer

    torch.cuda.reset_peak_memory_stats()
    for _, reset in counters.values():
        reset()
    drawn = {}
    init_params = transformer.init_params

    def keep(cfg_, *, seed=0, device="cpu"):
        t0_ = time.perf_counter()
        drawn["params"] = init_params(cfg_, seed=seed, device=device)
        torch.cuda.synchronize()
        drawn["s"] = time.perf_counter() - t0_
        return drawn["params"]
    transformer.init_params = keep
    try:
        t0 = time.perf_counter()
        out = serve.main(argv)
        cli_s = time.perf_counter() - t0
    finally:
        transformer.init_params = init_params
    counts = {n: get() for n, (get, _) in counters.items()}
    if any(counts.values()):
        raise AssertionError(f"{phase}: the decode path launched {counts}")
    cli = {k: out[k] for k in ("tok_per_s", "prefill_s", "decode_s")}
    cli.update(cli_s=cli_s, init_s=drawn["s"])
    return (out["prompts"], out["tokens"], cli, drawn["params"], counts,
            torch.cuda.max_memory_allocated())


def phase_serve_recurrent(arch: str, want_n: int, prefill_bs: tuple,
                          phase: str):
    """The serving path of a recurrent architecture at full width (``want_n``
    parameters at full depth) and the depth of SERVE_RECURRENT, as
    ``phase_serve`` drives smollm-360m: (a) the serve CLI
    (SERVE_ARGV's batch, prompt and generation), no kernel launched; (b) a
    prefill of ``prefill_bs`` tokens, the first 64 of each row being (a)'s
    prompt, the flash kernel once an attention layer and nothing else;
    (c) the prefill logits against the decode path's at each prompt
    position, in bf16 (RECURRENT_LOGIT_TOL) and, over the prompt alone, in
    fp32 compute (RECURRENT_FP32_LOGIT_TOL), the first SERVE_HOLD
    positions held; (a)'s first token against the decode path's argmax; a
    decode step and a prefill call profiled.  Returns the flash launches
    of one prefill call."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.serve_step import (build_prefill_step,
                                             build_serve_step)
    from repro_torch.models import transformer

    if transformer.count_params_analytic(get_config(arch)) != want_n:
        raise AssertionError(f"{phase}: {arch} does not have {want_n} "
                             f"parameters")
    layers, want_n = SERVE_RECURRENT[arch]
    name = _arch_at_depth(arch, layers)
    cfg = get_config(name)
    n = transformer.count_params_analytic(cfg)
    if n != want_n:
        raise AssertionError(f"{phase}: {name} has {n} parameters, want "
                             f"{want_n}")
    counters = _counters()
    argv = SERVE_ARGV[2:] + ["--arch", name, "--device", DEVICE]
    (prompts, gen_tokens, cli, params, decode_counts,
     decode_peak) = _serve_cli_keeping_weights(argv, counters, phase)
    P = prompts.shape[1]
    max_len = P + gen_tokens.shape[1] + 1
    B, S = prefill_bs
    g = torch.Generator().manual_seed(9)
    rest = torch.randint(0, cfg.vocab_size, (B, S - P), generator=g)
    tokens = torch.cat([prompts[:B], rest.to(DEVICE)], dim=1)
    prefill = build_prefill_step(cfg)
    n_attn = cfg.layer_kinds().count("attn")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(2):
        for _, reset in counters.values():
            reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = {n_: get() for n_, (get, _) in counters.items()}
        want = {n_: (n_attn if n_ == "flash_attn" else 0) for n_ in counts}
        if counts != want:
            raise AssertionError(f"{phase} prefill: kernel launches "
                                 f"{counts}, want {want} (one flash launch "
                                 f"an attention layer)")
        if i == 0:
            del logits
    if logits.shape != (B, S, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{phase} prefill: logits "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    prefill_peak = torch.cuda.max_memory_allocated()
    pre_all = logits[:, :P].clone()
    del logits
    torch.cuda.empty_cache()

    hold, hold32 = SERVE_HOLD[arch]
    dec_all, caches = _decode_logits(params, cfg, prompts[:B], max_len)
    gaps = _position_gaps(pre_all, dec_all, hold, RECURRENT_LOGIT_TOL,
                          f"{phase} bf16")
    pre, dec = pre_all[:, P - 1], dec_all[:, P - 1]
    del pre_all, dec_all
    top2 = pre.topk(2, dim=-1).values
    margin = top2[:, 0] - top2[:, 1]
    first = gen_tokens[:B, 0].long()
    agree = (first == pre.argmax(-1)) | (margin <= RECURRENT_LOGIT_TOL)
    if not torch.equal(first, dec.argmax(-1)) or (
            hold >= P and not bool(agree.all())):
        raise AssertionError(
            f"{phase}: first tokens {first.tolist()}, prefill argmax "
            f"{pre.argmax(-1).tolist()}, decode argmax "
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
    del caches
    torch.cuda.empty_cache()

    # the same comparison in fp32 compute over the prompt alone
    cfg32 = cfg.replace(compute_dtype="float32")
    pre32 = build_prefill_step(cfg32)(params, {"tokens": prompts[:B]})
    dec32, _ = _decode_logits(params, cfg32, prompts[:B], max_len)
    gaps32 = _position_gaps(pre32, dec32, hold32, RECURRENT_FP32_LOGIT_TOL,
                            f"{phase} fp32")
    del params, pre32, dec32
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": phase, "arch": arch, "layers": cfg.num_layers,
          "params": n, "argv": argv, "serve_cli_s": cli["cli_s"],
          "init_params_s": cli["init_s"],
          "decode_tok_per_s": cli["tok_per_s"],
          "serve_prefill_s": cli["prefill_s"],
          "serve_decode_s": cli["decode_s"],
          "decode_path_launches": decode_counts,
          "decode_max_memory_allocated_bytes": decode_peak,
          "prefill_tokens": [B, S], "prefill_s": times,
          "prefill_flash_launches_per_call": n_attn,
          "prefill_max_memory_allocated_bytes": prefill_peak,
          "positions_held": {"bfloat16": hold, "float32": hold32},
          "max_abs_logit_delta_by_position": gaps,
          "logit_tol": RECURRENT_LOGIT_TOL,
          "fp32_max_abs_logit_delta_by_position": gaps32,
          "fp32_logit_tol": RECURRENT_FP32_LOGIT_TOL,
          "top2_margins": margin.tolist(), "first_tokens": first.tolist(),
          "prefill_argmax": pre.argmax(-1).tolist(),
          "decode_step_profile": decode_prof,
          "prefill_profile": prefill_prof})
    return n_attn


def phase_train_xlstm():
    """xlstm-1.3b's training path at full width over one whole period
    (TRAIN_XLSTM_LAYERS layers, the sLSTM included): the train launcher
    under flag with MAIN_W workers, MAIN_F sign-flipping, once per
    sequence length of TRAIN_XLSTM_SEQS; the tree Gram and the combine
    must launch once a step, step 0's loss must be finite, and at the
    lengths of TRAIN_XLSTM_FINITE_SEQ and below every loss and gradient
    norm (see TRAIN_XLSTM_SEQS)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import transformer

    name = _arch_at_depth(XLSTM, TRAIN_XLSTM_LAYERS)
    n = transformer.count_params_analytic(get_config(name))
    if n != TRAIN_XLSTM_N:
        raise AssertionError(f"train_xlstm: {name} has {n} parameters, "
                             f"want {TRAIN_XLSTM_N}")
    counters = _counters()
    for seq in TRAIN_XLSTM_SEQS:
        steps = TRAIN_XLSTM_STEPS[seq]
        argv = TRAIN_XLSTM_ARGV + ["--arch", name, "--seq", str(seq),
                                   "--device", DEVICE]
        argv[argv.index("--steps") + 1] = str(steps)
        torch.cuda.reset_peak_memory_stats()
        for _, reset in counters.values():
            reset()
        _act_reset()
        hist = train.main(argv)
        counts = {n_: get() for n_, (get, _) in counters.items()}
        act = _act_counts()
        if not all(act.values()):
            raise AssertionError(f"train_xlstm seq {seq}: activation "
                                 f"launches {act}: every form must launch")
        if seq == TRAIN_XLSTM_SEQS[0]:
            for form in ("act", "act_grad"):
                ACT_ROWS[form]["launches"] = act[form]
                ACT_ROWS[form]["launches_run"] = f"train_xlstm seq {seq}"
        peak = torch.cuda.max_memory_allocated()
        losses = [h["loss"] for h in hist]
        norms = [h["grad_global_norm"] for h in hist]
        finite = all(math.isfinite(x) for x in losses + norms) and all(
            math.isfinite(c) for h in hist for c in h["fa_weights"])
        if len(hist) != steps or not math.isfinite(losses[0]) or (
                seq <= TRAIN_XLSTM_FINITE_SEQ and not finite):
            raise AssertionError(f"train_xlstm seq {seq}: losses {losses}, "
                                 f"|g| {norms}")
        if any(len(h["fa_weights"]) != MAIN_W for h in hist):
            raise AssertionError(f"train_xlstm seq {seq}: fa_weights")
        want = {n_: (steps if n_ in ("tree_gram", "weighted_sum")
                     else 0) for n_ in counts}
        if counts != want:
            raise AssertionError(f"train_xlstm: kernel launches {counts}, "
                                 f"want {want} (the tree Gram and the "
                                 f"combine once a step)")
        steady = [h["step_s"] for h in hist[1:]]
        emit({"phase": "train_xlstm", "arch": name, "params": n,
              "argv": argv, "seq": seq, "losses": losses,
              "grad_global_norm": norms, "all_finite": finite,
              "fa_weights_last": hist[-1]["fa_weights"],
              "step_s": [h["step_s"] for h in hist],
              "step_s_after_warmup": (sum(steady) / len(steady)
                                      if steady else None),
              "max_memory_allocated_bytes": peak, "launches": counts,
              "act_launches": act})
        del hist
        gc.collect()
        torch.cuda.empty_cache()


def check_serve_reduced(cfg, tol: float, what: str) -> dict:
    """The serving path of a reduced config, card against CPU from the
    same seeded weights and prompts (3 x RECURRENT_CHECK_PROMPT tokens):
    prefill logits, the decode path's logits at every prompt position and
    ``decode_loop``'s greedy chain of RECURRENT_CHECK_GEN tokens; the
    card's prefill also against its own decode path; logits to ``tol``,
    chains equal.  An MoE config's routing (``Routing``: every call's
    top-k experts and kept slots) must be equal on both devices."""
    import torch
    from repro_torch.dist.serve_step import build_prefill_step, decode_loop
    from repro_torch.models import transformer

    g = torch.Generator().manual_seed(10)
    prompts = torch.randint(0, cfg.vocab_size, (3, RECURRENT_CHECK_PROMPT),
                            generator=g)
    res, rts = {}, {}
    for dev in (DEVICE, "cpu"):
        params = transformer.init_params(cfg, seed=0, device=dev)
        toks = prompts.to(dev)
        with Routing() as rts[dev]:
            pre = build_prefill_step(cfg)(params, {"tokens": toks})
            dec, _ = _decode_logits(params, cfg, toks, RECURRENT_CHECK_MAX)
        chain = decode_loop(params, cfg, toks, num_steps=RECURRENT_CHECK_GEN,
                            max_len=RECURRENT_CHECK_MAX)
        res[dev] = (pre.cpu(), dec.cpu(), chain.cpu())
    (pg, dg, cg), (pc, dc, cc) = res[DEVICE], res["cpu"]
    errs = {"prefill": float((pg - pc).abs().max()),
            "decode": float((dg - dc).abs().max()),
            "prefill_vs_decode_card": float((pg - dg).abs().max())}
    if max(errs.values()) > tol or not torch.equal(cg, cc):
        raise AssertionError(f"{what}: logit errors {errs} (tol {tol}); "
                             f"chains equal {torch.equal(cg, cc)}")
    return {**errs, "logit_tol": tol,
            "ring": transformer.attention.cache_is_ring(
                cfg, RECURRENT_CHECK_MAX),
            "chain_equal": True,
            "routed_calls_equal": rts[DEVICE].equal(rts["cpu"], what)}


def check_recurrent() -> dict:
    """The recurrent architectures at the reduced size (fp32 compute), card
    against CPU from the same seeded weights, tokens and prompts: one flag
    train step through the launcher (loss to rel 1e-4, the FA weights to
    the FA tolerance, as ``phase_check``); prefill logits, the decode
    path's logits at every prompt position and the greedy chain of
    ``decode_loop`` over RECURRENT_CHECK_GEN tokens; the prompt runs past
    recurrentgemma-smoke's window of 64, so its decode wraps the ring
    buffer.  The card's prefill is also held to its own decode path.
    Logits to RECURRENT_SMOKE_LOGIT_TOL (``check_serve_reduced``)."""
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.launch import train

    out = {}
    for arch in (XLSTM, RGEMMA):
        argv = ["--arch", arch, "--debug", "--steps", "1", "--seq", "32",
                "--workers", "8", "--per-worker-batch", "2", "--byzantine",
                "2", "--attack", "sign_flip", "--optimizer", "sgd",
                "--aggregator", "flag", "--log-every", "100"]
        gpu = train.main(argv + ["--device", DEVICE])[0]
        cpu = train.main(argv + ["--device", "cpu"])[0]
        if not math.isclose(gpu["loss"], cpu["loss"], rel_tol=1e-4) or any(
                abs(a - b) > 5e-4 + 5e-3 * abs(b)
                for a, b in zip(gpu["fa_weights"], cpu["fa_weights"])):
            raise AssertionError(f"check {arch} train: loss {gpu['loss']} "
                                 f"vs {cpu['loss']}, fa_weights "
                                 f"{gpu['fa_weights']} vs "
                                 f"{cpu['fa_weights']}")
        cfg = reduce_for_smoke(get_config(arch))
        tol = RECURRENT_SMOKE_LOGIT_TOL[arch]
        errs = check_serve_reduced(cfg, tol, f"check {arch} serve")
        out[arch] = {"train_loss_gpu": gpu["loss"],
                     "train_loss_cpu": cpu["loss"],
                     "fa_weights_gpu": gpu["fa_weights"],
                     "fa_weights_cpu": cpu["fa_weights"], **errs}
    return out


class Routing:
    """While entered, records every MoE block call's routing: the port's
    own ``route``, ``capacity_of`` and ``dispatch_plan`` on the block's
    input (router logits, top-k experts, kept slots, capacity) and the
    block's output RMS over its input's, as device tensors.  It wraps
    ``moe.moe_apply``, which the transformer calls through its module: the
    package holds no counter for this."""

    def __enter__(self):
        import torch
        from repro_torch.models import moe
        self.calls = []
        self._moe, self._apply = moe, moe.moe_apply

        def recorded(p, x, cfg, *, capacity=None, tp=None):
            with torch.no_grad():
                xt = x.reshape(-1, x.shape[-1])
                logits, _, _, top_e = moe.route(p, xt, cfg)
                cap = moe.capacity_of(xt.shape[0], cfg, capacity)
                dest, _ = moe.dispatch_plan(top_e, cfg.moe.num_experts, cap)
            y, losses = self._apply(p, x, cfg, capacity=capacity, tp=tp)
            with torch.no_grad():
                gain = (y.float().square().mean().sqrt()
                        / x.float().square().mean().sqrt())
            self.calls.append({"logits": logits, "top_e": top_e,
                               "kept": dest < cfg.moe.num_experts * cap,
                               "cap": cap, "gain": gain})
            return y, losses
        moe.moe_apply = recorded
        return self

    def __exit__(self, *exc):
        self._moe.moe_apply = self._apply
        return False

    def equal(self, other: "Routing", what: str) -> int:
        """Raises unless ``other`` recorded the same calls with the same
        top-k experts and kept slots; returns the count of calls."""
        import torch
        if len(self.calls) != len(other.calls) or any(
                not torch.equal(a[key].cpu(), b[key].cpu())
                for a, b in zip(self.calls, other.calls)
                for key in ("top_e", "kept")):
            raise AssertionError(f"{what}: routing differs card vs CPU")
        return len(self.calls)

    def by_layer(self, n_layers: int, steps: int, key: str):
        """The decode path's records (one call a layer a step, step-major)
        as (n_layers, B, steps, ...)."""
        import torch
        return torch.stack([torch.stack([self.calls[t * n_layers + i][key]
                                         for t in range(steps)], dim=1)
                            for i in range(n_layers)])


def moe_prefill_vs_decode(pre, dec, pre_rt, dec_rt, k: int, dtype: str,
                          what: str) -> dict:
    """Prefill against decode logits (B, P, V) at every prompt position,
    with both paths' routing (``Routing``; the prefill's calls one a
    layer over all B P tokens, the decode's one a layer a step): the
    positions every layer routed alike are held to MOE_LOGIT_TOL[dtype];
    at each other position the first layer that differs must show a near
    tie (see MOE_LOGIT_TOL), and at most MOE_FLIP_SHARE[dtype] of the
    positions may differ."""
    import torch
    B, P, _ = pre.shape
    L = len(pre_rt.calls)
    pl = torch.stack([c["logits"] for c in pre_rt.calls]).view(L, B, P, -1)
    pe = torch.stack([c["top_e"] for c in pre_rt.calls]).view(L, B, P, k)
    dl, de = (dec_rt.by_layer(L, P, key) for key in ("logits", "top_e"))
    same = (pe.sort(-1).values == de.sort(-1).values).all(-1)   # (L, B, P)
    differs = ~same.all(0)                                      # (B, P)
    first = (~same).float().argmax(0)                           # (B, P)
    srt = pl.sort(-1, descending=True).values
    gap = srt[..., k - 1] - srt[..., k]                         # (L, B, P)
    reach = 2 * (pl - dl).abs().amax(-1)
    gap_f, reach_f = (t.gather(0, first[None])[0] for t in (gap, reach))
    unexplained = differs & (gap_f > reach_f)
    delta = (pre - dec).abs().amax(-1)                          # (B, P)
    held = torch.where(differs, torch.zeros_like(delta), delta)
    tol, share = MOE_LOGIT_TOL[dtype], MOE_FLIP_SHARE[dtype]
    n_diff = int(differs.sum())
    flips = [{"row": int(b), "position": int(t),
              "first_layer": int(first[b, t]),
              "gap": float(gap_f[b, t]), "reach": float(reach_f[b, t]),
              "max_abs_logit_delta": float(delta[b, t])}
             for b, t in differs.nonzero().tolist()]
    out = {"positions": B * P, "routed_differently": n_diff,
           "flips": flips[:16], "max_abs_logit_delta_held": float(
               held.max()),
           "held_max_by_position": held.amax(0).tolist(),
           "max_router_logit_delta": float((pl - dl).abs().max()),
           "logit_tol": tol, "flip_share_limit": share}
    if bool(unexplained.any()) or n_diff > share * B * P or \
            float(held.max()) > tol:
        raise AssertionError(f"{what} {dtype}: {out}")
    return out


def phase_serve_moe(arch: str) -> int:
    """An MoE architecture's serving path at full width with the depth cut
    (MOE_SERVE), bf16: (a) the serve CLI (SERVE_ARGV's batch, prompt and
    generation; no kernel launched), keeping its weights; (b) a prefill of
    the phase's (batch, tokens), the first 64 of each row being (a)'s
    prompt, the flash kernel once an attention layer a call and nothing
    else; the share of slots each MoE layer drops at the config's capacity
    factor and each MoE block's output RMS over its input's, from the
    port's routing on a first call; (c) with the config made drop-free,
    the prefill of (a)'s prompts against the decode path over them
    (``moe_prefill_vs_decode``) in bf16 and in fp32 compute, and (a)'s
    first tokens against the decode path's argmax (the CLI's own
    computation: the decode's T = 4 tokens never fill a capacity of 8);
    a decode step and the prefill profiled.  Under the JAX package's bank
    init an MoE block's output is ~1e4 times its input's RMS, so (c)
    mostly checks the routing and the MoE and unembedding path: after
    layer 0 an attention error of O(1) moves the residual by less than a
    bf16 ulp, and by ~1e-4 of it in fp32.  The attention of the later
    layers is held by ``phase_sweep_flash`` at this layer's shape and by
    ``check_moe`` card against CPU at the reduced size.  Returns the
    flash launches of one prefill call."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.serve_step import (build_prefill_step,
                                             build_serve_step)
    from repro_torch.models import transformer

    layers, want_n, (B, S) = MOE_SERVE[arch]
    phase = "serve_" + arch.split("-")[0]
    name = _arch_at_depth(arch, layers)
    cfg = get_config(name)
    n = transformer.count_params_analytic(cfg)
    if n != want_n:
        raise AssertionError(f"{phase}: {name} has {n} parameters, want "
                             f"{want_n}")
    counters = _counters()
    argv = SERVE_ARGV[2:] + ["--arch", name, "--device", DEVICE]
    (prompts, gen_tokens, cli, params, decode_counts,
     decode_peak) = _serve_cli_keeping_weights(argv, counters, phase)
    P = prompts.shape[1]
    max_len = P + gen_tokens.shape[1] + 1

    g = torch.Generator().manual_seed(9)
    rest = torch.randint(0, cfg.vocab_size, (B, S - P), generator=g)
    tokens = torch.cat([prompts[:B], rest.to(DEVICE)], dim=1)
    prefill = build_prefill_step(cfg)
    n_attn = cfg.layer_kinds().count("attn")
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(3):
        for _, reset in counters.values():
            reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if i == 0:
            with Routing() as rt:
                logits = prefill(params, {"tokens": tokens})
        else:
            logits = prefill(params, {"tokens": tokens})
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = {n_: get() for n_, (get, _) in counters.items()}
        want = {n_: (n_attn if n_ == "flash_attn" else 0) for n_ in counts}
        if counts != want:
            raise AssertionError(f"{phase} prefill: kernel launches "
                                 f"{counts}, want {want} (one flash launch "
                                 f"an attention layer)")
        if i < 2:
            del logits
    if logits.shape != (B, S, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{phase} prefill: logits "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    del logits
    prefill_peak = torch.cuda.max_memory_allocated()
    drop_share = [1.0 - float(c["kept"].float().mean()) for c in rt.calls]
    gain = [float(c["gain"]) for c in rt.calls]
    caps = [c["cap"] for c in rt.calls]
    del rt
    torch.cuda.empty_cache()

    E, k = cfg.moe.num_experts, cfg.moe.top_k
    free = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                               capacity_factor=E / k))
    checks, first = {}, gen_tokens[:, 0].long()
    for dtype in ("bfloat16", "float32"):
        c = free.replace(compute_dtype=dtype)
        with Routing() as pre_rt:
            pre = build_prefill_step(c)(params, {"tokens": prompts})
        with Routing() as dec_rt:
            dec, caches = _decode_logits(params, c, prompts, max_len)
        if not all(bool(x["kept"].all()) for x in pre_rt.calls):
            raise AssertionError(f"{phase}: the drop-free prefill dropped")
        checks[dtype] = moe_prefill_vs_decode(
            pre, dec, pre_rt, dec_rt, k, dtype, phase)
        if dtype == "bfloat16":
            last_pre, last_dec = pre[:, P - 1], dec[:, P - 1]
            top2 = last_pre.topk(2, dim=-1).values
            margin = top2[:, 0] - top2[:, 1]
            agree = (first == last_pre.argmax(-1)) | (
                margin <= MOE_LOGIT_TOL[dtype])
            if not torch.equal(first, last_dec.argmax(-1)) or \
                    not bool(agree.all()):
                raise AssertionError(
                    f"{phase}: first tokens {first.tolist()}, prefill "
                    f"argmax {last_pre.argmax(-1).tolist()}, decode argmax "
                    f"{last_dec.argmax(-1).tolist()}, margins "
                    f"{margin.tolist()}")
            bf16_caches = caches
        else:
            del caches
        del pre, dec, pre_rt, dec_rt
    # one decode step (positions P, P + 1, ... of the bf16 caches) and one
    # prefill call, profiled
    step_fn = build_serve_step(cfg, max_len=max_len)
    state = {"tok": first[:, None].to(torch.int32), "pos": P}

    def decode_one():
        state["tok"], _ = step_fn(params, bf16_caches, state["tok"],
                                  state["pos"])
        state["pos"] += 1
    decode_prof = device_profile(decode_one, 4)
    prefill_prof = device_profile(
        lambda: prefill(params, {"tokens": tokens}), 1)
    del params, bf16_caches
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": phase, "arch": name, "layers": layers, "params": n,
          "argv": argv, "serve_cli_s": cli["cli_s"],
          "init_params_s": cli["init_s"],
          "decode_tok_per_s": cli["tok_per_s"],
          "serve_prefill_s": cli["prefill_s"],
          "serve_decode_s": cli["decode_s"],
          "decode_path_launches": decode_counts,
          "decode_max_memory_allocated_bytes": decode_peak,
          "prefill_tokens": [B, S], "prefill_s": times,
          "prefill_flash_launches_per_call": n_attn,
          "prefill_max_memory_allocated_bytes": prefill_peak,
          "capacity_factor": cfg.moe.capacity_factor, "capacity": caps,
          "dropped_slot_share_by_moe_layer": drop_share,
          "moe_out_rms_over_in_rms_by_layer": gain,
          "prefill_vs_decode_drop_free": checks,
          "first_tokens": first.tolist(),
          "decode_step_profile": decode_prof,
          "prefill_profile": prefill_prof})
    return n_attn


def phase_train_moe():
    """deepseek-moe-16b's training path at full width over its dense head
    and one MoE layer (TRAIN_MOE_*) through the train launcher, twice from
    the same seed: 3 finite steps each (losses, |d|, the FA weights, the
    router losses), the tree Gram and the combine once a step and no other
    kernel, and equal SHA-256 of the final parameters in the two runs;
    then both kernels held against their plain versions at the path's
    (W, N)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import transformer

    name = _arch_at_depth(DEEPSEEK, TRAIN_MOE_LAYERS)
    n = transformer.count_params_analytic(get_config(name))
    if n != TRAIN_MOE_N:
        raise AssertionError(f"train_moe: {name} has {n} parameters, want "
                             f"{TRAIN_MOE_N}")
    counters = _counters()
    argv = TRAIN_MOE_ARGV + ["--arch", name, "--device", DEVICE]
    hashes = []
    for run in range(2):
        torch.cuda.reset_peak_memory_stats()
        for _, reset in counters.values():
            reset()
        sha = {}

        def on_step(t, state, m):
            if t == TRAIN_MOE_STEPS - 1:
                sha["params"] = _flat_sha256(state)
        hist = train.main(argv, on_step=on_step)
        counts = {n_: get() for n_, (get, _) in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        nums = [h[k] for h in hist for k in ("loss", "grad_global_norm",
                                             "moe_aux", "moe_z")]
        nums += [c for h in hist for c in h["fa_weights"]]
        if len(hist) != TRAIN_MOE_STEPS or not all(map(math.isfinite,
                                                       nums)):
            raise AssertionError(f"train_moe run {run}: {hist}")
        want = {n_: (TRAIN_MOE_STEPS if n_ in ("tree_gram", "weighted_sum")
                     else 0) for n_ in counts}
        if counts != want:
            raise AssertionError(f"train_moe: kernel launches {counts}, "
                                 f"want {want} (the tree Gram and the "
                                 f"combine once a step)")
        hashes.append(sha["params"])
        steady = [h["step_s"] for h in hist[1:]]
        emit({"phase": "train_moe", "run": run, "arch": name, "params": n,
              "argv": argv, "losses": [h["loss"] for h in hist],
              "moe_aux": [h["moe_aux"] for h in hist],
              "moe_z": [h["moe_z"] for h in hist],
              "grad_global_norm": [h["grad_global_norm"] for h in hist],
              "fa_weights_last": hist[-1]["fa_weights"],
              "step_s": [h["step_s"] for h in hist],
              "step_s_after_warmup": sum(steady) / len(steady),
              "max_memory_allocated_bytes": peak, "launches": counts,
              "params_sha256": sha["params"]})
        del hist
        gc.collect()
        torch.cuda.empty_cache()
    if hashes[0] != hashes[1]:
        raise AssertionError(f"train_moe: the two runs' parameters differ "
                             f"({hashes})")
    emit({"phase": "train_moe_kernels",
          **hold_gram_combine(int(TRAIN_MOE_ARGV[1]), TRAIN_MOE_N, 16)})


def hold_gram_combine(W: int, N: int, seed: int) -> dict:
    """The tree Gram and the combine at a training path's (W, N), fp32,
    against their plain versions on the same seeded buffer (GRAM_TOL; the
    combine within ``wsum_err``'s tolerance)."""
    import torch
    from repro_torch.kernels.gram.kernel import tree_gram_cuda
    from repro_torch.kernels.gram.ref import tree_gram_plain
    from repro_torch.kernels.weighted_sum.kernel import weighted_sum_cuda
    from repro_torch.kernels.weighted_sum.ref import weighted_sum_plain

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    X = torch.randn((W, N), generator=gen, device=DEVICE)
    c = torch.randn(W, generator=gen, device=DEVICE)
    K, K_plain = tree_gram_cuda(X), tree_gram_plain(X, 1, 1024)
    torch.cuda.synchronize()
    rel = gram_err(K, K_plain)
    d, d_plain = weighted_sum_cuda(X, c), weighted_sum_plain(X, c)
    torch.cuda.synchronize()
    excess, raw = wsum_err(d, d_plain, X, c)
    if rel > GRAM_TOL or excess > 0:
        raise AssertionError(f"tree_gram / weighted_sum at W={W} N={N}: "
                             f"Gram rel err {rel} (tol {GRAM_TOL}), "
                             f"combine err {raw} over its tolerance by "
                             f"{excess}")
    del X, d, d_plain
    torch.cuda.empty_cache()
    return {"w": W, "n": N, "tree_gram_rel_err": rel,
            "gram_rel_tol": GRAM_TOL, "weighted_sum_max_abs_err": raw}


def _moe_train_pair(argv, what: str):
    """One train step of the launcher on ``argv``, card against CPU from
    the same seeded weights (as ``check_train_comm``): the loss and the
    router losses to rel 1e-4, the FA weights, d and the parameters'
    displacement to the FA tolerance, every MoE call's routing (top-k
    experts and kept slots) equal.  Returns both records with the errors,
    and the CPU run's ``Routing``."""
    import torch
    runs, rts = {}, {}
    for dev in (DEVICE, "cpu"):
        with Routing() as rts[dev]:
            runs[dev] = _train_cli_record(argv + ["--device", dev])
    (g,), ((gd, gp),), base, _ = runs[DEVICE]
    (c,), ((cd, cp),), c_base, _ = runs["cpu"]
    if not torch.equal(base, c_base) or any(
            not math.isclose(g[k], c[k], rel_tol=1e-4)
            for k in ("loss", "moe_aux", "moe_z")) or any(
            abs(a - b) > 5e-4 + 5e-3 * abs(b)
            for a, b in zip(g["fa_weights"], c["fa_weights"])):
        raise AssertionError(f"{what}: {g} vs {c}")
    errs = {**_fa_close(gd, cd, False, what, "d"),
            **_fa_close(gp - base, cp - base, False, what, "step")}
    out = {"train_loss_gpu": g["loss"], "train_loss_cpu": c["loss"],
           "moe_aux_gpu": g["moe_aux"], "moe_aux_cpu": c["moe_aux"],
           "moe_z_gpu": g["moe_z"], "moe_z_cpu": c["moe_z"],
           "fa_weights_gpu": g["fa_weights"],
           "fa_weights_cpu": c["fa_weights"], **errs,
           "train_routed_calls_equal": rts[DEVICE].equal(rts["cpu"], what)}
    return out, rts["cpu"]


def _dropped_share(rt: "Routing", what: str) -> list:
    """Each recorded call's share of dropped slots; raises if none was
    dropped."""
    share = [1.0 - float(c["kept"].float().mean()) for c in rt.calls]
    if not share or max(share) == 0.0:
        raise AssertionError(f"{what}: no slot was dropped ({share})")
    return share


def check_moe() -> dict:
    """The MoE architectures at the reduced size (fp32 compute), card
    against CPU from the same seeded weights and tokens: one flag train
    step through the launcher (``_moe_train_pair``: the loss and the
    router losses, the FA weights, d and the parameters' displacement,
    every MoE call's routing equal); prefill logits, the decode path's at
    every position of a 70-token prompt (mixtral-smoke's window of 64: its
    ring wraps) and the greedy chain, routing equal in both paths.  The
    card's prefill is also held to its own decode path.  Logits to
    SMOKE_LOGIT_TOL (``check_serve_reduced``).  The reduced configs are
    drop-free; ``check_moe_drops`` holds the dropping path."""
    from repro_torch.configs import get_config, reduce_for_smoke

    out = {}
    for arch in (MIXTRAL, DEEPSEEK):
        argv = TRAIN_CHECK_ARGV + ["--arch", arch, "--aggregator", "flag",
                                   "--steps", "1"]
        train, _ = _moe_train_pair(argv, f"check {arch} train")
        serve = check_serve_reduced(reduce_for_smoke(get_config(arch)),
                                    SMOKE_LOGIT_TOL, f"check {arch} serve")
        out[arch] = {**train, "serve": serve,
                     "dropping": check_moe_drops(arch)}
    return out


def check_moe_drops(arch: str) -> dict:
    """The MoE block's dropping path, card against CPU: the reduced config
    at capacity factor MOE_DROP_FACTOR through one flag train step of the
    launcher (``_moe_train_pair``, the launcher's ``--debug`` config so
    replaced for the call) and a prefill of ``check_serve_reduced``'s
    prompts (logits to SMOKE_LOGIT_TOL); routing (top-k experts and kept
    slots) equal, and slots dropped in both.  The decode path is not
    held against this prefill: its 3 tokens a step never fill a
    capacity."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.serve_step import build_prefill_step
    from repro_torch.launch import train
    from repro_torch.models import transformer

    reduce = train.reduce_for_smoke

    def dropping(cfg):
        cfg = reduce(cfg)
        return cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=MOE_DROP_FACTOR))
    what = f"check {arch} dropping"
    argv = TRAIN_CHECK_ARGV + ["--arch", arch, "--aggregator", "flag",
                               "--steps", "1"]
    train.reduce_for_smoke = dropping
    try:
        out, rt = _moe_train_pair(argv, what + " train")
    finally:
        train.reduce_for_smoke = reduce
    out["train_dropped_slot_share"] = _dropped_share(rt, what + " train")

    cfg = dropping(get_config(arch))
    g = torch.Generator().manual_seed(10)
    prompts = torch.randint(0, cfg.vocab_size, (3, RECURRENT_CHECK_PROMPT),
                            generator=g)
    pre, rts = {}, {}
    for dev in (DEVICE, "cpu"):
        params = transformer.init_params(cfg, seed=0, device=dev)
        with Routing() as rts[dev]:
            pre[dev] = build_prefill_step(cfg)(
                params, {"tokens": prompts.to(dev)}).cpu()
    err = float((pre[DEVICE] - pre["cpu"]).abs().max())
    if not err <= SMOKE_LOGIT_TOL:
        raise AssertionError(f"{what} prefill: logits {err} apart (tol "
                             f"{SMOKE_LOGIT_TOL})")
    out.update(capacity_factor=MOE_DROP_FACTOR, prefill=err,
               logit_tol=SMOKE_LOGIT_TOL,
               prefill_routed_calls_equal=rts[DEVICE].equal(
                   rts["cpu"], what + " prefill"),
               prefill_dropped_slot_share=_dropped_share(
                   rts["cpu"], what + " prefill"))
    return out


def _prefix_embeds(cfg, B: int, seed: int, device=None):
    """(B, num_prefix_embeds, d_frontend) fp32 N(0, 1) from a CPU seed on
    ``device`` (DEVICE unless given): what the encoder that the model does
    not hold would hand it."""
    import torch
    g = torch.Generator().manual_seed(seed)
    return torch.randn((B, cfg.num_prefix_embeds, cfg.d_frontend),
                       generator=g).to(device or DEVICE)


def _layer_flash_shape(cfg, B: int, S: int) -> tuple:
    return (B, cfg.num_heads, cfg.num_kv_heads, S, cfg.head_dim, cfg.window)


def phase_serve_attn(arch: str) -> int:
    """An attention model's serving path at full width (SERVE_ATTN: the
    layers on the card), bf16: (a) the serve CLI (SERVE_ARGV's batch,
    prompt and generation; the token path, no kernel launched), keeping
    its weights; (b) a prefill of ATTN_PREFILL positions a row -- with a
    frontend a seeded prefix (the config's P frames) and then tokens, the
    first 64 being (a)'s prompt -- the flash kernel once a layer a call
    and nothing else, at the layer shape ATTN_FLASH holds; (c) the
    prefill of (a)'s prompts against the decode path over them at all 64
    positions, in bf16 (SERVE_LOGIT_TOL) and fp32 (RECURRENT_FP32_LOGIT_
    TOL) compute, and (a)'s first tokens against the decode path's argmax
    and the prefill's (within the tolerance of a tie); (d) with a
    frontend, ``prefix_loss_check`` in fp32.  Returns the flash launches
    of one prefill call."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.dist.serve_step import build_prefill_step
    from repro_torch.models import transformer

    layers, want_n = SERVE_ATTN[arch]
    phase = "serve_" + (ATTN_SHORT[arch] if arch in (MUSICGEN, PHI3V)
                        else "dense")
    name = arch if layers == get_config(arch).num_layers else \
        _arch_at_depth(arch, layers)
    cfg = get_config(name)
    n = transformer.count_params_analytic(cfg)
    B, S = ATTN_PREFILL
    if n != want_n or _layer_flash_shape(cfg, B, S) != ATTN_FLASH[arch]:
        raise AssertionError(f"{phase}: {name} has {n} parameters (want "
                             f"{want_n}), layer {_layer_flash_shape(cfg, B, S)}"
                             f" (want {ATTN_FLASH[arch]})")
    counters = _counters()
    argv = SERVE_ARGV[2:] + ["--arch", name, "--device", DEVICE]
    (prompts, gen_tokens, cli, params, decode_counts,
     decode_peak) = _serve_cli_keeping_weights(argv, counters, phase)
    P = prompts.shape[1]
    max_len = P + gen_tokens.shape[1] + 1
    npre = cfg.num_prefix_embeds if cfg.frontend is not None else 0
    g = torch.Generator().manual_seed(9)
    rest = torch.randint(0, cfg.vocab_size, (B, S - npre - P), generator=g)
    batch = {"tokens": torch.cat([prompts[:B], rest.to(DEVICE)], dim=1)}
    if npre:
        batch["prefix_embeds"] = _prefix_embeds(cfg, B, 11)
    prefill = build_prefill_step(cfg)
    torch.cuda.reset_peak_memory_stats()
    times = []
    for i in range(2):
        for _, reset in counters.values():
            reset()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits = prefill(params, batch)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        counts = {n_: get() for n_, (get, _) in counters.items()}
        want = {n_: (cfg.num_layers if n_ == "flash_attn" else 0)
                for n_ in counts}
        if counts != want:
            raise AssertionError(f"{phase} prefill: kernel launches "
                                 f"{counts}, want {want} (one flash launch "
                                 f"a layer)")
        if i == 0:
            del logits
    if logits.shape != (B, S, cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{phase} prefill: logits "
                             f"{tuple(logits.shape)}, finite "
                             f"{bool(torch.isfinite(logits).all())}")
    del logits
    prefill_peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()

    checks, first = {}, gen_tokens[:, 0].long()
    for dtype, tol in (("bfloat16", SERVE_LOGIT_TOL),
                       ("float32", RECURRENT_FP32_LOGIT_TOL)):
        c = cfg.replace(compute_dtype=dtype)
        pre = build_prefill_step(c)(params, {"tokens": prompts})
        dec, caches = _decode_logits(params, c, prompts, max_len)
        del caches
        gaps = _position_gaps(pre, dec, P, tol, f"{phase} {arch} {dtype}")
        last_pre, last_dec = pre[:, P - 1], dec[:, P - 1]
        top2 = last_pre.topk(2, dim=-1).values
        margin = top2[:, 0] - top2[:, 1]
        if dtype == "bfloat16":
            agree = (first == last_pre.argmax(-1)) | (margin <= tol)
            if not torch.equal(first, last_dec.argmax(-1)) or \
                    not bool(agree.all()):
                raise AssertionError(
                    f"{phase} {arch}: first tokens {first.tolist()}, "
                    f"prefill argmax {last_pre.argmax(-1).tolist()}, decode "
                    f"argmax {last_dec.argmax(-1).tolist()}, margins "
                    f"{margin.tolist()}")
        checks[dtype] = {"max_abs_logit_delta_by_position": gaps,
                         "logit_tol": tol, "top2_margins": margin.tolist()}
        del pre, dec
    out = {"phase": phase, "arch": name, "layers": cfg.num_layers,
           "params": n, "argv": argv, "serve_cli_s": cli["cli_s"],
           "init_params_s": cli["init_s"],
           "decode_tok_per_s": cli["tok_per_s"],
           "serve_prefill_s": cli["prefill_s"],
           "serve_decode_s": cli["decode_s"],
           "decode_path_launches": decode_counts,
           "decode_max_memory_allocated_bytes": decode_peak,
           "prefill_positions": [B, S], "prefill_prefix_embeds": npre,
           "prefill_s": times,
           "prefill_flash_launches_per_call": cfg.num_layers,
           "prefill_layer_flash_shape": list(ATTN_FLASH[arch][:5]),
           "prefill_max_memory_allocated_bytes": prefill_peak,
           "prefill_vs_decode": checks, "first_tokens": first.tolist()}
    if npre:
        out["prefix_fp32"] = prefix_loss_check(params, cfg, phase)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    emit(out)
    return cfg.num_layers


def prefix_loss_check(params, cfg, phase: str) -> dict:
    """The prefix path in fp32 compute on PREFIX_CHECK positions (the
    config's P prefix frames and then tokens): the training forward's
    loss (plain attention, no autograd, no kernel launched) against the
    loss from the prefill's logits (the flash kernel's fp32 body, once a
    layer) with the labels left-padded over
    the prefix and the prefix masked out (PREFIX_LOSS_TOL); and a second
    prefix must move every token position's logits by more than
    RECURRENT_FP32_LOGIT_TOL (the splice is live; attention is causal, so
    every token sees the prefix)."""
    import torch
    from repro_torch.dist.serve_step import build_prefill_step
    from repro_torch.models import transformer

    B, S = PREFIX_CHECK
    P = cfg.num_prefix_embeds
    c = cfg.replace(compute_dtype="float32")
    g = torch.Generator().manual_seed(12)
    toks = torch.randint(0, cfg.vocab_size, (B, S - P + 1),
                         generator=g).to(DEVICE)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "prefix_embeds": _prefix_embeds(cfg, B, 13)}
    counters = _counters()
    for _, reset in counters.values():
        reset()
    with torch.no_grad():
        fwd, _ = transformer.forward(params, batch, c)
    if any(get() for get, _ in counters.values()):
        raise AssertionError(f"{phase} prefix fp32: the training forward "
                             f"launched a kernel")
    prefill = build_prefill_step(c)
    logits = prefill(params, {k: batch[k] for k in ("tokens",
                                                    "prefix_embeds")})
    torch.cuda.synchronize()
    flash = counters["flash_attn"][0]()
    if flash != cfg.num_layers:
        raise AssertionError(f"{phase} prefix fp32: {flash} flash launches, "
                             f"want {cfg.num_layers}")
    labels = torch.cat([torch.zeros((B, P), dtype=torch.long,
                                    device=DEVICE), batch["labels"].long()],
                       dim=1)
    mask = torch.cat([torch.zeros((B, P), dtype=torch.bool, device=DEVICE),
                      torch.ones((B, S - P), dtype=torch.bool,
                                 device=DEVICE)], dim=1)
    nll = -torch.gather(torch.log_softmax(logits, -1), -1,
                        labels[..., None])[..., 0]
    pre_loss = float((nll * mask).sum() / mask.sum())
    err = abs(float(fwd) - pre_loss)
    other = prefill(params, {"tokens": batch["tokens"],
                             "prefix_embeds": _prefix_embeds(cfg, B, 14)})
    moved = (other[:, P:] - logits[:, P:]).abs().amax(dim=-1)
    least = float(moved.min())
    if logits.shape != (B, S, cfg.vocab_size) or not err <= PREFIX_LOSS_TOL \
            or not least > RECURRENT_FP32_LOGIT_TOL:
        raise AssertionError(f"{phase} prefix fp32: forward loss "
                             f"{float(fwd)}, from the prefill's logits "
                             f"{pre_loss} (|diff| {err}, tol "
                             f"{PREFIX_LOSS_TOL}); another prefix moves a "
                             f"token's logits by at least {least}")
    del logits, other, nll
    torch.cuda.empty_cache()
    return {"positions": [B, S], "prefix": P, "forward_loss": float(fwd),
            "prefill_flash_launches": flash,
            "prefill_logits_loss": pre_loss, "abs_diff": err,
            "tol": PREFIX_LOSS_TOL,
            "other_prefix_least_token_logit_move": least,
            "other_prefix_mean_token_logit_move": float(moved.mean())}


def frontend_worker_batch(cfg, task, wdc, step: int, seq: int, device):
    """The worker-major batch of a frontend config: ``lm_worker_batches``'
    tokens (seq a row) and a seeded (W, B, P, d_frontend) prefix, drawn on
    the CPU from ``step`` (as tests/test_dist.py builds one)."""
    import torch
    from repro_torch.data import lm_worker_batches
    batch = lm_worker_batches(task, wdc, step, seq, device=device)
    g = torch.Generator().manual_seed(1_000 + step)
    batch["prefix_embeds"] = torch.randn(
        (wdc.workers, wdc.per_worker_batch, cfg.num_prefix_embeds,
         cfg.d_frontend), generator=g).to(device)
    return batch


def phase_train_musicgen():
    """musicgen-medium's training path with its prefix at full width over
    TRAIN_MUSICGEN_LAYERS layers: the train launcher's ``setup`` (flags
    TRAIN_MUSICGEN_ARGV; weights from seed 0) and its step over
    ``frontend_worker_batch``, twice from the same seed: finite losses,
    |d| and FA weights, the tree Gram and the combine once a step and no
    other kernel, the projector's rows of d non-zero (AdamW's first mu is
    0.1 d), and the final parameters' SHA-256 equal in the two runs."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import transformer

    name = _arch_at_depth(MUSICGEN, TRAIN_MUSICGEN_LAYERS)
    n = transformer.count_params_analytic(get_config(name))
    if n != TRAIN_MUSICGEN_N:
        raise AssertionError(f"train_musicgen: {name} has {n} parameters, "
                             f"want {TRAIN_MUSICGEN_N}")
    counters = _counters()
    argv = TRAIN_MUSICGEN_ARGV + ["--arch", name, "--device", DEVICE]
    args = train._parser().parse_args(argv)
    hashes = []
    for run_i in range(2):
        torch.cuda.reset_peak_memory_stats()
        for _, reset in counters.values():
            reset()
        t0 = time.perf_counter()
        run = train.setup(args)
        setup_s = time.perf_counter() - t0
        state, hist = run.state, []
        for t in range(run.step0, run.total):
            batch = frontend_worker_batch(run.cfg, run.task, run.wdc, t,
                                          args.seq, run.device)
            torch.cuda.synchronize()
            ts = time.perf_counter()
            m = run.step_fn(state, batch, t)
            torch.cuda.synchronize()
            rec = {"loss": float(m["loss"]),
                   "grad_global_norm": float(m["grad_global_norm"]),
                   "fa_weights": m["fa_weights"].tolist(),
                   "step_s": time.perf_counter() - ts}
            if t == 0:
                lay = state.layout
                rec["frontend_d_max_abs"] = [
                    10 * float(state.opt_state["mu"][o:o + k].abs().max())
                    for p, o, k in zip(lay.paths, lay.offsets, lay.sizes)
                    if p[0] == "frontend"]
            hist.append(rec)
        counts = {n_: get() for n_, (get, _) in counters.items()}
        peak = torch.cuda.max_memory_allocated()
        nums = [h[k] for h in hist for k in ("loss", "grad_global_norm")]
        nums += [c for h in hist for c in h["fa_weights"]]
        fe = hist[0]["frontend_d_max_abs"]
        if len(hist) != TRAIN_MUSICGEN_STEPS or not all(
                map(math.isfinite, nums)) or len(fe) != 2 or min(fe) <= 0:
            raise AssertionError(f"train_musicgen run {run_i}: {hist}")
        want = {n_: (TRAIN_MUSICGEN_STEPS if n_ in ("tree_gram",
                                                    "weighted_sum")
                     else 0) for n_ in counts}
        if counts != want:
            raise AssertionError(f"train_musicgen: kernel launches {counts}"
                                 f", want {want} (the tree Gram and the "
                                 f"combine once a step)")
        hashes.append(_flat_sha256(state))
        steady = [h["step_s"] for h in hist[1:]]
        emit({"phase": "train_musicgen", "run": run_i, "arch": name,
              "params": n, "argv": argv, "setup_s": setup_s,
              "prefix": [run.cfg.num_prefix_embeds, run.cfg.d_frontend],
              "losses": [h["loss"] for h in hist],
              "grad_global_norm": [h["grad_global_norm"] for h in hist],
              "fa_weights_last": hist[-1]["fa_weights"],
              "frontend_d_max_abs_step0": fe,
              "step_s": [h["step_s"] for h in hist],
              "step_s_after_warmup": sum(steady) / len(steady),
              "max_memory_allocated_bytes": peak, "launches": counts,
              "params_sha256": hashes[-1]})
        del run, state, batch, m
        gc.collect()
        torch.cuda.empty_cache()
    if hashes[0] != hashes[1]:
        raise AssertionError(f"train_musicgen: the two runs' parameters "
                             f"differ ({hashes})")


def _frontend_train_step(cfg, dev: str):
    """One flag train step of a frontend config with a prefix on ``dev``
    (FRONTEND_CHECK_*; SGD with momentum, so d is the first mu): the
    metrics, d, the parameters after it and before it, on the CPU."""
    from repro_torch.core.flag import FlagConfig
    from repro_torch.data import SyntheticLM, WorkerDataConfig
    from repro_torch.dist.aggregation import AggregatorConfig
    from repro_torch.dist.train_step import (TrainConfig, build_train_step,
                                             init_train_state)
    from repro_torch.optim import sgd, warmup_cosine

    W, F = FRONTEND_CHECK_W, FRONTEND_CHECK_F
    Bw, seq = FRONTEND_CHECK_BS
    tc = TrainConfig(aggregator=AggregatorConfig(
        name="flag", f=F, flag=FlagConfig(lam=float(W),
                                          regularizer="pairwise")),
        attack="sign_flip", attack_f=F)
    opt = sgd(momentum=0.9)
    state = init_train_state(cfg, opt, seed=0, device=dev)
    base = state.flat.cpu().clone()
    step = build_train_step(cfg, tc, opt, warmup_cosine(3e-3, 1, warmup=0))
    batch = frontend_worker_batch(cfg, SyntheticLM(vocab_size=cfg.vocab_size),
                                  WorkerDataConfig(workers=W,
                                                   per_worker_batch=Bw),
                                  0, seq, dev)
    m = step(state, batch, 0)
    rec = {"loss": float(m["loss"]), "fa_weights": m["fa_weights"].tolist()}
    return rec, state.opt_state["mu"].cpu(), state.flat.cpu(), base


def check_frontends() -> dict:
    """The frontend architectures at the reduced size (fp32 compute), card
    against CPU from the same seeded weights, tokens and prefixes: one
    flag train step with ``prefix_embeds`` (the loss to rel 1e-4, the FA
    weights to the FA tolerance, d and the parameters' displacement by
    ``_fa_close``); prefill logits with a prefix (SMOKE_LOGIT_TOL); and
    the token path through ``check_serve_reduced`` (prefill, decode at
    every position of a 70-token prompt, the greedy chain).  Then the
    dense trio's reduced configs through ``check_serve_reduced``."""
    import torch
    from repro_torch.configs import get_config, reduce_for_smoke
    from repro_torch.dist.serve_step import build_prefill_step
    from repro_torch.models import transformer

    out = {}
    for arch in (MUSICGEN, PHI3V):
        cfg = reduce_for_smoke(get_config(arch))
        what = f"check {arch}"
        (g, gd, gp, base), (c, cd, cp, c_base) = (
            _frontend_train_step(cfg, dev) for dev in (DEVICE, "cpu"))
        if not torch.equal(base, c_base) or not math.isclose(
                g["loss"], c["loss"], rel_tol=1e-4) or any(
                abs(a - b) > 5e-4 + 5e-3 * abs(b)
                for a, b in zip(g["fa_weights"], c["fa_weights"])):
            raise AssertionError(f"{what} train: {g} vs {c}")
        errs = {**_fa_close(gd, cd, False, what + " train", "d"),
                **_fa_close(gp - base, cp - base, False, what + " train",
                            "step")}
        g_ = torch.Generator().manual_seed(10)
        toks = torch.randint(0, cfg.vocab_size, (3, RECURRENT_CHECK_PROMPT),
                             generator=g_)
        pre = {}
        for dev in (DEVICE, "cpu"):
            params = transformer.init_params(cfg, seed=0, device=dev)
            pre[dev] = build_prefill_step(cfg)(params, {
                "tokens": toks.to(dev),
                "prefix_embeds": _prefix_embeds(cfg, 3, 15, dev)}).cpu()
        err = float((pre[DEVICE] - pre["cpu"]).abs().max())
        if not err <= SMOKE_LOGIT_TOL:
            raise AssertionError(f"{what} prefill with a prefix: logits "
                                 f"{err} apart (tol {SMOKE_LOGIT_TOL})")
        out[arch] = {"train_loss_gpu": g["loss"], "train_loss_cpu": c["loss"],
                     "fa_weights_gpu": g["fa_weights"],
                     "fa_weights_cpu": c["fa_weights"], **errs,
                     "prefill_with_prefix": err,
                     "serve": check_serve_reduced(cfg, SMOKE_LOGIT_TOL,
                                                  what + " serve")}
    for arch in (STABLELM, STARCODER2, COMMAND_R):
        out[arch] = {"serve": check_serve_reduced(
            reduce_for_smoke(get_config(arch)), SMOKE_LOGIT_TOL,
            f"check {arch} serve")}
    return out


def phase_timing_frontends(smi: str, launches: dict) -> dict:
    """flash_attn at phi-3-vision-4.2b's layer (head dim 96, its first
    real-size run) and at starcoder2-15b's (GQA 48 / 4 of 128) against
    the causal bound, the plain version and the library's causal fused
    attention."""
    out = {"flash_phi3v_layer": timing_flash_window(ATTN_FLASH[PHI3V],
                                                    launches[PHI3V], 17),
           "flash_starcoder2_layer": timing_flash_window(
               ATTN_FLASH[STARCODER2], launches[STARCODER2], 18)}
    emit({"phase": "timing_frontends", "card": smi, **out})
    return out


def phase_timing_moe(smi: str, flash_launches: int) -> dict:
    """flash_attn at mixtral-8x7b's attention layer (MIXTRAL_FLASH)
    against its band's bound, its plain version and the library's fused
    attention with the band as a boolean mask."""
    flash = timing_flash_window(MIXTRAL_FLASH, flash_launches, 15)
    emit({"phase": "timing_moe", "card": smi, "flash_mixtral_layer": flash})
    return flash


def timing_flash_window(shape: tuple, launches: int, seed: int) -> dict:
    """flash_attn at a model layer (``shape`` = (B, H, KV, S, d, window),
    bf16, causal: RG_FLASH, MIXTRAL_FLASH, ATTN_FLASH's) against the
    plain version (one block of queries at a time), its band's bound and
    the library's fused attention -- causal, with a window's band as a
    boolean mask -- and which of its fused backends take that call."""
    import torch
    import torch.nn.functional as F
    from torch.nn.attention import SDPBackend, sdpa_kernel

    from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda
    from repro_torch.kernels.flash_attn.ref import attention_mask

    B, H, KV, S, d, win = shape
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    q = torch.randn((B, H, S, d), generator=gen, device=DEVICE).bfloat16()
    k, v = (torch.randn((B, KV, S, d), generator=gen,
                        device=DEVICE).bfloat16() for _ in range(2))
    o = flash_attn_cuda(q, k, v, causal=True, window=win)
    want = flash_plain_by_rows(q.float(), k.float(), v.float(), win)
    torch.cuda.synchronize()
    ratio, raw = flash_ratio(o, want, "bfloat16")
    if ratio > 1:
        raise AssertionError(f"timing: flash_attn at {shape} max err "
                             f"{raw}, {ratio} of the limit")
    del o
    # kept (query, key) pairs of the band: min(i + 1, win) for query i
    w = S if win is None else win
    pairs = w * (w + 1) // 2 + (S - w) * w
    flops = 4 * B * H * d * pairs
    nbytes = 2 * (2 * B * H * S * d + 2 * B * KV * S * d)
    t, by = bound(nbytes, flops, BF16_FLOP_PER_S)
    band = None if win is None else attention_mask(
        S, S, causal=True, window=win, device=DEVICE)

    def library():
        if band is None:
            return F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                  enable_gqa=True)
        return F.scaled_dot_product_attention(q, k, v, attn_mask=band,
                                              enable_gqa=True)
    backends = {}                 # each backend that takes the call: ms

    def under(be):
        def call():
            with sdpa_kernel([be]):
                return library()
        return call
    # the math backend builds the (B, H, S, S) scores (8.6 GB in bf16 at
    # mixtral's layer): timed at recurrentgemma's layer only
    names = ("FLASH_ATTENTION", "EFFICIENT_ATTENTION", "CUDNN_ATTENTION") + (
        ("MATH",) if B * H * S * S < 2 ** 30 else ())
    for be in (getattr(SDPBackend, n) for n in names
               if hasattr(SDPBackend, n)):
        try:
            under(be)()
        except RuntimeError:
            continue
        backends[be.name] = cuda_ms(under(be), 5)
    lib = library()
    lib_ratio, _ = flash_ratio(lib, want, "bfloat16")
    del lib, want
    ms = cuda_ms(lambda: flash_attn_cuda(q, k, v, causal=True, window=win),
                 20, 2)
    out = {"shape": list(shape[:5]), "window": win, "dtype": "bfloat16",
           "causal": True, "launches_per_prefill_call": launches,
           "pairs_per_head": pairs, "flops": flops, "bytes": nbytes,
           "max_abs_err": raw, "share_of_limit": ratio, "ms": ms,
           "plain_ms": cuda_ms(lambda: flash_plain_by_rows(q, k, v, win),
                               3),
           "plain_by_rows": 1024,
           "bound_ms": t, "bound_by": by,
           "library_ms": cuda_ms(library, 20, 2),
           "library_call": "scaled_dot_product_attention(is_causal=True, "
                           "enable_gqa=True)" if band is None else
                           "scaled_dot_product_attention(attn_mask=band, "
                           "enable_gqa=True)",
           "library_ms_by_backend": backends,
           "library_share_of_limit": lib_ratio}
    out["share_of_bound"] = t / ms
    out["vs_library"] = ms / out["library_ms"]
    del q, k, v, band
    torch.cuda.empty_cache()
    return out


def timing_recurrences() -> dict:
    """The recurrences the slice keeps in plain PyTorch, at the full-width
    shapes the prefills give them, under ``device_profile`` (host wall
    time, device busy time and idle share, operator calls): xlstm-1.3b's
    chunkwise mLSTM (4 x 2048, 4 heads of 1024, chunk 256) and sLSTM cell
    loop (4 x 2048 steps, 4 heads of 512; also one decode step), and
    recurrentgemma-9b's RG-LRU (2 x 4096 x 4096: its two fp32 products
    and the log-depth scan), with the fp32 products timed beside the same
    products in bf16."""
    import torch
    from repro_torch.models import rglru, ssm

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(14)

    def randn(*shape, scale=1.0):
        return torch.randn(shape, generator=gen, device=DEVICE) * scale

    def profiled(fn, reps):
        fn()                                    # allocator and caches warm
        return device_profile(fn, reps)

    out = {}
    with torch.no_grad():
        B, H, S, dk = 4, 4, XLSTM_PREFILL[1], 1024
        q, k, v = randn(B, H, S, dk), randn(B, H, S, dk, scale=dk ** -0.5), \
            randn(B, H, S, dk)
        li, lf = randn(B, H, S), torch.nn.functional.logsigmoid(
            randn(B, H, S) + 3.0)
        st = ssm.mlstm_state_init(B, H, dk, dk, device=DEVICE)
        out["mlstm_parallel_4x2048"] = profiled(
            lambda: ssm.mlstm_parallel(q, k, v, li, lf, st, chunk=256), 2)
        del q, k, v, li, lf, st
        dh = 2048 // H
        gx = randn(B, S, 4, H, dh)
        r = randn(4, H, dh, dh, scale=0.5)
        st = ssm.slstm_state_init(B, H, dh, device=DEVICE)
        out["slstm_cell_scan_4x2048"] = profiled(
            lambda: ssm.slstm_cell_scan(gx, r, st), 1)
        out["slstm_cell_scan_decode_step"] = profiled(
            lambda: ssm.slstm_cell_scan(gx[:, :1], r, st), 10)
        del gx
        Bg, Sg = RGEMMA_PREFILL
        d = 4096
        x = randn(Bg, Sg, d)
        p = {"lam": torch.full((d,), 1.0, device=DEVICE),
             "wr": {"w": randn(d, d, scale=d ** -0.5)},
             "wi": {"w": randn(d, d, scale=d ** -0.5)}}
        a = torch.rand((Bg, Sg, d), generator=gen, device=DEVICE)
        out["rglru_apply_2x4096"] = profiled(
            lambda: rglru.rglru_apply(p, x), 2)
        out["rglru_linear_scan_2x4096"] = profiled(
            lambda: rglru.linear_scan(a, x), 2)
        wb = p["wr"]["w"].bfloat16()
        xb = x.bfloat16()
        out["rglru_products_ms"] = {
            "fp32": 2 * cuda_ms(lambda: x @ p["wr"]["w"], 5),
            "bf16": 2 * cuda_ms(lambda: xb @ wb, 5),
            "flops": 2 * 2 * Bg * Sg * d * d}
        del x, a, xb, wb, p
    torch.cuda.empty_cache()
    return out


def phase_timing_recurrent(smi: str, flash_launches: int) -> dict:
    """The recurrent slice's timings: flash_attn at recurrentgemma-9b's
    layer and the plain recurrences' costs."""
    flash = timing_flash_window(RG_FLASH, flash_launches, 13)
    emit({"phase": "timing_recurrent", "card": smi,
          "flash_rgemma_layer": flash, "recurrences": timing_recurrences()})
    return flash


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
    fp32 = timing_flash_fp32(q, k, v, want)
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
                                     "library_ms", "max_abs_err")},
           "fp32_body": fp32}
    del q, k, v
    torch.cuda.empty_cache()
    return out


def timing_flash_fp32(q, k, v, want) -> dict:
    """The fp32 body (``flash_fwd``) at the same layer as the bf16 row, on
    the same values in fp32, and at phi-3-vision's fp32 prefix-check layer
    (PREFIX_CHECK's positions, d 96): each checked against the plain
    version, timed beside it and the library's fused attention in fp32,
    against its bound: 4 d FLOP a kept (query, key) pair at the fp32 rate
    (it runs on the CUDA cores).  No full-width bf16 path launches it;
    phi-3-vision's fp32 prefix check does, once a layer."""
    import torch
    from repro_torch.configs import get_config
    q, k, v = q.float(), k.float(), v.float()
    out = fp32_flash_layer(q, k, v, want, "timing: smollm layer")
    del q, k, v, want
    cfg = get_config(PHI3V)
    (B, S), H, KV, d = PREFIX_CHECK, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(13)
    q = torch.randn((B, H, S, d), generator=gen, device=DEVICE)
    k, v = (torch.randn((B, KV, S, d), generator=gen, device=DEVICE)
            for _ in range(2))
    want = flash_plain_by_rows(q, k, v, None)
    out["phi3v_prefix_layer"] = fp32_flash_layer(
        q, k, v, want, "timing: phi-3-vision prefix layer")
    return out


def fp32_flash_layer(q, k, v, want, what: str) -> dict:
    """One fp32 causal layer through ``flash_fwd``: its max error and share
    of the limit, ms, the plain version's and SDPA's ms, its bound."""
    import torch.nn.functional as F
    from repro_torch.kernels.flash_attn.kernel import (band_pairs,
                                                       flash_attn_cuda)
    from repro_torch.kernels.flash_attn.ref import flash_attn_plain
    B, H, S, d = q.shape
    KV = k.shape[1]
    o = flash_attn_cuda(q, k, v, causal=True)
    ratio, raw = flash_ratio(o, want, "float32")
    if ratio > 1:
        raise AssertionError(f"{what}: flash_attn fp32 max err {raw}, "
                             f"{ratio} of the limit")
    del o
    pairs = band_pairs(S, S, True, None)
    flops = 4 * B * H * d * pairs
    nbytes = 4 * (2 * B * H * S * d + 2 * B * KV * S * d)
    t, by = bound(nbytes, flops, FP32_FLOP_PER_S)
    ms = cuda_ms(lambda: flash_attn_cuda(q, k, v, causal=True), 10, 2)
    return {"shape": [B, H, KV, S, d], "dtype": "float32", "causal": True,
            "band_pairs": pairs, "flops": flops, "bytes": nbytes,
            "max_abs_err": raw, "share_of_limit": ratio, "ms": ms,
            "plain_ms": cuda_ms(lambda: flash_attn_plain(
                q, k, v, causal=True), 3),
            "bound_ms": t, "bound_by": by, "share_of_bound": t / ms,
            "library_ms": cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True, enable_gqa=True), 10, 2),
            "useful_tflop_per_s": flops / ms / 1e9,
            "main_path_launches": 0}


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



# the analysis phase: compute-sanitizer's tools over one launch of each
# kernel at a small case of its sweep, in parallel child processes
SANITIZER = "/usr/local/cuda/bin/compute-sanitizer"
SANITIZE_TOOLS = ("memcheck", "racecheck", "initcheck")
# only the port's kernels are checked, not PyTorch's own
SANITIZE_FILTER = ("regex=(tree_gram|gram_diag|gram_offdiag|gram_reduce|"
                   "weighted_sum|coord_stats|krum_scores|bulyan_select|"
                   "flash_fwd|act_kernel)")
SANITIZE_TIMEOUT = 240
# what the tool prints where it cannot instrument the card
SANITIZE_UNSUPPORTED = "Device not supported"
_SANITIZE_CHILD = """
import sys
sys.path.insert(0, %r)
import torch
from repro_torch.kernels.coord_stats.kernel import (
    bulyan_select_cuda, coord_stats_cuda, krum_scores_cuda)
from repro_torch.kernels.flash_attn.kernel import flash_attn_cuda
from repro_torch.kernels.gram.kernel import gram_cuda, tree_gram_cuda
from repro_torch.kernels.weighted_sum.kernel import weighted_sum_cuda
g = torch.Generator(device="cuda").manual_seed(0)
X = torch.randn(15, 10_001, device="cuda", generator=g)
tree_gram_cuda(X)
tree_gram_cuda(X, sketch_stride=2, block_n=1024)
weighted_sum_cuda(X, torch.randn(15, device="cuda", generator=g))
gram_cuda(torch.randn(2_049, 15, device="cuda", generator=g))
mask = (torch.arange(15, device="cuda") %% 4 != 0).float()
coord_stats_cuda(X, "median", 3)
coord_stats_cuda(X, "meamed", 3, mask=mask)
D = torch.rand(15, 15, device="cuda", generator=g)
D = D + D.T
D.fill_diagonal_(0)
krum_scores_cuda(D, 3)
bulyan_select_cuda(D, 3)
q = torch.randn(1, 2, 130, 64, device="cuda", generator=g).bfloat16()
flash_attn_cuda(q, q, q, causal=True)
q = torch.randn(1, 2, 77, 64, device="cuda", generator=g)
flash_attn_cuda(q, q, q, causal=True, window=16)
from repro_torch.kernels.activations import kernel as act_k
a = torch.randn(3, 1000, device="cuda", generator=g).bfloat16()
for name in act_k.NAMES:
    act_k.act(a, name)
    act_k.act_gated_grad(a, a, a, name)
act_k.act_gated(a[:, 1:], a[:, :-1], "silu")
act_k.act_grad(a, a, None, "gelu")
torch.cuda.synchronize()
print("launched", flush=True)
"""


def _sanitize(tool_args, code: str):
    """``compute-sanitizer --tool ... python -c code``, started."""
    import os
    with open(os.devnull) as null:
        return subprocess.Popen(
            [SANITIZER, "--tool", *tool_args, "--print-limit", "20",
             sys.executable, "-c", code], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, stdin=null, text=True, cwd=ROOT,
            start_new_session=True)


def _sync_sites(trace) -> list:
    """The ops of ``trace`` in which the card synchronised: site, op,
    allowed or not, and whether the CPU trace's dispatch-level rule sees
    the same op."""
    from repro_torch.analysis.rules import dispatch_visible
    return [{"site": op.site, "op": op.name,
             "allowed": "transfer" in op.allowed,
             "seen_on_cpu": dispatch_visible(op)}
            for op in trace.ops if op.sync]


def _transfer_line(what: str, trace) -> dict:
    from repro_torch.analysis import check_transfer
    findings = check_transfer(trace)
    syncs = _sync_sites(trace) + [
        {"site": site, "op": None, "allowed": False, "seen_on_cpu": False}
        for site in trace.syncs_outside]
    missed: dict = {}
    for s in syncs:
        if not s["seen_on_cpu"]:
            key = (s["op"] or "no dispatched op", s["site"], s["allowed"])
            missed[key] = missed.get(key, 0) + 1
    for (op, site, ok), n in missed.items():
        print(f"analysis: {what}: the card synchronised {n}x in {op} at "
              f"{site}, which the CPU trace does not flag"
              + (" (allowed)" if ok else ""), flush=True)
    if findings:
        raise AssertionError(f"analysis {what}: "
                             + "; ".join(f.render() for f in findings))
    return {"ops": len(trace.ops), "syncs": syncs,
            "allowed": {f"{r} {site}": n
                        for (r, _, site), n in trace.allowed.items()}}


def phase_analysis():
    """``repro_torch.analysis`` on the card (module docstring: analysis)."""
    import os
    import torch
    from repro_torch.analysis import (capture, check_kernel_budget,
                                      check_sanitizer, parse_ptxas)
    from repro_torch.analysis.entrypoints import run_sweep
    from repro_torch.analysis.kernel_rules import (KBUDGET_ALLOWED,
                                                   _allowed_reason)
    from repro_torch.configs import get_config
    from repro_torch.core.flag import FlagConfig
    from repro_torch.dist.aggregation import AggregatorConfig, aggregate_tree
    from repro_torch.dist.serve_step import build_serve_step
    from repro_torch.kernels import _build
    from repro_torch.launch.lint import allowed_lines
    from repro_torch.models import transformer

    t0 = time.perf_counter()
    if not os.path.exists(SANITIZER):
        raise AssertionError(f"analysis: {SANITIZER} is missing")
    # first, in the background: can the sanitizer run a CUDA program here?
    probe = _sanitize(("memcheck", "--kernel-name", "regex=never_matches"),
                      "import torch; torch.zeros(1, device='cuda') + 1; "
                      "torch.cuda.synchronize(); print('launched')")
    children = {"probe": probe}
    try:
        # the lint sweep on the card, every entry under sync-debug mode
        report = run_sweep(device="cuda", sharded="skip")
        by_rule: dict = {}
        for _, fs in report.sections:
            for f in fs:
                by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
        allowed = allowed_lines(report)
        for line in allowed:
            print(f"analysis: {line}", flush=True)
        lint = {"entries": len(report.sections), "findings_by_rule": by_rule,
                "allowed": allowed, "s": time.perf_counter() - t0}
        if not report.clean:
            raise AssertionError("analysis lint on the card:\n"
                                 + report.render())
        # TRANSFER at full width: the W = 15 smollm-360m stack
        torch.cuda.synchronize()
        X = torch.randn(MAIN_W, MAIN_N, device=DEVICE,
                        generator=torch.Generator(DEVICE).manual_seed(3))
        full = {}
        for agg in ("flag", "bulyan", "multi_krum"):
            cfg = AggregatorConfig(name=agg, f=MAIN_F,
                                   flag=FlagConfig(lam=float(MAIN_W)))
            full[agg] = _transfer_line(
                f"aggregate_tree[{agg}]",
                capture(aggregate_tree, X, cfg, name=agg))
        del X
        torch.cuda.empty_cache()
        cfg = get_config("smollm-360m")
        params = transformer.init_params(cfg, seed=0, device=DEVICE)
        caches = transformer.init_caches(cfg, PREFILL_B, 128, torch.float32,
                                         device=DEVICE)
        tok = torch.zeros((PREFILL_B, 1), dtype=torch.int32, device=DEVICE)
        serve = build_serve_step(cfg, max_len=128)
        with torch.no_grad():
            serve(params, caches, tok, 0)                 # warm
            full["decode"] = _transfer_line(
                "decode_step", capture(serve, params, caches, tok, 1,
                                       name="decode"))
        del params, caches
        torch.cuda.empty_cache()
        # KBUDGET on the build's ptxas lines
        built = _build.build_all(SOURCES)
        budgets = parse_ptxas([ln for b in built.values() for ln in b.ptxas])
        kfind = check_kernel_budget(budgets)
        table = {fn: {"registers": b.registers,
                      "spill_bytes": b.spill_stores + b.spill_loads,
                      "smem": b.smem, "dynamic_smem": b.dynamic_smem,
                      "verdict": _allowed_reason(fn, KBUDGET_ALLOWED)
                      or "ok"} for fn, b in budgets.items()}
        if kfind or not budgets:
            raise AssertionError("analysis kbudget: " + "; ".join(
                f.render() for f in kfind) if kfind else "no ptxas lines")
        out, _ = probe.communicate(timeout=SANITIZE_TIMEOUT)
        sanitizer = {"probe_returncode": probe.returncode}
        if SANITIZE_UNSUPPORTED in out:
            # the tool's own verdict on this machine: it instruments nothing
            reason = next(ln for ln in out.splitlines()
                          if SANITIZE_UNSUPPORTED in ln).strip("= ")
            print(f"analysis: compute-sanitizer cannot run here ({reason}): "
                  "racecheck, memcheck and initcheck (the twins of KRACE and "
                  "KTILING) were not run", flush=True)
            sanitizer.update(usable=False, reason=reason)
        elif probe.returncode != 0 or "launched" not in out:
            raise AssertionError("analysis compute-sanitizer probe:\n"
                                 + out[:3000])
        else:
            sanitizer["usable"] = True
            for tool in SANITIZE_TOOLS:
                children[tool] = _sanitize(
                    (tool, "--kernel-name", SANITIZE_FILTER),
                    _SANITIZE_CHILD % str(ROOT / "src"))
            for tool in SANITIZE_TOOLS:
                proc = children[tool]
                out, _ = proc.communicate(timeout=SANITIZE_TIMEOUT)
                sanitizer[tool] = {"returncode": proc.returncode,
                                   "summary": out.strip().splitlines()[-1:]}
                if check_sanitizer(tool, out, proc.returncode) or \
                        "launched" not in out:
                    raise AssertionError(
                        f"analysis compute-sanitizer {tool}:\n"
                        + out[:3000] + "\n...\n" + out[-2000:])
    finally:
        for proc in children.values():
            _stop(proc)
    emit({"phase": "analysis", "seconds": time.perf_counter() - t0,
          "lint": lint, "transfer_full_width": full, "kbudget": table,
          "sanitizer": {"path": SANITIZER, **sanitizer}})


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
    phase_activations()
    import shutil
    import tempfile
    dry_tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    started = _start_dryrun(dry_tmp)
    try:
        with _drawn_once():     # the main path's runs: one smollm draw
            launches, peaks, hists = phase_train()
            comm_refs = phase_train_comm(peaks["flag"])
            phase_resume(hists["flag"])
            phase_train_sharded(hists, peaks, comm_refs)
            tp_launches = phase_train_tp(hists, peaks, started)
    finally:
        for key in ("fake", "cli", "cli_zero1"):
            _stop(started[key])
        shutil.rmtree(dry_tmp, ignore_errors=True)
    flash_launches = phase_serve()
    phase_analysis()
    phase_serve_recurrent(XLSTM, XLSTM_N, XLSTM_PREFILL, "serve_xlstm")
    rg_flash_launches = phase_serve_recurrent(RGEMMA, RGEMMA_N,
                                              RGEMMA_PREFILL, "serve_rgemma")
    with _drawn_once():         # each of these phases draws its model twice
        phase_train_xlstm()
    mixtral_flash_launches = phase_serve_moe(MIXTRAL)
    phase_serve_moe(DEEPSEEK)
    with _drawn_once():
        phase_train_moe()
    attn_launches = {a: phase_serve_attn(a) for a in SERVE_ATTN}
    with _drawn_once():
        phase_train_musicgen()
    phase_check()
    phase_byzantine(smi)
    rows = phase_timing(launches, flash_launches, smi, by_width)
    phase_timing_recurrent(smi, rg_flash_launches)
    phase_timing_moe(smi, mixtral_flash_launches)
    phase_timing_frontends(smi, attn_launches)
    for row in rows:
        if row["name"] in tp_launches:
            row["train_tp_launches_rank0"] = tp_launches[row["name"]]
    rows += list(ACT_ROWS.values())
    print(smi, flush=True)
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
