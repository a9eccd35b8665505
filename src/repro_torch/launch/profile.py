"""Where one train step's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile --arch smollm-360m \\
        --workers 15 --byzantine 3 --attack sign_flip --aggregator flag

Takes the train launcher's flags, runs one warm-up step, one timed step
and one step under ``torch.profiler`` (CPU and CUDA activity), and prints
one JSON line: the timed step's wall time (host clock ending in a
synchronisation), the profiled step's wall time and device busy time (the
sum of every kernel's device time), the device's idle share (busy time
against the unprofiled wall time), the number of CPU-side operator calls,
and the kernels that took the most device time.  Without a card it
raises, as the launcher does (``--device cpu`` gives a CPU-only profile
with no device numbers).
"""

from __future__ import annotations

import json
import time

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.data import lm_worker_batches
from repro_torch.launch.train import _parser, setup


def _device_us(evt) -> float:
    return float(getattr(evt, "self_device_time_total",
                         getattr(evt, "self_cuda_time_total", 0.0)))


def main(argv=None) -> dict:
    ap = _parser()
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args(argv)
    args.steps = max(args.steps, 3)
    run = setup(args)
    on_card = run.device.type == "cuda"

    def one_step(t):
        batch = lm_worker_batches(run.task, run.wdc, t, args.seq,
                                  device=run.device)
        m = run.step_fn(run.state, batch, t)
        if on_card:
            torch.cuda.synchronize(run.device)
        return m

    one_step(0)
    t0 = time.perf_counter()
    one_step(1)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card
                                     else [])
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        m = one_step(2)
        profiled_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    # Kernels are events of their own; operators on the CPU also carry
    # their kernels' time, so only the former are summed.
    kernels = [e for e in events if e.device_type.name != "CPU"]
    busy_ms = sum(_device_us(e) for e in kernels) / 1e3
    top = sorted(kernels, key=_device_us, reverse=True)[:args.top]
    out = {
        "phase": "profile", "arch": run.cfg.name, "workers": args.workers,
        "device": str(run.device),
        "loss": float(m["loss"]),
        "wall_ms": wall_ms,
        "wall_ms_profiled": profiled_ms,
        "device_busy_ms": busy_ms if on_card else None,
        "device_idle_share": (1.0 - busy_ms / wall_ms) if on_card else None,
        "cpu_op_calls": sum(e.count for e in events
                            if e.device_type.name == "CPU"),
        "top_kernels": [{"name": e.key[:80], "calls": e.count,
                         "device_ms": _device_us(e) / 1e3} for e in top],
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
