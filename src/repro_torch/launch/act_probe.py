"""Where the activation kernel's time goes on the card, and what a call
costs the host.

    PYTHONPATH=src python -m repro_torch.launch.act_probe

Builds variants of ``csrc/activations.cu`` into ``build/act_probe/``,
each the shipped source with one textual patch, and times silu forward,
gated forward and gated backward in bf16 at smollm-360m's MLP width
(4 x 2048 x 2560) with CUDA events, in turns (every variant, then again
in reverse order), beside ``F.silu``, ``F.silu`` and a product, and a
copy of the input.  Two kinds of variant:

* an alternative that stays correct and is held bit for bit against the
  eager composition on every bf16 bit pattern: ``ieee_divide`` (the
  logistic's reciprocal as ``__fdiv_rn(1, a)`` in place of
  ``__frcp_rn(a)``);
* probes, which take a part of the work out and so compute a wrong
  result: ``no_rounding`` (no bf16 rounding between the primitives),
  ``copy`` (silu returns its input: loads and stores only).

Then the host's microseconds a call at the decode width (4 x 1 x 2560,
where the device waits on the host), in turns: the public
``models.activations.gated`` (which launches directly), the custom
operator ``repro_torch::act_gated``, the eager composition, and
``F.silu`` with a product.  Prints one JSON line a variant, one for the
host times, and the card's name and power limit.  Raises without a card;
a patch that no longer matches the source raises too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time

import torch
import torch.nn.functional as F

from repro_torch.kernels import _build
from repro_torch.kernels.activations import kernel as act_kernel
from repro_torch.kernels.activations.ref import PLAIN, gated_plain

OUT = _build.BUILD_DIR.parent / "act_probe"

# name -> [(old, new), ...]; every ``old`` must occur exactly once
PATCHES = {
    "shipped": [],
    "ieee_divide": [("return rnd<T>(__frcp_rn(a));",
                     "return rnd<T>(__fdiv_rn(1.0f, a));")],
    "no_rounding": [("return __bfloat162float(__float2bfloat16_rn(v));",
                     "return v;")],
    "copy": [("if (F == kSilu) return O::mul(x, logistic<T>(x));",
              "if (F == kSilu) return x;")],
}
CORRECT = ("shipped", "ieee_divide")
SHAPE = (4, 2048, 2560)
DECODE_SHAPE = (4, 1, 2560)


def patched(name: str, source: str) -> str:
    for old, new in PATCHES[name]:
        if source.count(old) != 1:
            raise ValueError(f"act_probe {name}: patch target occurs "
                             f"{source.count(old)} times: {old!r}")
        source = source.replace(old, new)
    return source


def build(names) -> dict:
    """Compile every variant, one ``nvcc`` each, all started together;
    name -> (launch function, ptxas spill lines)."""
    OUT.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "activations.cu").read_text()
    nvcc = _build._nvcc()
    procs = {}
    for name in names:
        src = OUT / f"{name}.cu"
        src.write_text(patched(name, source))
        so = OUT / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", str(so), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        fn = ctypes.CDLL(str(so)).act_launch
        fn.argtypes = [i32, i32, i32, vp, vp, vp, vp, vp, i64, i64, i64, i64,
                       i64, ctypes.c_float, ctypes.c_float, i32, vp]
        fn.restype = i32
        spills = [line for line in _build._ptxas_lines(log)
                  if "spill" in line]
        libs[name] = (fn, spills)
    return libs


def cuda_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_us(fn, calls: int) -> float:
    for _ in range(20):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return 1e6 * (time.perf_counter() - t0) / calls


def _differ() -> int:
    """Values where the current build differs from the composition: every
    bf16 bit pattern, silu and sigmoid forward and gated with both
    cotangents (the forms that read the reciprocal)."""
    x = torch.arange(-(1 << 15), 1 << 15, dtype=torch.int32).to(
        torch.int16).view(torch.bfloat16).cuda()
    up, g = x.flip(0), x.roll(7)
    n = 0
    for f in ("sigmoid", "silu"):
        pairs = [(act_kernel.act(x, f), PLAIN[f](x)),
                 (act_kernel.act_gated(up, x, f), gated_plain(f, up, x))]
        a, b = up.clone().requires_grad_(True), x.clone().requires_grad_(True)
        gated_plain(f, a, b).backward(g)
        pairs += list(zip(act_kernel.act_gated_grad(g, up, x, f),
                          (a.grad, b.grad)))
        for got, want in pairs:
            n += int(((got.view(torch.int16) != want.view(torch.int16))
                      & ~(got.isnan() & want.isnan())).sum())
    return n


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=list(PATCHES))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--calls", type=int, default=500)
    ap.add_argument("--seed", type=int, default=7)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("act_probe times the kernel on a CUDA card; "
                           "none is available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build(args.variants)
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    x, up, g = (torch.randn(SHAPE, generator=gen, device="cuda").bfloat16()
                for _ in range(3))
    forms = {
        "silu": lambda: act_kernel.act(x, "silu"),
        "gated": lambda: act_kernel.act_gated(up, x, "silu"),
        "gated_backward": lambda: act_kernel.act_gated_grad(g, up, x,
                                                            "silu")}
    yardsticks = {"F_silu": lambda: F.silu(x),
                  "F_silu_mul": lambda: up * F.silu(x),
                  "copy": lambda: x.clone()}
    saved = act_kernel._launch
    differ = {}
    times = {n: {f: [] for f in forms} for n in args.variants}
    lib_ms = {n: [cuda_ms(fn, args.reps)] for n, fn in yardsticks.items()}
    try:
        for name in args.variants + args.variants[::-1]:
            act_kernel._launch = libs[name][0]
            if name in CORRECT and name not in differ:
                differ[name] = _differ()
                if differ[name]:
                    raise AssertionError(f"act_probe {name}: {differ[name]} "
                                         f"values differ from the "
                                         f"composition")
            for form, fn in forms.items():
                times[name][form].append(cuda_ms(fn, args.reps))
    finally:
        act_kernel._launch = saved
    for n, fn in yardsticks.items():
        lib_ms[n].append(cuda_ms(fn, args.reps))
    out = {"card": card, "shape": list(SHAPE), "library_ms": lib_ms,
           "variants": {}}
    for name in args.variants:
        row = {"ms": times[name], "spills": libs[name][1]}
        if name in differ:
            row["differ"] = differ[name]
        out["variants"][name] = row
        print(json.dumps({"variant": name, **row}), flush=True)
    from repro_torch.models import activations
    xd, ud = (torch.randn(DECODE_SHAPE, generator=gen,
                          device="cuda").bfloat16() for _ in range(2))
    calls = {"public_gated": lambda: activations.gated("silu", ud, xd),
             "operator_gated": lambda: act_kernel.act_gated_op(ud, xd,
                                                               "silu"),
             "composition_gated": lambda: gated_plain("silu", ud, xd),
             "F_silu_mul": lambda: ud * F.silu(xd)}
    host = {n: [] for n in calls}
    with torch.no_grad():
        for order in (list(calls), list(calls)[::-1]):
            for n in order:
                host[n].append(host_us(calls[n], args.calls))
    out["host_us"] = host
    print(json.dumps({"host_us": host, "shape": list(DECODE_SHAPE)}),
          flush=True)
    print(json.dumps({"card": card, "shape": list(SHAPE),
                      "library_ms": lib_ms}), flush=True)
    return out


if __name__ == "__main__":
    main()
