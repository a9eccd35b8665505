"""Where the coordinate-statistics kernel's time goes on the card.

    PYTHONPATH=src python -m repro_torch.launch.coord_probe

Builds variants of ``csrc/coord_stats.cu`` into ``build/coord_probe/``, each
the shipped source with one textual patch, and times them with CUDA events,
in turns (every variant, then again in reverse order), at the shapes the
main path gives the kernel: W = 15, N = 361,821,120, fp32, f = 3, for each
op; the median with 3 of 15 workers masked out (12 rows read); and
Bulyan's MeaMed over 9 picked rows (``rows=``, f = 6).  Variants:

* ``shipped``: the source as it is;
* ``prefetch``: the next column loaded into registers before this one is
  sorted, so its loads are in flight during the network (the staging
  choice not kept: slower on the card); correct, held bit-equal to
  ``shipped``;
* ``loads_only``: the same walk over the same rows, each column summed in
  worker order, no network, no center, no window: what the memory walk
  alone reaches (a wrong result on purpose).

Prints one JSON line per variant (``ms`` per case over both turns, its
ptxas lines at R = 15 and R = 9 in fp32) and one with the card's name and
power limit and each case's byte bound.  Raises without a card; a patch
that no longer matches the source raises too.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.coord_stats import kernel as cs_kernel

OUT = _build.BUILD_DIR.parent / "coord_probe"
HBM_BYTES_PER_S = 3.35e12       # H100 SXM, published
SHAPE = (15, 361_821_120)       # W, N
F = 3

_STAT_START = "    sort_net(s);\n\n    float center;"
_STAT_END = "    out[col] = r;\n"
_LOADS_ONLY = """    float r = 0.f;
#pragma unroll
    for (int i = 0; i < P; ++i) r += s[i];
"""

# name -> [(old, new), ...]; every ``old`` must occur exactly once; an old
# given as (start, end) replaces the text from start up to end
PATCHES = {
    "shipped": [],
    "no_prefetch": [("constexpr bool kPrefetch = true;",
                     "constexpr bool kPrefetch = false;")],
    "loads_only": [((_STAT_START, _STAT_END), _LOADS_ONLY)],
}
CORRECT = ("shipped", "no_prefetch")


def patched(name: str, source: str) -> str:
    for old, new in PATCHES[name]:
        start, end = old if isinstance(old, tuple) else (old, None)
        for t in (start, end):
            if t is not None and source.count(t) != 1:
                raise ValueError(f"coord_probe {name}: patch target occurs "
                                 f"{source.count(t)} times: {t!r}")
        i = source.index(start)
        j = source.index(end) if end is not None else i + len(start)
        source = source[:i] + new + source[j:]
    return source


def build(names) -> dict:
    """Compile every variant, one ``nvcc`` each, all started together."""
    OUT.mkdir(parents=True, exist_ok=True)
    source = (_build.CSRC / "coord_stats.cu").read_text()
    nvcc = _build._nvcc()
    procs = {}
    for name in names:
        src = OUT / f"{name}.cu"
        src.write_text(patched(name, source))
        so = OUT / f"{name}.so"
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(so),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        lib = ctypes.CDLL(str(so))
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.coord_stats_launch.argtypes = [vp, i32, i64, vp, i32, i64, i32,
                                           i32, vp, vp, i32, vp]
        lib.coord_stats_launch.restype = i32
        ptxas = [line.split(": ", 1)[-1] for line in _build._ptxas_lines(log)
                 if "coord_stats_kernelILi15EfE" in line
                 or "coord_stats_kernelILi9EfE" in line]
        libs[name] = (lib, ptxas)
    return libs


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=list(PATCHES))
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=2)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("coord_probe times the kernel on a CUDA card; "
                           "none is available")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    libs = build(args.variants)
    W, N = SHAPE
    gen = torch.Generator(device="cuda")
    gen.manual_seed(args.seed)
    X = torch.randn((W, N), generator=gen, device="cuda")
    mask = torch.ones(W, device="cuda")
    mask[torch.randperm(W, generator=gen, device="cuda")[:3]] = 0.0
    rows = torch.randperm(W, generator=gen, device="cuda")[:9].to(
        torch.int32)
    cases = {op: (op, F, {}) for op in ("median", "trimmed_mean", "meamed",
                                        "phocas")}
    cases["masked_median"] = ("median", F, {"mask": mask})
    cases["bulyan_meamed_9_rows"] = ("meamed", 2 * F, {"rows": rows})
    read = {"masked_median": W - 3, "bulyan_meamed_9_rows": 9}
    bound = {c: 1e3 * (read.get(c, W) + 1) * N * 4 / HBM_BYTES_PER_S
             for c in cases}

    times = {name: {c: [] for c in cases} for name in args.variants}
    want = {}
    saved = cs_kernel._libs.get("coord_stats")
    try:
        for name in args.variants + args.variants[::-1]:
            cs_kernel._libs["coord_stats"] = libs[name][0]
            for c, (op, f, kw) in cases.items():
                def run(op=op, f=f, kw=kw):
                    return cs_kernel.coord_stats_cuda(X, op, f, **kw)
                if name in CORRECT:
                    got = run()
                    torch.cuda.synchronize()
                    if c not in want:
                        want[c] = got
                    elif not torch.equal(got, want[c]):
                        raise AssertionError(f"coord_probe {name} {c}: "
                                             f"differs from {CORRECT[0]}")
                    del got
                times[name][c].append(cuda_ms(run, args.reps))
    finally:
        if saved is None:
            cs_kernel._libs.pop("coord_stats", None)
        else:
            cs_kernel._libs["coord_stats"] = saved
    out = {"card": card, "shape": list(SHAPE), "bound_ms": bound,
           "variants": {}}
    for name in args.variants:
        row = {"ms": {c: sum(t) / len(t) for c, t in times[name].items()},
               "turns_ms": times[name], "ptxas": libs[name][1]}
        out["variants"][name] = row
        print(json.dumps({"variant": name, **row}), flush=True)
    print(json.dumps({"card": card, "shape": list(SHAPE),
                      "bound_ms": bound}), flush=True)
    return out


if __name__ == "__main__":
    main()
