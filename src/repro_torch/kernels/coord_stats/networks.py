"""Sorting networks for the coordinate-statistics and selection kernels.

    PYTHONPATH=src python -m repro_torch.kernels.coord_stats.networks

writes ``csrc/sort_networks.cuh``, the generated header both CUDA sources
include (``tests/test_torch_sort_networks.py`` holds the checked-in header
against this module).  Every network is Batcher's merge-exchange sort
(Knuth, TAOCP vol. 3, section 5.2.2, Algorithm M), which sorts any n, not
only powers of two: 26 comparators at n = 9, 59 at n = 15, 63 at n = 16
and 191 at n = 32, against the odd-even transposition sort's n(n-1)/2.

A comparator (i, j), i < j, is a min/max compare-exchange of keys: after
it, k[i] <= k[j].  Keys only, no payload, so the network need not be
stable.  The kernels instantiate exact widths ``EXACT`` (a column of R <= 16
values sorts at R) and padded widths ``PADDED`` (above 16, the next of 32,
64, 128, the tail filled with +inf).
"""

from __future__ import annotations

import argparse
from pathlib import Path

EXACT = tuple(range(1, 17))
PADDED = (32, 64, 128)
HEADER = Path(__file__).resolve().parents[2] / "csrc" / "sort_networks.cuh"


def merge_exchange(n: int) -> list[tuple[int, int]]:
    """Batcher's merge-exchange comparators for n keys, in the order they
    run (Algorithm M, steps M1-M6)."""
    if n < 2:
        return []
    t = (n - 1).bit_length()            # ceil(log2 n)
    out = []
    p = 1 << (t - 1)
    while p > 0:
        q, r, d = 1 << (t - 1), 0, p
        while True:
            out.extend((i, i + d) for i in range(n - d) if i & p == r)
            if q == p:
                break
            d, q, r = q - p, q >> 1, p
        p >>= 1
    return out


def width_for(r: int) -> int:
    """The network width the coordinate kernel sorts r values at."""
    if r < 1 or r > PADDED[-1]:
        raise ValueError(f"no network for {r} values (1..{PADDED[-1]})")
    return r if r <= EXACT[-1] else next(p for p in PADDED if p >= r)


def comparators(r: int) -> list[tuple[int, int]]:
    """The comparators the coordinate kernel runs on r values (at its
    padded width above 16)."""
    return merge_exchange(width_for(r))


def apply(net, keys):
    """Run a network over a list of keys (min/max compare-exchanges)."""
    k = list(keys)
    for i, j in net:
        if k[j] < k[i]:
            k[i], k[j] = k[j], k[i]
    return k


def header_text() -> str:
    lines = [
        "// Sorting networks for csrc/coord_stats.cu and csrc/krum_select.cu.",
        "// Generated by src/repro_torch/kernels/coord_stats/networks.py "
        "(Batcher's",
        "// merge-exchange sort); do not edit: run",
        "//     PYTHONPATH=src python -m "
        "repro_torch.kernels.coord_stats.networks",
        "// sort_net(k) sorts the keys k[0..N) ascending with min/max "
        "compare-exchanges,",
        "// every index a compile-time constant, so k stays in registers.",
        "",
        "#pragma once",
        "",
        "__device__ __forceinline__ void sort_cx(float& a, float& b) {",
        "  const float lo = fminf(a, b);",
        "  b = fmaxf(a, b);",
        "  a = lo;",
        "}",
        "",
        "__device__ __forceinline__ void sort_net(float (&)[1]) {}",
    ]
    for n in EXACT[1:] + PADDED:
        net = merge_exchange(n)
        lines += ["", f"// n = {n}: {len(net)} comparators",
                  f"__device__ __forceinline__ void sort_net(float (&k)[{n}])"
                  " {"]
        for c0 in range(0, len(net), 4):
            lines.append("  " + " ".join(f"sort_cx(k[{i}], k[{j}]);"
                                         for i, j in net[c0:c0 + 4]))
        lines.append("}")
    return "\n".join(lines) + "\n"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Write csrc/sort_networks.cuh.")
    ap.add_argument("--out", type=Path, default=HEADER)
    args = ap.parse_args(argv)
    args.out.write_text(header_text())
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
