"""The kernel-level rules: twins of ``repro/analysis/pallas_extract.py`` and
``repro/analysis/pallas_rules.py``.

JAX opens every ``pallas_call`` in a jaxpr and reads its grid, block
specs and body.  The port's kernels are CUDA C++ built by ``nvcc``
(``repro_torch.kernels._build``) and reached through custom operators
(``repro_torch::*``), so the families read what the port has:

``ksites``
    The number of ``repro_torch::*`` launches in a trace
    (:func:`check_kernel_sites`), taken on fake CUDA tensors on the CPU
    (each custom operator has a fake implementation).  ``expect_sites``
    pins it, as JAX's ``check_kernels(..., expect_sites=)`` does, so an
    entry that stops launching a kernel fails.
``kbudget`` (the twin of KVMEM)
    ``ptxas -v``'s lines (:func:`parse_ptxas`: registers, spill stores and
    loads, static shared memory per function) and each function's dynamic
    shared memory (:func:`dynamic_smem`, the launch's own sizes): no
    spill bytes, and static plus dynamic shared memory within the card's
    227 KiB opt-in limit (:func:`check_kernel_budget`).  On the CPU it
    runs on recorded ptxas lines; on the card on the real build.
``ksentinel``
    Non-finite constants (``INFINITY``, ``CUDART_INF*``, ``HUGE_VAL*``,
    ``__int_as_float(0x7f800000)`` and its negation) in the masked-
    selection sources (:func:`check_kernel_sentinel`); JAX's kernels pad
    with ``finfo(float32).max``.
``ksanitizer`` (the twin of KRACE and KTILING)
    They have no trace-time twin: ``compute-sanitizer``'s ``racecheck``,
    ``memcheck`` and ``initcheck`` over each kernel at a small shape on the
    card (``chip_smoke.py``'s ``analysis`` phase, where the tool can
    instrument the card; where it answers "Device not supported" the
    phase says so and runs none) are.  :func:`check_sanitizer` reads one
    tool's output.

KPRECISION has no separate twin: the kernels' accumulators are held by
the card's comparisons of every kernel against its plain PyTorch version
(``chip_smoke.py``'s sweeps).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from pathlib import Path

from repro_torch.analysis.findings import Finding

__all__ = ["SMEM_LIMIT_BYTES", "KernelBudget", "parse_ptxas",
           "dynamic_smem", "check_kernel_budget", "check_kernel_sites",
           "check_kernel_sentinel", "check_sanitizer", "KBUDGET_ALLOWED",
           "KSENTINEL_ALLOWED", "SENTINEL_SOURCES", "K_RULES"]

# the H100's opt-in shared memory a block (cudaDevAttrMaxSharedMemoryPerBlockOptin)
SMEM_LIMIT_BYTES = 227 * 1024
# function-name pattern -> why its budget finding stays
KBUDGET_ALLOWED = {
    r"coord_stats_kernelILi(64|128)E": (
        "coord_stats at 32 < R <= 128 spills; no main path runs more than "
        "32 workers (ROADMAP.md perf item 7)"),
}
SENTINEL_SOURCES = ("coord_stats.cu", "krum_select.cu")
# source -> why its +inf sentinel stays (the test that holds it)
KSENTINEL_ALLOWED = {
    "coord_stats.cu": (
        "+inf pads inactive rows; the outputs equal JAX's default route "
        "(its masked references) wherever a pad reaches them, JAX's "
        "kernel alone pads with finfo.max: tests/test_torch_analysis.py::"
        "test_sentinel_cases_match_jax"),
    "krum_select.cu": (
        "+inf pads missing candidates; the outputs equal JAX's default "
        "route wherever a pad reaches them, JAX's kernel alone pads with "
        "finfo.max: tests/test_torch_analysis.py::"
        "test_sentinel_cases_match_jax"),
}


# ---------------------------------------------------------------------------
# KBUDGET
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class KernelBudget:
    function: str
    registers: int = 0
    spill_stores: int = 0
    spill_loads: int = 0
    stack: int = 0
    smem: int = 0               # static shared memory, bytes

    @property
    def dynamic_smem(self) -> int:
        return dynamic_smem(self.function)


def parse_ptxas(lines) -> dict[str, KernelBudget]:
    """Per function, from ``Built.ptxas``'s ``"function: ..."`` lines or a
    raw ``ptxas -v`` log (a string)."""
    if isinstance(lines, str):
        from repro_torch.kernels._build import _ptxas_lines
        lines = _ptxas_lines(lines)
    acc: dict[str, dict] = {}
    for line in lines:
        fn, sep, rest = line.partition(": ")
        if not sep or " " in fn:
            continue                        # a performance warning
        rec = acc.setdefault(fn, {})
        for key, pat in (("registers", r"(\d+) registers"),
                         ("spill_stores", r"(\d+) bytes spill stores"),
                         ("spill_loads", r"(\d+) bytes spill loads"),
                         ("stack", r"(\d+) bytes stack frame"),
                         ("smem", r"(\d+) bytes smem")):
            m = re.search(pat, rest)
            if m:
                rec[key] = int(m.group(1))
    return {fn: KernelBudget(fn, **rec) for fn, rec in acc.items()}


def _flash_fp32_smem(d: int) -> int:
    tm, bk = (8 if d <= 128 else 4), (64 if d <= 64 else 32)
    warps, slots = (8 if d == 64 else 4), 3
    rw = 4 * tm                         # rows of a warp: 4 lanes of tm
    bq = rw * warps
    w = min(d, 128)                     # columns of a TMA box
    kv = bk * (d // w) * (w + 4)        # one K or V tile, padded rows
    floats = d * (bq + 4) + slots * kv + warps * bk * (rw + 4)
    return 4 * floats + 8 * (1 + slots) + 4 * slots + 128


def _flash_tc_smem(d: int) -> int:
    bq, bk, stages = 64, (64 if d <= 128 else 32), 2
    bar = bq * d * 2 + 2 * stages * bk * d * 2
    return bar + 8 * (1 + stages) + 1024


def dynamic_smem(function: str) -> int:
    """The dynamic shared memory ``csrc/flash_attn.cu`` launches a
    function with (``F32Tile<D>::kSmem`` and ``TcTile<D>::kSmem`` bytes);
    0 for the other kernels, which launch with none."""
    m = re.search(r"flash_fwd_tcILi(\d+)E", function)
    if m:
        return _flash_tc_smem(int(m.group(1)))
    m = re.search(r"flash_fwdILi(\d+)E", function)
    if m:
        return _flash_fp32_smem(int(m.group(1)))
    return 0


def _allowed_reason(function: str, allowed: dict) -> str | None:
    return next((r for pat, r in allowed.items()
                 if re.search(pat, function)), None)


def check_kernel_budget(budgets: dict[str, KernelBudget], *,
                        allowed: dict | None = None,
                        max_smem: int = SMEM_LIMIT_BYTES,
                        name: str = "kernels") -> list[Finding]:
    """KBUDGET: no spill bytes and static + dynamic shared memory within
    ``max_smem`` for every function of ``budgets`` (a function matched by
    a pattern of ``allowed`` is skipped: ``KBUDGET_ALLOWED`` by
    default)."""
    allowed = KBUDGET_ALLOWED if allowed is None else allowed
    findings = []
    for fn, b in budgets.items():
        if _allowed_reason(fn, allowed):
            continue
        ev = (f"{fn}: {b.registers} registers, {b.spill_stores} B spill "
              f"stores, {b.spill_loads} B spill loads, {b.smem} B static + "
              f"{b.dynamic_smem} B dynamic smem")
        if b.spill_stores or b.spill_loads:
            findings.append(Finding(
                "kbudget", "spill", name, ev,
                f"{fn} spills {b.spill_stores} B / loads {b.spill_loads} B "
                "to local memory"))
        if b.smem + b.dynamic_smem > max_smem:
            findings.append(Finding(
                "kbudget", "smem", name, ev,
                f"{fn} needs {b.smem + b.dynamic_smem} B of shared memory, "
                f"over the {max_smem} B a block may have"))
    return findings


# ---------------------------------------------------------------------------
# KSITES
# ---------------------------------------------------------------------------

def check_kernel_sites(trace, *, expect_sites: int | None = None,
                       name: str | None = None) -> list[Finding]:
    """KSITES: the trace's ``repro_torch::*`` launches; with
    ``expect_sites``, exactly that many."""
    sites = trace.sites()
    name = name or trace.name
    if expect_sites is not None and len(sites) != expect_sites:
        return [Finding(
            "ksites", "<count>", name,
            f"sites: {[op.name for op in sites]}",
            f"expected {expect_sites} kernel launch(es), found "
            f"{len(sites)} — the entry does not reach the kernels it "
            "claims to")]
    return []


# ---------------------------------------------------------------------------
# KSENTINEL
# ---------------------------------------------------------------------------

_NONFINITE = re.compile(
    r"-?\b(INFINITY|CUDART_INF\w*|HUGE_VALF?|HUGE_VALL|"
    r"__int_as_float\(\s*0x[fF7][fF]800000\s*\)|"
    r"numeric_limits<\s*float\s*>::infinity)")


def check_kernel_sentinel(sources: dict[str, str] | None = None, *,
                          allowed: dict | None = None,
                          name: str = "kernels") -> list[Finding]:
    """KSENTINEL: each non-finite constant in ``sources`` ({file name:
    text}; default: ``SENTINEL_SOURCES`` read from ``csrc/``), one finding
    a line; a file of ``allowed`` (``KSENTINEL_ALLOWED`` by default) is
    skipped."""
    allowed = KSENTINEL_ALLOWED if allowed is None else allowed
    if sources is None:
        csrc = Path(__file__).resolve().parents[1] / "csrc"
        sources = {f: (csrc / f).read_text() for f in SENTINEL_SOURCES}
    findings = []
    for fname, text in sources.items():
        if fname in allowed:
            continue
        for i, line in enumerate(text.splitlines(), 1):
            code = line.split("//", 1)[0]
            m = _NONFINITE.search(code)
            if m:
                findings.append(Finding(
                    "ksentinel", m.group(1), name,
                    f"{fname}:{i}: {line.strip()}",
                    f"non-finite sentinel {m.group(0)!r} in {fname} — "
                    "a masked lane's inf can reach a sum or a difference "
                    "(inf - inf = nan); pad with a finite value"))
    return findings


# ---------------------------------------------------------------------------
# KSANITIZER
# ---------------------------------------------------------------------------

_SUMMARY = re.compile(r"ERROR SUMMARY:\s*(\d+)\s+error")


def check_sanitizer(tool: str, output: str, returncode: int, *,
                    name: str = "kernels") -> list[Finding]:
    """One ``compute-sanitizer --tool <tool>`` run: its error summary must
    say 0 errors and the run must exit 0."""
    m = _SUMMARY.search(output)
    errors = int(m.group(1)) if m else None
    if errors == 0 and returncode == 0:
        return []
    tail = " | ".join(output.strip().splitlines()[-6:])
    return [Finding(
        "ksanitizer", tool, name, tail,
        f"compute-sanitizer --tool {tool}: "
        + (f"{errors} error(s)" if errors is not None else "no summary")
        + f", exit {returncode}")]


K_RULES = {
    "ksites": check_kernel_sites,
    "kbudget": check_kernel_budget,
    "ksentinel": check_kernel_sentinel,
    "ksanitizer": check_sanitizer,
}
