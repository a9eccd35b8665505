"""RECOMPILE: one captured program must serve every variant (port of
``repro/analysis/recompile.py``).

The port compiles nothing at run time, but the invariant's purpose has a
torch twin: a single capture of an entry point -- a CUDA graph, the tool
of ``ROADMAP.md``'s first perf item -- must replay for every argument
variant (every membership mask, every decode position).  The "compile
count" is the number of distinct trace signatures over the variants: the
op sequence, every shape and dtype, and every non-tensor argument
(:meth:`repro_torch.analysis.trace.Op.signature`).  A position or mask
value that reaches an op as a Python scalar therefore counts as a
recompile, as a concretized value would in JAX.  On the card the rule
also holds that ``repro_torch.kernels._build`` compiled each CUDA source
at most once over the variants.
"""

from __future__ import annotations

from repro_torch.analysis.findings import ContractViolation, Finding
from repro_torch.analysis.rules import RULES
from repro_torch.analysis.trace import capture

__all__ = ["signatures", "check_recompile", "assert_no_recompile"]


def signatures(fn, variants) -> list[tuple]:
    """The distinct trace signatures of ``fn(*v)`` over ``variants``, in
    first-seen order."""
    out: list[tuple] = []
    for v in variants:
        sig = capture(fn, *v).signature()
        if sig not in out:
            out.append(sig)
    return out


def check_recompile(fn, variants=(), *, name: str | None = None,
                    max_compiles: int = 1) -> list[Finding]:
    """Call ``fn`` over ``variants`` (argument tuples, each run as
    ``fn(*v)``) and flag more distinct signatures than ``max_compiles``,
    or a CUDA source built more than once."""
    from repro_torch.kernels import _build
    name = name or getattr(fn, "__name__", "entry")
    variants = list(variants)
    before = dict(_build.COMPILED)
    sigs = signatures(fn, variants)
    findings = []
    rebuilt = {k: n - before.get(k, 0) for k, n in _build.COMPILED.items()
               if n - before.get(k, 0) > 1}
    if rebuilt:
        findings.append(Finding(
            "recompile", "nvcc", name, f"builds over the variants: {rebuilt}",
            f"{name} built a CUDA source more than once over "
            f"{len(variants)} variant(s)"))
    n = len(sigs)
    if n > max_compiles:
        first = next((i for i, (a, b) in enumerate(zip(sigs[0], sigs[1]))
                      if a != b), min(len(sigs[0]), len(sigs[1])))
        where = sigs[1][first] if first < len(sigs[1]) else "<end>"
        findings.append(Finding(
            "recompile", "signature", name,
            f"{n} signatures over {len(variants)} variant(s); the first "
            f"difference at op {first}: {where}",
            f"{name} compiled {n}x (budget {max_compiles}) — some argument "
            "reaches an op as a Python value instead of a device tensor, "
            "so no single captured program serves every variant"))
    return findings


def assert_no_recompile(fn, variants=(), *, name: str | None = None,
                        max_compiles: int = 1) -> None:
    """Raise :class:`ContractViolation` if ``fn`` recompiled."""
    findings = check_recompile(fn, variants, name=name,
                               max_compiles=max_compiles)
    if findings:
        raise ContractViolation(findings, name=name or "recompile")


RULES["recompile"] = check_recompile
