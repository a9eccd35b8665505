"""Structured findings -- the common currency of every analysis rule
(port of ``repro/analysis/findings.py``).

A :class:`Finding` pins a violated invariant to a rule family, the
offending op, the entry point it was traced in, and its evidence: the
``file:line`` of the innermost ``src/repro_torch/`` frame that issued the
op, followed by the op's record (its aten name, shapes and dtypes; a
collective's kind and bytes; a ptxas line or a source line for the kernel
rules).  Rules return ``list[Finding]`` -- empty means clean -- so callers
compose them freely: the ``@contract`` decorator raises
:class:`ContractViolation` on any, ``python -m repro_torch.launch.lint``
prints them and exits nonzero, tests assert emptiness (or, for
true-positive fixtures, assert a specific rule id shows up).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field


@dataclass(frozen=True)
class Finding:
    """One violated invariant, pinned to graph evidence.

    ``rule`` is the registry id (``shape`` | ``precision`` | ``recompile``
    | ``transfer`` | ``mask`` | ``collectives`` | a kernel rule); ``op``
    the aten operator / collective kind (or a rule-specific tag);
    ``computation`` the traced entry point; ``evidence`` the issuing
    ``file:line`` and the op's record (truncated for display);
    ``message`` the human-readable statement of what bound was broken and
    by what.
    """

    rule: str
    op: str
    computation: str
    evidence: str
    message: str

    def render(self, *, width: int = 100) -> str:
        ev = " ".join(self.evidence.split())
        if len(ev) > width:
            ev = ev[: width - 3] + "..."
        return (f"[{self.rule}] {self.message}\n"
                f"    op={self.op} computation={self.computation}\n"
                f"    evidence: {ev}")

    def to_dict(self) -> dict:
        """JSON-ready mapping (the ``lint --json`` payload unit)."""
        return asdict(self)


def format_findings(findings: list[Finding], *, header: str = "") -> str:
    if not findings:
        return header + "clean (0 findings)" if header else "clean"
    lines = [header] if header else []
    lines += [f.render() for f in findings]
    lines.append(f"{len(findings)} finding(s)")
    return "\n".join(lines)


class ContractViolation(AssertionError):
    """A graph contract was broken; carries the structured findings.

    Subclasses ``AssertionError`` so pytest renders it as a first-class
    assertion failure and ``pytest.raises(AssertionError)`` guards keep
    working in callers that don't know about the analysis layer.
    """

    def __init__(self, findings: list[Finding], *, name: str = ""):
        self.findings = list(findings)
        self.name = name
        head = f"contract violated: {name}" if name else "contract violated"
        super().__init__(format_findings(self.findings, header=head + "\n"))


@dataclass
class Report:
    """Accumulated findings over a sweep (one entry point per section)."""

    sections: list[tuple[str, list[Finding]]] = field(default_factory=list)
    # entry -> {(rule, reason, site): count} of the allowed sites it passed
    allowed: dict = field(default_factory=dict)

    def add(self, name: str, findings: list[Finding]) -> None:
        self.sections.append((name, list(findings)))

    @property
    def findings(self) -> list[Finding]:
        return [f for _, fs in self.sections for f in fs]

    @property
    def clean(self) -> bool:
        return not self.findings

    def render(self) -> str:
        lines = []
        for name, fs in self.sections:
            status = "ok" if not fs else f"{len(fs)} finding(s)"
            lines.append(f"{name:58s} {status}")
            lines += ["  " + ln for f in fs for ln in f.render().splitlines()]
        lines.append(f"-- {len(self.sections)} entry point(s), "
                     f"{len(self.findings)} finding(s) total")
        return "\n".join(lines)

    def to_dict(self) -> dict:
        """Machine-readable sweep result (``lint --json``): one object per
        entry point, findings as dicts."""
        return {
            "clean": self.clean,
            "total_findings": len(self.findings),
            "entries": [
                {"entry": name, "clean": not fs,
                 "findings": [f.to_dict() for f in fs]}
                for name, fs in self.sections
            ],
        }
