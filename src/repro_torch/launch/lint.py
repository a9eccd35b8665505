"""lint: sweep the port's public entry points through repro_torch.analysis
(port of ``tools/jaxlint.py``; it lives in the package because ``tools/``
belongs to the JAX package).

Lints every entry of :mod:`repro_torch.analysis.entrypoints` -- all 11
aggregation rules x {plain, masked, sketch} (x sharded, in fake worlds),
the gram solver, the compressed routes, the bf16 serve path, the train
step, the recompile harness, the tensor-parallel prefill and train step,
and the kernel block (site counts, KSENTINEL, on the card KBUDGET) -- and
exits nonzero on any finding.  A finding that stays is named at its site
with ``repro_torch.analysis.allowed(rule, reason)``; the sweep prints
those sites and how often each ran (``ROADMAP.md`` lists them).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.lint [options]

Options:
  --device {cuda,cpu}           where the real-tensor entries run (default
                                cuda: the card, every entry under CUDA's
                                sync-debug mode; without a card it raises,
                                as every entry point of the port does)
  --sharded {auto,force,skip}   the fake-world entries (sharded
                                aggregation, TP; default auto: iff >= 8
                                CUDA devices)
  --entry SUBSTR [SUBSTR ...]   lint only entries whose name contains any
                                (``--only`` is the alias)
  --rule RULE [RULE ...]        keep only findings from these rule
                                families; entries still all run
  --json PATH                   also write the machine-readable report to
                                PATH (``-`` for stdout)
  --list                        print the entry names and exit
  -q / --quiet                  findings only, no per-entry progress
"""

from __future__ import annotations

import argparse
import json
import sys


def allowed_lines(report) -> list[str]:
    """One line an ``allowed`` site: rule, site, runs, reason."""
    sites: dict = {}
    for hits in report.allowed.values():
        for (rule, reason, site), n in hits.items():
            key = (rule, site, reason)
            sites[key] = sites.get(key, 0) + n
    return [f"allowed [{rule}] {site} x{n}: {reason}"
            for (rule, site, reason), n in sorted(sites.items())]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--sharded", choices=("auto", "force", "skip"),
                    default="auto")
    ap.add_argument("--entry", "--only", nargs="+", default=None,
                    metavar="SUBSTR", dest="entry")
    ap.add_argument("--rule", nargs="+", default=None, metavar="RULE")
    ap.add_argument("--json", default=None, metavar="PATH")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("-q", "--quiet", action="store_true")
    args = ap.parse_args(argv)

    from repro_torch.analysis.entrypoints import run_sweep, sweep_entries
    from repro_torch.analysis.findings import Report
    from repro_torch.analysis.rules import RULES
    from repro_torch.device import resolve_device

    if args.rule:
        unknown = sorted(set(args.rule) - set(RULES))
        if unknown:
            ap.error(f"unknown rule(s) {unknown}; known: {sorted(RULES)}")
    if args.list:
        for e in sweep_entries(sharded=args.sharded, device=args.device):
            print(e.name)
        return 0
    device = resolve_device(args.device).type

    progress = None
    if not args.quiet:
        progress = lambda name: print(f"lint {name}", flush=True)
    report = run_sweep(sharded=args.sharded, names=args.entry,
                       device=device, progress=progress)
    if args.rule:
        filtered = Report(allowed=report.allowed)
        for name, fs in report.sections:
            filtered.add(name, [f for f in fs if f.rule in args.rule])
        report = filtered

    if args.json:
        payload = json.dumps({**report.to_dict(),
                              "allowed": allowed_lines(report)}, indent=2)
        if args.json == "-":
            print(payload)
        else:
            with open(args.json, "w") as fh:
                fh.write(payload + "\n")

    print()
    print(report.render())
    for line in allowed_lines(report):
        print(line)
    return 0 if report.clean else 1


if __name__ == "__main__":
    sys.exit(main())
