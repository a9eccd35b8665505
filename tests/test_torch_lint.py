"""``python -m repro_torch.launch.lint``: the port's entry-point sweep.

The whole sweep (``run_sweep(device="cpu", sharded="force")``, the
sharded and tensor-parallel entries in fake worlds) runs in a child
process: a fake process group becomes the process's default group.  It
must be clean apart from the ``analysis.allowed`` sites, and each of
those sites' reasons is listed in ``ROADMAP.md``.  ``--list`` prints every
entry; a planted fault (the masked Krum's one-hot built by
``F.one_hot``, which checks its range on the host) makes the CLI exit
nonzero; without ``--device cpu`` and with no card it raises, as every
entry point of the port does.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

from repro_torch.analysis.entrypoints import SWEEP_RULES, sweep_entries

ROOT = Path(__file__).resolve().parents[1]
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
       "OMP_NUM_THREADS": "1"}


def _run(code: str, timeout: float = 300) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)],
                          env=ENV, cwd=ROOT, capture_output=True, text=True,
                          timeout=timeout)


@pytest.fixture(scope="module")
def sweep():
    proc = _run("""
        import json
        import torch
        torch.set_num_threads(1)
        from repro_torch.analysis.entrypoints import run_sweep
        from repro_torch.launch.lint import allowed_lines
        report = run_sweep(device="cpu", sharded="force")
        out = report.to_dict()
        out["allowed"] = {name: [list(k) + [n] for k, n in hits.items()]
                          for name, hits in report.allowed.items()}
        out["lines"] = allowed_lines(report)
        print(json.dumps(out))
    """)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_full_sweep_is_clean_apart_from_allowed_sites(sweep):
    bad = [(e["entry"], f["message"]) for e in sweep["entries"]
           for f in e["findings"]]
    assert sweep["clean"] and not bad, bad
    names = [e["entry"] for e in sweep["entries"]]
    assert len(names) == len(set(names))
    for rule in SWEEP_RULES:
        assert f"aggregate_tree/{rule}/sharded" in names
    assert {"tp/prefill/bf16", "tp/train_step/bf16",
            "recompile/serve_step", "kernels/ksentinel"} <= set(names)


def test_allowed_sites_are_the_listed_ones(sweep):
    """Every allowed site the sweep passes names its reason, and
    ROADMAP.md lists it; the decode position and the host-built mask are
    among them (ROADMAP perf item 1)."""
    roadmap = (ROOT / "ROADMAP.md").read_text()
    sites = {(rule, site.rsplit(":", 1)[0], reason)
             for hits in sweep["allowed"].values()
             for rule, reason, site, _ in hits}
    assert {s[:2] for s in sites} >= {
        ("recompile", "repro_torch/models/transformer.py"),
        ("transfer", "repro_torch/dist/train_step.py"),
        ("transfer", "repro_torch/core/flag.py"),
        ("precision", "repro_torch/models/layers.py")}
    for rule, path, reason in sites:
        assert reason and f"`{path}`" in roadmap and reason in \
            " ".join(roadmap.split()), (rule, path, reason)
    assert all(line.startswith("allowed [") for line in sweep["lines"])


def test_list_prints_every_entry():
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.lint", "--device", "cpu",
         "--sharded", "force", "--list"], env=ENV, cwd=ROOT,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr[-2000:]
    want = [e.name for e in sweep_entries(sharded="force", device="cpu")]
    assert proc.stdout.split() == want
    cuda = [e.name for e in sweep_entries(sharded="force", device="cuda")]
    assert set(cuda) - set(want) == {"kernels/kbudget",
                                     "kernels/aggregate/flag_cuda",
                                     "kernels/aggregate/sharded_cuda"}


def test_planted_fault_makes_the_cli_exit_nonzero(tmp_path):
    out = tmp_path / "report.json"
    proc = _run(f"""
        import sys
        import torch
        from repro_torch.core import aggregators

        def planted(D2, name, f, mask):
            # the masked Krum pick as it was: F.one_hot checks its range
            # on the host, a read of a value the mask reaches
            s = aggregators.masked_krum_scores(D2, f, mask)
            s = torch.where(mask != 0, s, float("inf"))
            return torch.nn.functional.one_hot(
                torch.argmin(s), D2.shape[0]).to(D2.dtype) * mask
        aggregators.masked_selection_weights = planted
        from repro_torch.launch.lint import main
        sys.exit(main(["--device", "cpu", "--sharded", "skip", "-q",
                       "--entry", "krum/masked", "--json", {str(out)!r}]))
    """)
    assert proc.returncode == 1, proc.stderr[-2000:]
    report = json.loads(out.read_text())
    rules = {f["rule"] for e in report["entries"] for f in e["findings"]}
    assert rules == {"mask", "transfer"}


def test_without_a_card_it_raises(monkeypatch):
    from repro_torch.launch import lint
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lint.main(["--entry", "gram_solver", "-q"])
