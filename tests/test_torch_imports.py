"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports ``jax``, the JAX package ``repro`` or the JAX
package's ``benchmarks`` (the port keeps its own copy of what it needs,
such as the CNN loop of ``benchmarks/common.py``)."""

from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro", "benchmarks")


def _imported_modules(path: Path) -> list[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    mods = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            mods.append(node.module or "")
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__") and node.args
              and isinstance(node.args[0], ast.Constant)):
            mods.append(str(node.args[0].value))
    return mods


def test_port_has_files():
    assert len(FILES) > 20 and all(p.exists() for p in FILES)


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scanner_catches_forbidden_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import jax.numpy as jnp\nfrom repro.core import gram\n"
                 "from repro_torch.core import gram as g2\n"
                 "import importlib\nimportlib.import_module('jax')\n"
                 "from benchmarks.common import cnn_loss\n"
                 "import benchmarks\n")
    bad = [m for m in _imported_modules(f) if m.split(".")[0] in FORBIDDEN]
    assert bad == ["jax.numpy", "repro.core", "benchmarks.common",
                   "benchmarks", "jax"]


@pytest.mark.parametrize("rel", [
    "src/repro_torch/models/ssm.py", "src/repro_torch/models/rglru.py",
    "src/repro_torch/configs/xlstm_1_3b.py",
    "src/repro_torch/configs/recurrentgemma_9b.py"])
def test_walk_covers_the_recurrent_modules(rel):
    """The recurrent slice's modules are among the files walked above."""
    assert ROOT / rel in FILES


@pytest.mark.parametrize("rel", [
    "src/repro_torch/launch/mesh.py", "src/repro_torch/launch/ranks.py",
    "src/repro_torch/dist/sharding.py", "src/repro_torch/dist/sharded.py",
    "src/repro_torch/configs/shapes.py",
    "src/repro_torch/dist/tensor_parallel.py"])
def test_walk_covers_the_sharding_modules(rel):
    """The sharding slice's modules are among the files walked above."""
    assert ROOT / rel in FILES


@pytest.mark.parametrize("rel", [
    "src/repro_torch/launch/dryrun.py", "src/repro_torch/dist/serve_step.py",
    "src/repro_torch/models/attention.py"])
def test_walk_covers_the_dryrun_and_serving_modules(rel):
    """The dryrun slice's modules are among the files walked above."""
    assert ROOT / rel in FILES
