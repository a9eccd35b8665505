"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``src/repro_torch/csrc/<name>.cu`` exposes a plain C entry point and
is compiled on its own by ``nvcc`` into ``build/repro_torch/<name>-<hash>.so``
at the repository root (the hash covers the source, the local headers it
includes and the flags, so an edited source or header rebuilds and an
unchanged one is reused).  Nothing here
includes PyTorch's headers, so a build takes seconds.  Kernels are built at
first use, never at import: importing this module needs no ``nvcc``.

``build_all`` compiles several sources at once, one ``nvcc`` process each,
and returns what ``-Xptxas -v`` printed (registers, shared memory, spills,
and ptxas's performance warnings, such as serialized ``wgmma``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclass(frozen=True)
class Built:
    name: str
    path: Path
    seconds: float          # 0.0 when a cached library was reused
    ptxas: tuple[str, ...]  # "function: N registers, M bytes smem, ..." lines


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
            shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]:
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit (set CUDA_HOME)")


def _sources(path: Path) -> list[Path]:
    """``path`` and the local headers it includes (``#include "..."``),
    recursively, each once."""
    out, todo = [], [path]
    while todo:
        p = todo.pop()
        if p in out:
            continue
        out.append(p)
        todo += [p.parent / m for m in re.findall(
            r'^\s*#include\s+"([^"]+)"', p.read_text(), re.MULTILINE)]
    return out


def _target(name: str) -> Path:
    h = hashlib.sha256()
    for path in _sources(CSRC / f"{name}.cu"):
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _ptxas_lines(log: str) -> tuple[str, ...]:
    """Pair each 'Compiling entry function' with its 'Used ...' line."""
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers(.*)", line)
        if m and fn:
            out.append(f"{fn}: {m.group(1)} registers{m.group(2)}")
            fn = None
        elif "spill" in line and fn and "0 bytes spill" not in line:
            out.append(f"{fn}: {line.split(':', 1)[-1].strip()}")
        elif "Performance Loss" in line:       # e.g. serialized wgmma
            out.append(line.split(":", 1)[-1].strip())
    return tuple(out)


def build_all(names) -> dict[str, Built]:
    """Compile every named source that has no up-to-date library, all
    ``nvcc`` processes started together; raise if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    results: dict[str, Built] = {}
    t0 = time.perf_counter()
    for name in names:
        target = _target(name)
        if target.exists():
            results[name] = Built(name, target, 0.0, ())
            continue
        nvcc = nvcc or _nvcc()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, target)
    failed = []
    for name, (proc, tmp, target) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        os.replace(tmp, target)        # atomic: a reader sees all or nothing
        results[name] = Built(name, target, time.perf_counter() - t0,
                              _ptxas_lines(log))
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return results


def load_library(name: str, signatures: dict) -> ctypes.CDLL:
    """Build ``name`` if needed, load it and declare its C signatures
    (``{function: (argtypes, restype)}``)."""
    lib = ctypes.CDLL(str(build_all([name])[name].path))
    for fn, (argtypes, restype) in signatures.items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = restype
    return lib


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {status}")
