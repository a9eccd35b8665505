"""Run a function as the ranks of a ``torch.distributed`` world on this
host, as ``torchrun`` would start them.

    results = spawn(fn, 3, arg, timeout=120)

starts 3 fresh processes (the ``spawn`` start method), sets in each the
variables ``torchrun`` sets (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` = 127.0.0.1 and a free
``MASTER_PORT``), calls ``fn(rank, *args)`` and returns the ranks' return
values in rank order (passed back through files in a temporary
directory).  ``fn`` makes its own process group from that environment,
e.g. through ``repro_torch.launch.train.main``.  A rank that raises, or
a world still running after ``timeout`` seconds, fails the call; every
process is gone when it returns.  The sharded CPU tests and the
``train_sharded`` phase of ``chip_smoke.py`` start their worlds with it.

The port is free when :func:`free_port` picks it and taken when rank 0
binds it; another world started in between may take it first.  A world
whose rank fails with "address already in use" is started again on a
fresh port, at most ``PORT_TRIES`` times in all, each retry printed to
standard error.
"""

from __future__ import annotations

import os
import shutil
import socket
import sys
import tempfile
import time

import torch
import torch.multiprocessing as mp

__all__ = ["spawn", "free_port", "PORT_TRIES"]

PORT_TRIES = 3
# what a rank's error says when its store's port was taken
_PORT_TAKEN = ("address already in use", "EADDRINUSE")


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free a moment ago."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, fn, nprocs, port, out_dir, args):
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(nprocs),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(nprocs),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    out = fn(rank, *args)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def spawn(fn, nprocs: int, *args, timeout: float) -> list:
    """``[fn(0, *args), ..., fn(nprocs - 1, *args)]``, each in its own
    process of one world (module docstring)."""
    for attempt in range(1, PORT_TRIES + 1):
        port = free_port()
        try:
            return _spawn_once(fn, nprocs, args, port, timeout)
        except mp.ProcessRaisedException as e:
            if attempt == PORT_TRIES or not any(
                    m in str(e) for m in _PORT_TAKEN):
                raise
            print(f"ranks.spawn: port {port} was taken before rank 0 bound "
                  f"it (try {attempt} of {PORT_TRIES}); starting the world "
                  f"of {nprocs} again on a fresh port", file=sys.stderr,
                  flush=True)
    raise AssertionError("unreachable")


def _spawn_once(fn, nprocs: int, args, port: int, timeout: float) -> list:
    out_dir = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    try:
        ctx = mp.start_processes(
            _entry, args=(fn, nprocs, port, out_dir, args),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout
        try:
            while not ctx.join(timeout=max(0.0, min(
                    1.0, deadline - time.monotonic()))):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks still running after "
                                       f"{timeout} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join()
        return [torch.load(os.path.join(out_dir, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
