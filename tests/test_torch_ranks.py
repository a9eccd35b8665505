"""``repro_torch.launch.ranks.spawn`` under a taken port.

``free_port`` hands out a port that was free a moment ago; another world
may bind it before rank 0 does.  ``spawn`` then starts the world again on
a fresh port (at most ``PORT_TRIES`` times), and fails at once on any
other error.  The rank function is this module's: the spawned ranks
import it, so it imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import socket

import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro_torch.launch import ranks


def _sum_rank(rank):
    """A gloo world from the environment; the sum of rank + 1."""
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="env://")
    try:
        t = torch.tensor([rank + 1.0])
        dist.all_reduce(t)
        return float(t)
    finally:
        dist.destroy_process_group()


def _failing_rank(rank):
    raise ValueError(f"rank {rank} fails on purpose")


@pytest.fixture
def taken_port():
    """A port held open (bound and listening on every address) for the
    test's length."""
    with socket.socket() as s:
        s.bind(("", 0))
        s.listen()
        yield s.getsockname()[1]


def _ports(monkeypatch, first):
    """``free_port`` giving ``first`` once, then free ports; the ports it
    gave."""
    given = []
    real = ranks.free_port

    def port():
        given.append(first if not given else real())
        return given[-1]
    monkeypatch.setattr(ranks, "free_port", port)
    return given


def test_spawn_retries_a_taken_port(taken_port, monkeypatch, capfd):
    given = _ports(monkeypatch, taken_port)
    assert ranks.spawn(_sum_rank, 2, timeout=120) == [3.0, 3.0]
    assert len(given) == 2 and given[0] == taken_port
    assert given[1] != taken_port
    err = capfd.readouterr().err
    assert f"port {taken_port} was taken" in err and "try 1 of 3" in err


def test_spawn_does_not_retry_other_errors(monkeypatch):
    given = _ports(monkeypatch, ranks.free_port())
    with pytest.raises(mp.ProcessRaisedException, match="on purpose"):
        ranks.spawn(_failing_rank, 2, timeout=120)
    assert len(given) == 1


def test_spawn_gives_up_after_port_tries(taken_port, monkeypatch):
    monkeypatch.setattr(ranks, "free_port", lambda: taken_port)
    with pytest.raises(mp.ProcessRaisedException,
                       match="(?i)address already in use|EADDRINUSE"):
        ranks.spawn(_sum_rank, 2, timeout=120)
