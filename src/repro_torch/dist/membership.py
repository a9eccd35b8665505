"""Elastic worker membership: who is in the aggregation round.

Port of ``repro/dist/membership.py``.  A :class:`FaultSchedule` is static
data (tuples of :class:`FaultEvent`); :func:`membership_at` maps a step
index to the round's :class:`Membership`.  In the JAX package the step
index is traced and the table lowers to constants; here it is a host int,
so the (W,) state is computed with numpy on the host and the train step
sends the mask to the device (one small copy a step, never a read back).

Masking, not slicing: the worker axis keeps its size W, and the (W,) mask
goes to :func:`repro_torch.dist.aggregation.compressed_aggregate` (masked
Gram rows, masked order statistics, frozen EF memory of absent workers).

Semantics: a worker covered by an event interval at ``step`` is out of
the round (crashed, departed, or straggling past the sync deadline);
``staleness`` counts the consecutive steps (inclusive) it has been out,
0 while active.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

__all__ = ["FaultEvent", "FaultSchedule", "Membership", "membership_at",
           "active_mask", "FAULTS", "get_fault_schedule"]

# "Forever" sentinel for crash events (any step beyond a real horizon).
NEVER = 1 << 30

KINDS = ("crash", "leave", "straggle")


@dataclass(frozen=True)
class FaultEvent:
    """One worker-outage interval: ``worker`` is out for ``[start, stop)``.
    ``kind`` ('crash' | 'leave' | 'straggle') is telemetry; the membership
    consequence is the same."""

    kind: str
    worker: int
    start: int
    stop: int = NEVER

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; have {KINDS}")
        if not 0 <= self.start < self.stop:
            raise ValueError(f"bad interval [{self.start}, {self.stop})")
        if self.worker < 0:
            raise ValueError(f"bad worker index {self.worker}")


@dataclass(frozen=True)
class FaultSchedule:
    """A static, hashable set of outage intervals (default: no faults)."""

    events: tuple[FaultEvent, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "events", tuple(self.events))

    @property
    def is_trivial(self) -> bool:
        return not self.events

    def max_worker(self) -> int:
        return max((e.worker for e in self.events), default=-1)


class Membership(NamedTuple):
    """Round membership: ``active`` bool (W,), ``staleness`` int32 (W,)
    (consecutive steps out of the round, 0 if active); numpy arrays."""

    active: np.ndarray
    staleness: np.ndarray


def _merged_intervals(schedule: FaultSchedule):
    """Per-worker outage intervals with adjacent or overlapping events
    merged, so staleness counts from the merged interval's start (a worker
    out for [0, 5) and [5, 10) has been gone 8 steps at step 7)."""
    per_worker: dict[int, list[list[int]]] = {}
    for e in sorted(schedule.events, key=lambda e: (e.worker, e.start)):
        ivs = per_worker.setdefault(e.worker, [])
        stop = min(e.stop, NEVER)
        if ivs and e.start <= ivs[-1][1]:
            ivs[-1][1] = max(ivs[-1][1], stop)
        else:
            ivs.append([e.start, stop])
    return [(w, s, t) for w, ivs in per_worker.items() for s, t in ivs]


def membership_at(schedule: FaultSchedule, step: int, W: int) -> Membership:
    """Membership at host step ``step`` for W workers; workers named by no
    event are always active."""
    if schedule.max_worker() >= W:
        raise ValueError(
            f"fault schedule names worker {schedule.max_worker()} but the "
            f"step only has W={W} workers")
    active = np.ones((W,), bool)
    staleness = np.zeros((W,), np.int32)
    for w, start, stop in _merged_intervals(schedule):
        if start <= step < stop:
            active[w] = False
            staleness[w] = max(staleness[w], step - start + 1)
    return Membership(active, staleness)


def active_mask(schedule: FaultSchedule, step: int, W: int) -> np.ndarray:
    """Float32 (W,) active mask at ``step`` (the aggregation's currency)."""
    return membership_at(schedule, step, W).active.astype(np.float32)


# ---------------------------------------------------------------------------
# scenario registry
# ---------------------------------------------------------------------------

def _none(W: int) -> FaultSchedule:
    return FaultSchedule()


def _crash(W: int, *, n: int = 1, at: int = 10) -> FaultSchedule:
    """The last ``n`` workers crash at step ``at`` and never return (the
    last, so crash and Byzantine sets do not overlap by default; capped at
    W - 1, so a schedule never empties the quorum)."""
    n = min(n, W - 1)
    return FaultSchedule(tuple(
        FaultEvent("crash", W - 1 - i, at) for i in range(n)))


def _rejoin(W: int, *, n: int = 1, at: int = 10,
            down: int = 10) -> FaultSchedule:
    """``n`` workers leave at ``at`` and rejoin ``down`` steps later."""
    n = min(n, W - 1)
    return FaultSchedule(tuple(
        FaultEvent("leave", W - 1 - i, at, at + down) for i in range(n)))


def _churn(W: int, *, period: int = 5, horizon: int = 200) -> FaultSchedule:
    """Rolling membership: every ``period`` steps the next worker (round
    robin) drops out for one period."""
    return FaultSchedule(tuple(
        FaultEvent("leave", r % W, r * period, (r + 1) * period)
        for r in range(max(horizon // period, 1))))


def _straggle(W: int, *, n: int = 1, every: int = 10,
              duration: int = 3, horizon: int = 200) -> FaultSchedule:
    """``n`` workers periodically miss ``duration`` sync deadlines."""
    n = min(n, W - 1)
    events = []
    for start in range(every, max(horizon, every + 1), every):
        for i in range(n):
            events.append(FaultEvent("straggle", W - 1 - i, start,
                                     start + min(duration, every)))
    return FaultSchedule(tuple(events))


FAULTS = {
    "none": _none,
    "crash": _crash,
    "rejoin": _rejoin,
    "churn": _churn,
    "straggle": _straggle,
}


def get_fault_schedule(name: str, W: int, **kw) -> FaultSchedule:
    """Build a named fault scenario for ``W`` workers."""
    if name not in FAULTS:
        raise KeyError(f"unknown fault scenario {name!r}; have "
                       f"{sorted(FAULTS)}")
    return FAULTS[name](W, **kw)
