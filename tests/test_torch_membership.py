"""Port parity for worker membership (``repro_torch.dist.membership``)
against ``repro.dist.membership``: the schedules' events, and the round's
active set and staleness at every step, exactly (integer state)."""

from __future__ import annotations

import jax
import numpy as np
import pytest

from repro.dist import membership as jmem
from repro_torch.dist import membership as tmem

W = 8
STEPS = range(61)
# the five schedules at their defaults, and with keyword arguments that
# put a leave and a rejoin inside a few steps (the train tests' settings)
SCHEDULES = [("none", {}), ("crash", {}), ("rejoin", {}), ("churn", {}),
             ("straggle", {}), ("crash", {"n": 3, "at": 2}),
             ("rejoin", {"n": 2, "at": 1, "down": 3}),
             ("churn", {"period": 2, "horizon": 40}),
             ("straggle", {"n": 2, "every": 4, "duration": 2,
                           "horizon": 50})]


def _events(schedule):
    return [(e.kind, e.worker, e.start, e.stop) for e in schedule.events]


@pytest.mark.parametrize("name,kw", SCHEDULES,
                         ids=[f"{n}-{sorted(k.items())}" for n, k in SCHEDULES])
def test_membership_matches_jax(name, kw):
    got = tmem.get_fault_schedule(name, W, **kw)
    want = jmem.get_fault_schedule(name, W, **kw)
    assert _events(got) == _events(want)
    assert got.is_trivial == want.is_trivial
    jat = jax.jit(lambda s: jmem.membership_at(want, s, W))
    for step in STEPS:
        m, jm = tmem.membership_at(got, step, W), jat(step)
        np.testing.assert_array_equal(m.active, np.asarray(jm.active),
                                      err_msg=f"active, step {step}")
        np.testing.assert_array_equal(m.staleness, np.asarray(jm.staleness),
                                      err_msg=f"staleness, step {step}")
        assert m.active.dtype == bool and m.staleness.dtype == np.int32
        np.testing.assert_array_equal(
            tmem.active_mask(got, step, W),
            np.asarray(jmem.active_mask(want, step, W)))


def test_staleness_counts_from_the_merged_interval():
    """Out for [0, 5) and [5, 10): 8 consecutive steps at step 7."""
    sched = tmem.FaultSchedule((tmem.FaultEvent("leave", 1, 0, 5),
                                tmem.FaultEvent("straggle", 1, 5, 10)))
    jsched = jmem.FaultSchedule((jmem.FaultEvent("leave", 1, 0, 5),
                                 jmem.FaultEvent("straggle", 1, 5, 10)))
    m = tmem.membership_at(sched, 7, 3)
    assert m.staleness.tolist() == [0, 8, 0]
    assert m.staleness.tolist() == np.asarray(
        jmem.membership_at(jsched, 7, 3).staleness).tolist()
    assert tmem.membership_at(sched, 10, 3).active.all()


def test_a_worker_out_of_range_raises():
    sched = tmem.get_fault_schedule("churn", 10)      # names workers 0..9
    with pytest.raises(ValueError, match="names worker 9.*W=8"):
        tmem.membership_at(sched, 0, 8)
    with pytest.raises(ValueError, match="names worker 9.*W=8"):
        jmem.membership_at(jmem.get_fault_schedule("churn", 10), 0, 8)


def test_bad_events_and_names_raise():
    with pytest.raises(ValueError, match="unknown fault kind"):
        tmem.FaultEvent("melt", 0, 1)
    with pytest.raises(ValueError, match="bad interval"):
        tmem.FaultEvent("leave", 0, 5, 5)
    with pytest.raises(ValueError, match="bad worker"):
        tmem.FaultEvent("leave", -1, 0)
    with pytest.raises(KeyError, match="unknown fault scenario"):
        tmem.get_fault_schedule("meteor", W)
    assert sorted(tmem.FAULTS) == sorted(jmem.FAULTS)
