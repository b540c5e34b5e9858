"""The port's event timeline (``repro_torch.core.timeline``) against the
reference's (``repro.core.timeline``): the same seeded sequences of add /
add_many / expire / remove, and the same probes.

Tolerance: none.  Event order (time ties included), the cumulative profile
and every probe decision must be bit-identical, because the device
programs seed their carried timelines from ``events()``."""

import numpy as np
import pytest

from repro.core import timeline as ref_tl
from repro.core.allocation import StepAllocation as RefAlloc
from repro_torch.core import timeline as tl
from repro_torch.core.allocation import StepAllocation, pack_step_allocations


def _reservation(rng, k: int, t0: float):
    """A node-capped step schedule starting at a dyadic-ish instant."""
    b = np.sort(np.round(rng.uniform(0.5, 60.0, k), 1))
    if rng.random() < 0.3:
        b[-1] = np.inf  # a k = 1 baseline's hold-last row
    v = np.sort(np.round(rng.uniform(100.0, 4000.0, k), 1))
    start = t0 + float(rng.integers(0, 8)) * 2.0
    release = start + float(rng.choice([b[0], 10.0, 30.0, 70.0]))  # a release on a boundary ties
    return b, v, start, release


def _drive(seed: int, k: int):
    """Apply one seeded op sequence to both timelines, yielding after each op."""
    rng = np.random.default_rng(seed)
    ref, got = ref_tl.Timeline(), tl.Timeline()
    owner, now = 0, 0.0
    for step in range(40):
        op = rng.choice(["add", "add_many", "expire", "remove"], p=[0.4, 0.3, 0.2, 0.1])
        if op == "add":
            b, v, s, r = _reservation(rng, k, now)
            ref.add(owner, b, v, s, r)
            got.add(owner, b, v, s, r)
            owner += 1
        elif op == "add_many":
            n = int(rng.integers(1, 6))
            rows = [_reservation(rng, k, now) for _ in range(n)]
            b, v = np.stack([x[0] for x in rows]), np.stack([x[1] for x in rows])
            s, r = np.asarray([x[2] for x in rows]), np.asarray([x[3] for x in rows])
            ref.add_many(range(owner, owner + n), b, v, s, r)
            got.add_many(range(owner, owner + n), b, v, s, r)
            owner += n
        elif op == "expire":
            now += float(rng.integers(0, 20))
            ref.expire(now)
            got.expire(now)
        else:
            victim = int(rng.integers(0, max(owner, 1)))
            ref.remove(victim)
            got.remove(victim)
        yield rng, ref, got, now


@pytest.mark.parametrize("seed,k", [(0, 1), (1, 4), (2, 4), (3, 15)])
def test_timeline_ops_bit_identical(seed, k):
    for _, ref, got, _ in _drive(seed, k):
        for a, b in zip(got.events(), ref.events()):
            np.testing.assert_array_equal(a, b)
        for a, b in zip(got.arrays(), ref.arrays()):
            np.testing.assert_array_equal(a, b)
        assert (got.n_events, got.n_owners) == (ref.n_events, ref.n_owners)


@pytest.mark.parametrize("seed,k", [(4, 1), (5, 4), (6, 15)])
def test_probes_bit_identical(seed, k):
    for rng, ref, got, now in _drive(seed, k):
        b, v, _, _ = _reservation(rng, k, now)
        starts = now + np.concatenate([rng.uniform(0.0, 80.0, 6), got.events()[0][:4] - now])
        budget = float(rng.uniform(2000.0, 12000.0))
        for start in starts:
            for end in (start + 5.0, start + float(b[0]), start + 90.0):
                for inclusive in (False, True):
                    assert got.demand_exceeds(StepAllocation(b, v), start, end, budget, inclusive_end=inclusive) == \
                        ref.demand_exceeds(RefAlloc(b, v), start, end, budget, inclusive_end=inclusive)
        np.testing.assert_array_equal(
            got.demand_exceeds_many(StepAllocation(b, v), starts, 40.0, budget),
            ref.demand_exceeds_many(RefAlloc(b, v), starts, 40.0, budget),
        )
        np.testing.assert_array_equal(got.demand_at(starts), ref.demand_at(starts))


def test_profile_helpers_bit_identical():
    rng = np.random.default_rng(9)
    R, kmax = 12, 4
    bnd = np.sort(rng.uniform(1.0, 50.0, (R, kmax)), axis=1)
    bnd[::3, 2:] = np.inf
    val = np.sort(rng.uniform(100.0, 900.0, (R, kmax + 1)), axis=1)
    starts = np.round(rng.uniform(0.0, 40.0, R))
    rels = starts + np.round(rng.uniform(1.0, 60.0, R))
    for a, b in zip(tl.step_demand_profile(bnd, val, starts, rels), ref_tl.step_demand_profile(bnd, val, starts, rels)):
        np.testing.assert_array_equal(a, b)
    for r in range(R):
        for a, b in zip(tl.plan_profile_events(bnd[r], val[r, :kmax], starts[r], rels[r]),
                        ref_tl.plan_profile_events(bnd[r], val[r, :kmax], starts[r], rels[r])):
            np.testing.assert_array_equal(a, b)
    parts = (starts, rels, np.nextafter(starts[:, None] + bnd, np.inf).ravel())
    for a, b in zip(tl.shared_probe_set(*parts, return_inverse=True), ref_tl.shared_probe_set(*parts, return_inverse=True)):
        np.testing.assert_array_equal(a, b)


def test_step_allocation_matches_reference():
    rng = np.random.default_rng(3)
    b = np.sort(rng.uniform(1.0, 20.0, 4))
    v = np.sort(rng.uniform(100.0, 900.0, 4))
    t = np.concatenate([b, np.nextafter(b, np.inf), rng.uniform(0.0, 30.0, 20)])
    np.testing.assert_array_equal(StepAllocation(b, v).at(t), RefAlloc(b, v).at(t))
    assert [StepAllocation(b, v).segment_of(x) for x in t] == [RefAlloc(b, v).segment_of(x) for x in t]


# Seed 949456516 of tests/test_demand_oracle.py::_check_demand_exceeds_matches_oracle,
# a fault the port shares with the reference (ROADMAP Queue 3).
DEMAND_SEED = 949456516


def _oracle_plan(rng):
    """The draws of tests/test_demand_oracle.py:_random_plan, in its order."""
    k = int(rng.integers(1, 6))
    bounds = np.sort(rng.uniform(0.5, 50.0, k))
    values = np.maximum.accumulate(rng.uniform(10.0, 500.0, k))
    start = float(rng.uniform(0.0, 100.0))
    return bounds, values, start, float(np.nextafter(start + bounds[-1], np.inf))


def _naive_value(b, v, start, t):
    """Eq. (1) by hand: segment s + 1 holds from nextafter(start + b_s) on."""
    return float(v[sum(t >= np.nextafter(start + x, np.inf) for x in b[:-1])])


def test_demand_exceeds_misses_a_step_up_as_the_reference_does():
    """The probe ``demand_exceeds`` places at the candidate's step-up,
    ``p = nextafter(start + b)``, reads the candidate at ``p - start``,
    which rounds back to exactly ``b``; ``StepAllocation.at`` is
    left-closed there, so the probe sees the lower segment and misses a
    demand peak held for 1.6 s.  Port and reference answer alike ("fits"
    at the naive peak's (1 - 1e-6)); the fix changes both, so it waits."""
    rng = np.random.default_rng(DEMAND_SEED)
    plans = [_oracle_plan(rng) for _ in range(int(rng.integers(1, 7)))]
    b, v, start, _ = _oracle_plan(rng)
    end = start + float(b[-1])
    allocs = [StepAllocation(pb, pv) for pb, pv, _, _ in plans]
    bnd, val = pack_step_allocations(allocs)
    starts, rels = np.asarray([p[2] for p in plans]), np.asarray([p[3] for p in plans])
    times, cum = tl.step_demand_profile(bnd, val, starts, rels)
    ref_times, ref_cum = ref_tl.step_demand_profile(bnd, val, starts, rels)
    cand, ref_cand = StepAllocation(b, v), RefAlloc(b, v)

    # the naive peak over every instant the demand can step at
    events = np.concatenate([starts, np.nextafter(starts[:, None] + bnd, np.inf).ravel(), rels,
                             [start, end], np.nextafter(start + b, np.inf)])
    events = events[(events >= start) & (events <= end)]

    def naive(t):
        live = sum(_naive_value(pb, pv, s, t) for pb, pv, s, r in plans if s <= t < r)
        return live + _naive_value(b, v, start, t)

    peak = max(naive(t) for t in events)
    assert peak == pytest.approx(901.1074, abs=1e-4)
    for budget in (peak * (1 + 1e-6), peak * (1 - 1e-6)):
        got = tl.demand_exceeds(times, cum, cand, start, end, budget, inclusive_end=True)
        assert got is ref_tl.demand_exceeds(ref_times, ref_cum, ref_cand, start, end, budget, inclusive_end=True)
        assert got is False  # "fits", also where the naive window exceeds the budget

    # the cause, at the candidate's third boundary
    p = np.nextafter(start + b[2], np.inf)
    assert p - start == b[2]
    assert cand.at(p - start) == pytest.approx(344.43, abs=5e-3) == ref_cand.at(p - start)
    assert _naive_value(b, v, start, p) == pytest.approx(479.18, abs=5e-3)

    # demand_exceeds' own readings over its probe set
    probes = np.concatenate([[start], np.nextafter(start + b[b < end - start], np.inf)])
    probes = probes[probes <= end]
    lo, hi = np.searchsorted(times, start, side="right"), np.searchsorted(times, end, side="right")
    t_all = np.concatenate([probes, times[lo:hi]])
    reading = cum[np.searchsorted(times, t_all, side="right")] + cand.at(t_all - start)
    assert reading.max() == pytest.approx(766.36, abs=5e-3)
    assert peak - reading.max() > 0.15 * reading.max()
