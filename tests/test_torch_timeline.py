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
from repro_torch.core.allocation import StepAllocation


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
