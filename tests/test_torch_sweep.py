"""The sweep program of ``repro_torch.sim.device_timeline`` against the
reference's ``sweep_schedule``, given the same lanes (attempt rows from the
reference's ``_policy_rows``, and synthetic rows), and its timeline-axis
bookkeeping: the overflow re-dispatch, dead lanes and the axis hint.

Tolerance: none.  Nodes, starts, pops, waits, dead flags and the
compaction statistics must be identical."""

import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest

from repro.sim import device_timeline as ref_dt
from repro.sim.cluster import _eligible_queue as ref_queue
from repro.sim.cluster import _policy_rows as ref_policy_rows
from repro.sim.traces import generate_workflow as ref_workflow
from repro_torch.core.ksegments import KSegmentsConfig
from repro_torch.sim import device_timeline as dt
from repro_torch.sim.batch_engine import compute_cluster_ladders
from repro_torch.sim.cluster import _eligible_queue
from repro_torch.sim.traces import generate_workflow

POLICIES = ("default", "witt-lr", "ksegments-selective")
NODE_MIB = 24 * 1024.0
BUDGET = NODE_MIB + 1e-6


@pytest.fixture(scope="module")
def rows():
    """Each policy's attempt rows of a congested eager corpus (the
    reference's ``_policy_rows`` over ladders the port recorded)."""
    queue, _ = ref_queue([ref_workflow("eager", seed=7, scale=0.25)], 0.5, 25, 6)
    _, traces = _eligible_queue([generate_workflow("eager", seed=7, scale=0.25)], 0.5, 25, 6)
    trunc = [dataclasses.replace(t, executions=t.executions[: n + 25]) for t, n in traces]
    lad = compute_cluster_ladders(trunc, POLICIES, NODE_MIB, KSegmentsConfig(error_mode="progressive"), 32,
                                  device="cpu")
    return {p: ref_policy_rows(lad, queue, p)[:4] for p in POLICIES}


@pytest.fixture
def x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def _lane(r, seed, k=2):
    """Synthetic attempt rows in the sweep's lane layout."""
    rng = np.random.default_rng(seed)
    bnd = np.stack([rng.uniform(1.0, 2.0, r), np.full(r, np.inf)], axis=1)
    val = rng.uniform(50.0, 200.0, (r, k))
    run = rng.uniform(2.0, 4.0, r)
    return bnd, val, run, run


@pytest.fixture
def fresh_hints():
    saved_ref, saved = dict(ref_dt._SWEEP_L_HINT), dict(dt._SWEEP_L_HINT)
    ref_dt._SWEEP_L_HINT.clear()
    dt._SWEEP_L_HINT.clear()
    yield
    for d, s in ((ref_dt._SWEEP_L_HINT, saved_ref), (dt._SWEEP_L_HINT, saved)):
        d.clear()
        d.update(s)


def _assert_sweeps_equal(got, want, lane_rows):
    np.testing.assert_array_equal(got[4], want[4])  # dead
    for s, (b, _, _, _) in enumerate(lane_rows):
        if not want[4][s]:
            r = b.shape[0]
            np.testing.assert_array_equal(got[0][s, :r], want[0][s, :r])
            np.testing.assert_array_equal(got[1][s, :r], want[1][s, :r])
    np.testing.assert_array_equal(got[2][~want[4]], want[2][~want[4]])  # pops
    np.testing.assert_array_equal(got[3], want[3])  # waited


def test_sweep_schedule_matches_reference(x64, rows, fresh_hints):
    """Policies as lanes with unequal node counts: one program call, waits
    resolved in the program, compaction statistics identical."""
    lane_rows = [rows[p] for p in POLICIES] + [rows["default"]]
    nodes = [2, 2, 2, 1]
    budgets = [BUDGET] * 4
    st_ref, st = {}, {}
    want = ref_dt.sweep_schedule(lane_rows, nodes, budgets, stats=st_ref)
    got = dt.sweep_schedule(lane_rows, nodes, budgets, stats=st, device="cpu")
    _assert_sweeps_equal(got, want, lane_rows)
    assert st["waits_program"] == st_ref["waits_program"] > 5
    assert (st["program_calls"], st["carried_hw"], st["timeline_axis"]) == \
        (st_ref["program_calls"], st_ref["carried_hw"], st_ref["timeline_axis"])


def test_sweep_overflow_dead_lane_matches_reference(x64, fresh_hints):
    """A lane whose events outgrow the axis at its cap is dead; the shallow
    lane's placements stand."""
    lanes = [_lane(60, 0), _lane(6, 1)]
    nodes, budgets = [1, 1], [50_000.0, 50_000.0]
    st_ref, st = {}, {}
    want = ref_dt.sweep_schedule(lanes, nodes, budgets, timeline_floor=16, timeline_cap=32, stats=st_ref)
    got = dt.sweep_schedule(lanes, nodes, budgets, timeline_floor=16, timeline_cap=32, stats=st, device="cpu")
    _assert_sweeps_equal(got, want, lanes)
    assert (st["program_calls"], st["timeline_axis"], st["carried_hw"]) == \
        (st_ref["program_calls"], st_ref["timeline_axis"], st_ref["carried_hw"])
    assert bool(got[4][0]) and not bool(got[4][1])


@pytest.mark.parametrize("r", [60, 70])
def test_sweep_carried_hw_matches_reference(x64, fresh_hints, r):
    """Rows that all place at the clock: the carried events grow to the
    last row.  The reference folds at every chunk boundary of its padded
    row bucket: none past 60 rows (bucket 64), one past 70 (bucket 80)."""
    lanes = [_lane(r, 2), _lane(r - 4, 3)]
    nodes, budgets = [1, 1], [50_000.0, 50_000.0]
    st_ref, st = {}, {}
    want = ref_dt.sweep_schedule(lanes, nodes, budgets, stats=st_ref)
    got = dt.sweep_schedule(lanes, nodes, budgets, stats=st, device="cpu")
    _assert_sweeps_equal(got, want, lanes)
    assert (st["program_calls"], st["timeline_axis"], st["carried_hw"]) == \
        (st_ref["program_calls"], st_ref["timeline_axis"], st_ref["carried_hw"])


def test_sweep_overflow_redispatches_with_the_axis_doubled(fresh_hints):
    """From an axis far below the carried events the grid runs again with
    the axis doubled until nothing overflows, and places exactly as a run
    that started large enough."""
    lanes = [_lane(60, 0), _lane(6, 1)]
    nodes, budgets = [1, 1], [50_000.0, 50_000.0]
    st_big, st = {}, {}
    want = dt.sweep_schedule(lanes, nodes, budgets, stats=st_big, device="cpu")
    dt._SWEEP_L_HINT.clear()
    got = dt.sweep_schedule(lanes, nodes, budgets, timeline_floor=16, stats=st, device="cpu")
    assert st_big["program_calls"] == 1 and st["program_calls"] == 3  # 32, 64, 128
    assert st["timeline_axis"] == 128
    _assert_sweeps_equal(got, want, lanes)
    assert not got[4].any()


def test_row_bucket_and_axis_hint_match_reference(fresh_hints):
    for n in list(range(1, 300)) + [1057, 1900, 5000]:
        assert dt._row_bucket(n) == ref_dt._row_bucket(n)
    for shape in ((4, 1900, 4, 16), (4, 100, 4, 2), (2, 20000, 15, 8)):
        assert dt.sweep_axis_hint(*shape) == ref_dt.sweep_axis_hint(*shape)
    for i in range(dt._SWEEP_L_HINT_CAP + 10):
        dt._hint_put(("grid", i), 256)
    assert len(dt._SWEEP_L_HINT) == dt._SWEEP_L_HINT_CAP
    assert dt._hint_get(("grid", 0)) == 0  # the oldest was evicted
    assert dt._hint_get(("grid", 10)) == 256  # a read refreshes recency ...
    dt._hint_put(("grid", "fresh"), 512)
    assert dt._hint_get(("grid", 10)) == 256
    assert dt._hint_get(("grid", 11)) == 0  # ... so the next oldest went
