"""The placement programs of ``repro_torch.sim.device_timeline`` against the
reference's (``repro.sim.device_timeline``), given the same inputs: attempt
rows from the reference's ``_policy_rows`` (over ladders that the port's
engine recorded: the rows are inputs here, whatever made them), and node
timelines filled with some of those rows.

Tolerance: none.  Placed, node, start, clock, pops, waits, dead and
overflow flags, and the sweep's compaction statistics must be identical:
every decision is a comparison of exactly computed float64 values."""

import dataclasses

import jax
import jax.experimental
import numpy as np
import pytest

from repro.core.timeline import Timeline as RefTimeline
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
    """Each policy's attempt rows of a congested eager corpus."""
    queue, _ = ref_queue([ref_workflow("eager", seed=7, scale=0.25)], 0.5, 25, 6)
    _, traces = _eligible_queue([generate_workflow("eager", seed=7, scale=0.25)], 0.5, 25, 6)
    trunc = [dataclasses.replace(t, executions=t.executions[: n + 25]) for t, n in traces]
    lad = compute_cluster_ladders(trunc, POLICIES, NODE_MIB, KSegmentsConfig(error_mode="progressive"), 32,
                                  device="cpu")
    return {p: ref_policy_rows(lad, queue, p)[:4] for p in POLICIES}


@pytest.fixture
def x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def _filled_nodes(bnd, val, run, n_nodes, n_rows, seed):
    """Timelines with ``n_rows`` reservations spread over the nodes at
    dyadic starts, and their release instants (the pending heap)."""
    rng = np.random.default_rng(seed)
    profs = [RefTimeline() for _ in range(n_nodes)]
    rels = []
    for r in range(n_rows):
        start = float(rng.integers(0, 40)) * 2.0
        profs[r % n_nodes].add(r, bnd[r], val[r], start, start + run[r])
        rels.append(start + run[r])
    return profs, np.asarray(rels)


@pytest.mark.parametrize("policy,n_nodes,n_fill,now", [
    ("default", 2, 6, 20.0),
    ("witt-lr", 3, 12, 40.0),
    ("ksegments-selective", 8, 40, 30.0),  # many nodes with many events: the reference's per-node program
    ("ksegments-selective", 1, 0, 0.0),  # an empty node
])
def test_first_fit_window_matches_reference(x64, rows, policy, n_nodes, n_fill, now):
    bnd, val, run, probe = rows[policy]
    profs, _ = _filled_nodes(bnd, val, run, n_nodes, n_fill, seed=n_fill)
    for p in profs:
        p.expire(now)
    arrays = [p.arrays() for p in profs]
    w = 32
    sl = slice(n_fill, n_fill + w)
    args = (now, bnd[sl], val[sl], run[sl], probe[sl], arrays, BUDGET)
    want_placed, want_node = ref_dt.first_fit_window(*args, w)
    got_placed, got_node = dt.first_fit_window(*args, device="cpu")
    np.testing.assert_array_equal(got_placed, want_placed)
    n = int(want_placed.sum())
    np.testing.assert_array_equal(got_node[:n], want_node[:n])


def test_first_fit_window_blocks_like_reference(x64, rows):
    """A tight budget: some rows of the window fit no node and block the
    rest, at the same row as the reference."""
    bnd, val, run, probe = rows["ksegments-selective"]
    profs, _ = _filled_nodes(bnd, val, run, 4, 20, seed=1)
    now = 24.0
    for p in profs:
        p.expire(now)
    w = 24
    sl = slice(20, 20 + w)
    args = (now, bnd[sl], val[sl], run[sl], probe[sl], [p.arrays() for p in profs], 12 * 1024.0 + 1e-6)
    want_placed, want_node = ref_dt.first_fit_window(*args, w)
    got_placed, got_node = dt.first_fit_window(*args, device="cpu")
    np.testing.assert_array_equal(got_placed, want_placed)
    n = int(want_placed.sum())
    assert 0 < n < w
    np.testing.assert_array_equal(got_node[:n], want_node[:n])


@pytest.mark.parametrize("policy,n_nodes,n_fill,now,w,bucket", [
    ("default", 2, 10, 20.0, 8, 8),  # congested: rows wait in the program
    ("ksegments-selective", 3, 40, 20.0, 8, 8),
    ("witt-lr", 1, 0, 0.0, 12, 16),  # one empty node, 12 rows: the 9th aborts on the commit cap
])
def test_schedule_epoch_matches_reference(x64, rows, policy, n_nodes, n_fill, now, w, bucket):
    bnd, val, run, probe = rows[policy]
    profs, rels = _filled_nodes(bnd, val, run, n_nodes, n_fill, seed=n_fill + 1)
    for p in profs:
        p.expire(now)
    pending = rels[rels > now]
    sl = slice(n_fill, n_fill + w)
    args = (now, bnd[sl], val[sl], run[sl], [p.events() for p in profs], pending, BUDGET, bucket)
    want = ref_dt.schedule_epoch(*args, probe_times=probe[sl])
    got = dt.schedule_epoch(*args, probe_times=probe[sl], device="cpu")
    np.testing.assert_array_equal(got[0], want[0])  # placed
    n = int(want[0].sum())
    np.testing.assert_array_equal(got[1][:n], want[1][:n])  # node
    np.testing.assert_array_equal(got[2][:n], want[2][:n])  # start
    assert got[3:] == want[3:]  # clock, pops, waited, dead
    if n_fill:
        assert want[5] > 0  # rows waited in the program
    else:
        assert n == 8  # the commit cap


def test_schedule_epoch_dead_heap_matches_reference(x64, rows):
    """A row larger than the node with nothing pending drains the heap."""
    bnd, val, run, probe = rows["default"]
    sl = slice(0, 4)
    args = (0.0, bnd[sl], val[sl] * 100.0, run[sl], [RefTimeline().events()], np.zeros(0), BUDGET, 8)
    want = ref_dt.schedule_epoch(*args, probe_times=probe[sl])
    got = dt.schedule_epoch(*args, probe_times=probe[sl], device="cpu")
    np.testing.assert_array_equal(got[0], want[0])
    assert got[3:] == want[3:] and want[6]
