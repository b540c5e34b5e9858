"""The sweep engine of the port's cluster scheduler against the reference's:
``run_cluster_batched(placement="sweep")`` with every policy as a lane, and
``run_cluster_sweep`` over a (policy x node count) design space with its
``pareto_frontier``.

Tolerances: as tests/test_torch_cluster.py -- placements, attempts,
retries, makespans and counters exact, wastage rtol 1e-5."""

import jax
import jax.experimental
import numpy as np
import pytest

from repro.sim.cluster import pareto_frontier as ref_pareto
from repro.sim.cluster import run_cluster_batched as ref_run
from repro.sim.cluster import run_cluster_sweep as ref_sweep
from repro.sim.traces import generate_workflow as ref_workflow
from repro_torch.sim.cluster import pareto_frontier, run_cluster_batched, run_cluster_sweep
from repro_torch.sim.traces import generate_workflow
from test_torch_cluster import CONGESTED, POLICIES, assert_results_match

GRID = {k: v for k, v in CONGESTED.items() if k != "n_nodes"}


@pytest.fixture
def x64(monkeypatch):
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def test_sweep_placement_matches_reference(x64):
    st_ref, st = {}, {}
    want = ref_run([ref_workflow("eager", seed=7, scale=0.25)], POLICIES, placement="sweep",
                   placement_stats=st_ref, **CONGESTED)
    wfs = [generate_workflow("eager", seed=7, scale=0.25)]
    got = run_cluster_batched(wfs, POLICIES, placement="sweep", placement_stats=st, device="cpu", **CONGESTED)
    for p in POLICIES:
        assert_results_match(got[p], want[p])
    for key in ("program_calls", "waits_program", "waits_host", "rows", "carried_hw", "timeline_axis"):
        assert st[key] == st_ref[key], key
    assert st["program_calls"] == 1 and st["waits_program"] > 5
    # the port's two engines agree with each other exactly, wastage included
    windows = run_cluster_batched(wfs, POLICIES, placement="windows", device="cpu", **CONGESTED)
    for p in POLICIES:
        assert_results_match(got[p], windows[p], rtol=0.0)


def test_run_cluster_sweep_and_pareto_match_reference(x64):
    st_ref, st = {}, {}
    want = ref_sweep({"eager": [ref_workflow("eager", seed=7, scale=0.25)]}, POLICIES, node_counts=(2,),
                     placement_stats=st_ref, **GRID)
    got = run_cluster_sweep({"eager": [generate_workflow("eager", seed=7, scale=0.25)]}, POLICIES,
                            node_counts=(2,), placement_stats=st, device="cpu", **GRID)
    assert list(got) == list(want) == [("eager", p, 2) for p in POLICIES]
    for key, w in want.items():
        assert_results_match(got[key], w)
    assert (st["program_calls"], st["waits_program"], st["carried_hw"]) == \
        (st_ref["program_calls"], st_ref["waits_program"], st_ref["carried_hw"])
    np.testing.assert_array_equal(
        pareto_frontier([(r.makespan_s, r.wastage_gib_s) for r in got.values()]),
        ref_pareto([(r.makespan_s, r.wastage_gib_s) for r in want.values()]),
    )


def test_run_cluster_sweep_masks_unequal_node_counts():
    """Lanes with 1, 2 and 3 nodes in one program: each lane places exactly
    as the windows engine does at its node count (which the reference
    holds, tests/test_torch_cluster.py)."""
    wfs = [generate_workflow("eager", seed=7, scale=0.25)]
    node_counts = (1, 2, 3)
    st: dict = {}
    got = run_cluster_sweep(wfs, POLICIES, node_counts=node_counts, placement_stats=st, device="cpu", **GRID)
    assert st["program_calls"] == 1 and st["waits_host"] == 0
    for nn in node_counts:
        windows = run_cluster_batched(wfs, POLICIES, n_nodes=nn, placement="windows", device="cpu", **GRID)
        for p in POLICIES:
            assert_results_match(got[("", p, nn)], windows[p], rtol=0.0)
    for p in POLICIES:  # more nodes never lengthen the makespan on the same rows
        spans = [got[("", p, nn)].makespan_s for nn in node_counts]
        assert spans == sorted(spans, reverse=True)


def test_pareto_frontier_matches_reference():
    rng = np.random.default_rng(0)
    pts = np.round(rng.random((40, 3)) * 5)  # many ties and duplicates
    np.testing.assert_array_equal(pareto_frontier(pts), ref_pareto(pts))
    assert pareto_frontier([(1.0, 1.0), (1.0, 1.0)]).tolist() == [True, True]
    with pytest.raises(ValueError, match="2-D"):
        pareto_frontier([1.0, 2.0])
