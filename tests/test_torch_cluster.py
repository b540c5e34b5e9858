"""``run_cluster_batched`` of the port against the reference's on the same
seeded congested corpus, with the windows engine and the ``auto`` router.
(The sweep engine and ``run_cluster_sweep``: tests/test_torch_cluster_sweep.py.)

Tolerances: per attempt (node, start, end), attempts, retries, makespan
and the wait counters exact; wastage rtol 1e-5, because float32 ladder
values agree with the reference's to ~1e-7 relative (XLA fuses
multiply-adds) and their float64 sums run in another order."""

import jax
import jax.experimental
import numpy as np
import pytest

from repro.sim.cluster import run_cluster_batched as ref_run
from repro.sim.traces import generate_workflow as ref_workflow
from repro_torch.sim.cluster import run_cluster_batched
from repro_torch.sim.traces import generate_workflow

POLICIES = ("default", "ksegments-selective")
CONGESTED = dict(n_nodes=2, node_mib=24 * 1024.0, max_tasks_per_type=8, min_executions=6, train_frac=0.5)


def assert_results_match(got, want, rtol=1e-5):
    assert got.policy == want.policy
    assert got.tasks_run == want.tasks_run > 0
    assert got.retries == want.retries
    assert got.makespan_s == want.makespan_s
    np.testing.assert_allclose(got.wastage_gib_s, want.wastage_gib_s, rtol=rtol)
    for g, w in zip(got.records, want.records, strict=True):
        assert (g.workflow, g.task, g.exec_index, g.attempts) == (w.workflow, w.task, w.exec_index, w.attempts)
        assert g.placements == w.placements  # exact (node, start, end) per attempt
        np.testing.assert_allclose(g.wastage_gib_s, w.wastage_gib_s, rtol=rtol, atol=1e-9)


@pytest.fixture(scope="module")
def reference():
    mp = pytest.MonkeyPatch()
    mp.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    try:
        stats: dict = {}
        res = ref_run([ref_workflow("eager", seed=7, scale=0.25)], POLICIES, placement="windows",
                      placement_stats=stats, **CONGESTED)
        yield res, stats
    finally:
        mp.undo()


@pytest.mark.parametrize("placement", ["windows", "auto"])
def test_run_cluster_batched_matches_reference(reference, placement):
    want, want_stats = reference
    stats: dict = {}
    got = run_cluster_batched([generate_workflow("eager", seed=7, scale=0.25)], POLICIES, placement=placement,
                              placement_stats=stats, device="cpu", **CONGESTED)
    assert list(got) == list(want)
    for p in POLICIES:
        assert_results_match(got[p], want[p])
    assert stats["waits_host"] == 0
    assert stats["waits_program"] == want_stats["waits_program"] > 5
    assert stats["rows"] == want_stats["rows"]
    if placement == "windows":
        assert stats["program_calls"] == want_stats["program_calls"]


def test_windows_engine_finishes_every_attempt_after_its_start(reference):
    want, _ = reference
    got = run_cluster_batched([generate_workflow("eager", seed=7, scale=0.25)], POLICIES, placement="windows",
                              device="cpu", **CONGESTED)
    for p in POLICIES:
        ends = [e for r in got[p].records for _, s, e in r.placements if e > s]
        assert got[p].makespan_s == max(ends) == max(r.finish_s for r in got[p].records)
        assert all(0 <= n < CONGESTED["n_nodes"] for r in got[p].records for n, _, _ in r.placements)


def test_unknown_placement_and_unbounded_insample_raise():
    from repro_torch.core.ksegments import KSegmentsConfig

    wfs = [generate_workflow("eager", seed=7, scale=0.1)]
    with pytest.raises(ValueError, match="unknown placement engine"):
        run_cluster_batched(wfs, POLICIES, placement="fastest", device="cpu")
    with pytest.raises(ValueError, match="insample_window"):
        run_cluster_batched(wfs, POLICIES, ksegments_config=KSegmentsConfig(error_mode="insample"), device="cpu")
