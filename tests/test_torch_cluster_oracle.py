"""The port's sequential cluster oracle (``repro_torch.sim.cluster.
run_cluster``) against the reference's ``run_cluster`` (pure numpy: it runs
no float64 device program), and against the port's own
``run_cluster_batched`` as the reference's
``tests/test_cluster_batch.py::test_per_task_parity`` holds its pair.

The corpus (scale 0.2 on 2 nodes, 10 executions of each type) makes tasks
wait for a node and retry after OOM kills, so placements, waits and retry
ladders are all exercised; the batched parity also runs on the reference
test's own corpus and settings.  Oracle against oracle: every attempt's
``(node, start, end)``, wastage, makespan and retries exact.  Oracle against
the batched path: placements, makespans and retries exact, wastage within
rtol 1e-3 (the batched ladders run in float32, as in the reference's test).
"""

import numpy as np
import pytest

from repro.core.allocation import StepAllocation as RefStepAllocation
from repro.core.ksegments import KSegmentsConfig as RefKConfig
from repro.sim import generate_suite as ref_generate_suite
from repro.sim.cluster import NodeState as RefNodeState
from repro.sim.cluster import run_cluster as ref_run_cluster
from repro_torch.core.allocation import StepAllocation
from repro_torch.core.ksegments import KSegmentsConfig
from repro_torch.core.predictor import METHODS
from repro_torch.sim import generate_eager, generate_suite
from repro_torch.sim.cluster import NodeState, run_cluster, run_cluster_batched

KW = dict(n_nodes=2, max_tasks_per_type=10, min_executions=10)
BATCHED_POLICIES = ("default", "ppm-improved", "ksegments-selective")
FRACS = (0.25, 0.5)


@pytest.fixture(scope="module")
def corpora():
    return generate_suite(seed=0, scale=0.2), ref_generate_suite(seed=0, scale=0.2)


def _assert_same(got, want, exact_wastage=True):
    assert got.tasks_run == want.tasks_run == len(got.records) > 0
    assert got.retries == want.retries
    assert got.makespan_s == want.makespan_s
    for a, b in zip(got.records, want.records):
        assert (a.workflow, a.task, a.exec_index, a.attempts) == (b.workflow, b.task, b.exec_index, b.attempts)
        assert a.placements == b.placements
        if exact_wastage:
            assert a.wastage_gib_s == b.wastage_gib_s
        else:
            np.testing.assert_allclose(a.wastage_gib_s, b.wastage_gib_s, rtol=1e-3, atol=1e-6)
    if exact_wastage:
        assert got.wastage_gib_s == want.wastage_gib_s
    else:
        np.testing.assert_allclose(got.wastage_gib_s, want.wastage_gib_s, rtol=1e-3)


@pytest.mark.parametrize("policy", METHODS)
@pytest.mark.parametrize("mode", ["progressive", "insample"])
def test_run_cluster_matches_reference(corpora, policy, mode):
    wfs, ref_wfs = corpora
    got = run_cluster(wfs, policy, ksegments_config=KSegmentsConfig(error_mode=mode), **KW)
    want = ref_run_cluster(ref_wfs, policy, ksegments_config=RefKConfig(error_mode=mode), **KW)
    _assert_same(got, want)


def test_corpus_waits_and_retries(corpora):
    res = run_cluster(corpora[0], "ppm", **KW)
    assert res.retries > 0
    assert sum(1 for r in res.records for _, start, _ in r.placements if start > 0) > 0


# the reference test's corpus and settings (tests/test_cluster_batch.py), and this file's
PARITY_CASES = {
    "reference": (lambda: [generate_eager(seed=9, scale=0.12)], dict(n_nodes=3, max_tasks_per_type=15,
                                                                   min_executions=10)),
    "waits": (lambda: generate_suite(seed=0, scale=0.2), KW),
}


@pytest.fixture(scope="module")
def batched():
    out = {}
    for case, (make, kw) in PARITY_CASES.items():
        wfs = make()
        for frac in FRACS:
            out[(case, frac)] = (wfs, run_cluster_batched(wfs, BATCHED_POLICIES, train_frac=frac, device="cpu", **kw))
    return out


@pytest.mark.parametrize("case", sorted(PARITY_CASES))
@pytest.mark.parametrize("policy", BATCHED_POLICIES)
@pytest.mark.parametrize("frac", FRACS)
def test_per_task_parity_with_batched(batched, case, policy, frac):
    wfs, res = batched[(case, frac)]
    seq = run_cluster(wfs, policy, train_frac=frac, ksegments_config=KSegmentsConfig(error_mode="progressive"),
                      **PARITY_CASES[case][1])
    _assert_same(res[policy], seq, exact_wastage=False)


def test_makespan_covers_every_finish(corpora):
    res = run_cluster(corpora[0], "ksegments-selective", **KW)
    for rec in res.records:
        for _node, _start, end in rec.placements:
            assert res.makespan_s >= end


def test_node_fits_profile_as_reference():
    """The reference's NodeState case, on both, with direct mutation of ``active``."""
    for node_cls, alloc_cls in ((NodeState, StepAllocation), (RefNodeState, RefStepAllocation)):
        nd = node_cls(capacity_mib=1000.0)
        a1 = alloc_cls(np.asarray([10.0, 20.0]), np.asarray([400.0, 800.0]))
        assert nd.fits(a1, 0.0, 20.0)
        nd.active.append((20.0, a1, 0.0))
        assert nd.fits(alloc_cls(np.asarray([5.0]), np.asarray([300.0])), 0.0, 5.0)
        assert not nd.fits(alloc_cls(np.asarray([15.0]), np.asarray([300.0])), 0.0, 15.0)
        assert nd.reserved_at(15.0) == 800.0
        nd.expire(20.0)
        assert nd.active == [] and nd.reserved_at(15.0) == 0.0
