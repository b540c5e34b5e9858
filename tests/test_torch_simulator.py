"""The port's sequential oracle, baselines and predictor service against the
reference (``repro.sim.simulator``, ``repro.core.{allocation,baselines,
sizey,predictor}``).  Both sides run float64 numpy on the same inputs, so
every result must be exactly equal."""

import dataclasses

import numpy as np
import pytest

from repro.core import allocation as ref_alloc
from repro.core.baselines import make_baseline as ref_make_baseline
from repro.core.ksegments import KSegmentsConfig as RefKConfig
from repro.core.predictor import METHODS as REF_METHODS
from repro.core.predictor import MemoryPredictorService as RefService
from repro.sim import generate_suite as ref_generate_suite
from repro.sim import simulate_suite as ref_simulate_suite
from repro.sim.simulator import SimConfig as RefSimConfig
from repro.sim.simulator import trace_features as ref_trace_features
from repro_torch.core import allocation
from repro_torch.core.baselines import make_baseline
from repro_torch.core.ksegments import KSegmentsConfig
from repro_torch.core.predictor import METHODS, MemoryPredictorService
from repro_torch.sim import generate_suite, simulate_suite
from repro_torch.sim.simulator import SimConfig, trace_features

FRAC = 0.5


def test_method_tables_match_reference():
    assert METHODS == REF_METHODS


@pytest.fixture(scope="module")
def suites():
    """All nine methods on the 0.15-scale corpus, in both packages."""
    ref = ref_simulate_suite(ref_generate_suite(seed=0, scale=0.15), REF_METHODS, (FRAC,), RefSimConfig(min_executions=10))
    got = simulate_suite(generate_suite(seed=0, scale=0.15), METHODS, (FRAC,), SimConfig(min_executions=10))
    return ref, got


@pytest.mark.parametrize("method", METHODS)
def test_simulate_suite_matches_reference_exactly(suites, method):
    ref, got = suites
    ref = [r for r in ref if r.method == method]
    got = [r for r in got if r.method == method]
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert (a.workflow, a.task, a.train_frac, a.n_train, a.n_test) == (
            b.workflow, b.task, b.train_frac, b.n_train, b.n_test)
        np.testing.assert_array_equal(a.wastage_gib_s, b.wastage_gib_s)
        np.testing.assert_array_equal(a.retries, b.retries)


def test_suite_exercises_retries(suites):
    _, got = suites
    assert sum(int(r.retries.sum()) for r in got) > 0


def test_trace_features_match_reference():
    wf = generate_suite(seed=0, scale=0.15)[0]
    ref_wf = ref_generate_suite(seed=0, scale=0.15)[0]
    for trace, ref_trace in list(zip(wf.eligible_tasks(10), ref_wf.eligible_tasks(10)))[:4]:
        for k in (1, 4, 7):
            a, b = trace_features(trace, k), ref_trace_features(ref_trace, k)
            for name in ("peaks", "n_samples", "seg_peaks"):
                np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


@pytest.mark.parametrize("method", METHODS)
def test_predictor_service_matches_reference(method):
    """The same observations give the same predictions and retry bumps."""
    wf, ref_wf = generate_suite(seed=1, scale=0.15)[1], ref_generate_suite(seed=1, scale=0.15)[1]
    svc = MemoryPredictorService(method, node_cap_mib=64 * 1024.0)
    ref = RefService(method, node_cap_mib=64 * 1024.0)
    n_checked = 0
    for trace, ref_trace in list(zip(wf.eligible_tasks(10), ref_wf.eligible_tasks(10)))[:3]:
        for i, (e, re) in enumerate(zip(trace.executions[:24], ref_trace.executions[:24])):
            a = svc.predict(trace.name, e.input_size, trace.default_mib)
            b = ref.predict(ref_trace.name, re.input_size, ref_trace.default_mib)
            np.testing.assert_array_equal(a.boundaries, b.boundaries)
            np.testing.assert_array_equal(a.values, b.values)
            seg = i % a.k
            fa = svc.on_failure(trace.name, a, seg, trace.default_mib)
            fb = ref.on_failure(ref_trace.name, b, seg, ref_trace.default_mib)
            np.testing.assert_array_equal(fa.values, fb.values)
            svc.observe(trace.name, e.input_size, e.series, trace.default_mib)
            ref.observe(ref_trace.name, re.input_size, re.series, ref_trace.default_mib)
            n_checked += 1
    assert n_checked >= 24


@pytest.mark.parametrize("name", ["witt-lr", "witt-lr-max", "ppm", "ppm-improved", "sizey"])
def test_baselines_match_reference_on_a_long_stream(name):
    """300 observations: more distinct peaks than PPM's 256 candidates."""
    rng = np.random.default_rng(7)
    base, ref = make_baseline(name, 2048.0, 65536.0), ref_make_baseline(name, 2048.0, 65536.0)
    for _ in range(300):
        x = float(rng.uniform(1e8, 5e9))
        series = rng.uniform(10.0, x / 1e6, int(rng.integers(1, 40)))
        for u in (x, 0.5 * x):
            a, b = base.predict(u), ref.predict(u)
            np.testing.assert_array_equal(a.values, b.values)
        base.observe(x, series)
        ref.observe(x, series)


def _ref_cases():
    """The reference's allocation cases (tests/test_allocation.py) and
    random ones drawn as its property test draws them."""
    cases = [
        (np.linspace(10, 1000, 50), [20, 40, 60, 100], [15, 15, 15, 15], "partial"),
        (np.linspace(10, 1000, 50), [20, 40, 60, 100], [15, 15, 15, 15], "selective"),
        (np.full(10, 50.0), [1.0], [80.0], "selective"),
        (np.asarray([10.0, 10.0, 99.0, 10.0]), [1.0], [50.0], "partial"),
    ]
    for seed in range(12):
        rng = np.random.default_rng(seed)
        j, k = int(rng.integers(1, 300)), int(rng.integers(1, 7))
        y = rng.uniform(1, 5000, j)
        bounds = np.sort(rng.uniform(1, j * 2.0, k))
        values = np.maximum.accumulate(rng.uniform(1, 100, k))
        cases.append((y, bounds, values, ("selective", "partial")[seed % 2]))
    return cases


@pytest.mark.parametrize("case", range(len(_ref_cases())))
def test_run_with_retries_np_matches_reference(case):
    y, bounds, values, strategy = _ref_cases()[case]
    a = allocation.StepAllocation(np.asarray(bounds, float), np.asarray(values, float))
    b = ref_alloc.StepAllocation(np.asarray(bounds, float), np.asarray(values, float))
    got, want = allocation.score_attempt_np(y, 2.0, a), ref_alloc.score_attempt_np(y, 2.0, b)
    assert dataclasses.astuple(got) == dataclasses.astuple(want)
    got = allocation.run_with_retries_np(y, 2.0, a, strategy, 2.0, 128 * 1024)
    want = ref_alloc.run_with_retries_np(y, 2.0, b, strategy, 2.0, 128 * 1024)
    assert got[:2] == want[:2]
    np.testing.assert_array_equal(got[2].values, want[2].values)
    for seg in range(a.k):
        np.testing.assert_array_equal(a.with_retry(seg, strategy, 2.0).values, b.with_retry(seg, strategy, 2.0).values)


def test_allocation_helpers_refuse_what_the_reference_refuses():
    a = allocation.static_allocation(80.0, 1.0)
    with pytest.raises(ValueError, match="unknown retry strategy"):
        a.with_retry(0, "everything", 2.0)
    with pytest.raises(ValueError, match="exceeds node capacity"):
        allocation.run_with_retries_np(np.full(4, 200.0), 2.0, a, "selective", 2.0, 100.0)


def test_ksegments_strategy_field_matches_reference():
    assert KSegmentsConfig().strategy == RefKConfig().strategy == "selective"
    svc = MemoryPredictorService("ksegments-partial")
    assert svc._get("t", 512.0).model.config.strategy == "partial"
