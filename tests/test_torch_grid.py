"""The port's Fig. 7 grid (all eight methods) and Fig. 8 k-sweep against
the reference batch engine (``repro.sim.batch_engine``), row for row, on the
CPU; and Sizey and KS+ on the grid against the port's own sequential oracle.

Tolerances: row metadata and retry counts exact; per-execution wastage and
Fig. 7a cell means rtol 1e-5 with atol 1e-4 GiB*s (f32 sums in another
order, f32 multiply-adds fused by XLA).  Against the oracle (float64 host
models) the reference's own engine gate (``tests/test_batch_engine.py``)."""

import numpy as np
import pytest

from repro.core.ksegments import KSegmentsConfig as RefKConfig
from repro.sim import batch_engine as ref_engine
from repro.sim import traces as ref_traces
from repro.sim.simulator import SimConfig as RefSimConfig
from repro.sim.simulator import fig7a_mean_wastage as ref_fig7a
from repro_torch.core.ksegments import KSegmentsConfig
from repro_torch.sim import batch_engine, traces
from repro_torch.sim.simulator import (
    SimConfig,
    fig7a_mean_wastage,
    fig7b_lowest_counts,
    fig7c_mean_retries,
    simulate_suite,
)

TOL = dict(rtol=1e-5, atol=1e-4)
WINDOW = {"progressive": None, "insample": 64}


def _configs(mode: str, **kw):
    return (
        SimConfig(ksegments=KSegmentsConfig(error_mode=mode, insample_window=WINDOW[mode]), **kw),
        RefSimConfig(ksegments=RefKConfig(error_mode=mode, insample_window=WINDOW[mode]), **kw),
    )


def _assert_rows_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.workflow, g.task, g.method, g.train_frac, g.n_train, g.n_test) == (
            w.workflow, w.task, w.method, w.train_frac, w.n_train, w.n_test)
        np.testing.assert_array_equal(g.retries, w.retries, err_msg=f"{g.task} {g.method}")
        np.testing.assert_allclose(g.wastage_gib_s, w.wastage_gib_s, err_msg=f"{g.task} {g.method}", **TOL)


@pytest.mark.parametrize("mode", sorted(WINDOW))
@pytest.mark.parametrize("workflow", ["eager", "sarek"])
def test_grid_matches_reference_row_for_row(workflow, mode):
    cfg, ref_cfg = _configs(mode, min_executions=8)
    got = batch_engine.simulate_grid(
        [traces.generate_workflow(workflow, seed=5, scale=0.12)], cfg=cfg, device="cpu"
    )
    want = ref_engine.simulate_grid(
        [ref_traces.generate_workflow(workflow, seed=5, scale=0.12)], batch_engine.GRID_METHODS, cfg=ref_cfg
    )
    _assert_rows_match(got, want)
    ga, wa = fig7a_mean_wastage(got), ref_fig7a(want)
    assert ga.keys() == wa.keys()
    np.testing.assert_allclose([ga[c] for c in wa], [wa[c] for c in wa], **TOL)
    assert sum(fig7b_lowest_counts(got).values()) >= len(got) // len(batch_engine.GRID_METHODS)
    assert all(v >= 0 for v in fig7c_mean_retries(got).values())


@pytest.mark.parametrize("mode", sorted(WINDOW))
def test_ksweep_matches_reference(mode):
    cfg, ref_cfg = _configs(mode)
    trace = max(traces.generate_eager(seed=5, scale=0.12).tasks, key=lambda t: t.n_executions)
    ref_trace = max(ref_traces.generate_eager(seed=5, scale=0.12).tasks, key=lambda t: t.n_executions)
    ks = (1, 2, 4, 8)
    got = batch_engine.simulate_ksweep(trace, ks, 0.5, cfg, device="cpu")
    want = ref_engine.simulate_ksweep(ref_trace, ks, 0.5, ref_cfg)
    assert list(got) == list(ks)
    _assert_rows_match([got[k] for k in ks], [want[k] for k in ks])


@pytest.mark.parametrize("mode", sorted(WINDOW))
def test_ksplus_ksweep_matches_reference(mode):
    cfg, ref_cfg = _configs(mode)
    trace = max(traces.generate_eager(seed=5, scale=0.12).tasks, key=lambda t: t.n_executions)
    ref_trace = max(ref_traces.generate_eager(seed=5, scale=0.12).tasks, key=lambda t: t.n_executions)
    ks = (1, 2, 4, 8)
    got = batch_engine.simulate_ksweep(trace, ks, 0.5, cfg, method="ksplus", device="cpu")
    want = ref_engine.simulate_ksweep(ref_trace, ks, 0.5, ref_cfg, method="ksplus")
    _assert_rows_match([got[k] for k in ks], [want[k] for k in ks])


def _oracle_gate(got, ref):
    """The reference's engine-vs-oracle gate (tests/test_batch_engine.py:36-47)."""
    assert got.n_train == ref.n_train and got.n_test == ref.n_test
    np.testing.assert_allclose(got.wastage_gib_s.sum(), ref.wastage_gib_s.sum(), rtol=0.05, atol=1e-6)
    assert abs(int(got.retries.sum()) - int(ref.retries.sum())) <= max(2, 0.1 * ref.retries.sum())
    if ref.n_test:
        close = np.isclose(got.wastage_gib_s, ref.wastage_gib_s, rtol=0.05, atol=0.5)
        assert close.mean() > 0.9


def test_sizey_and_ksplus_grid_pass_the_oracle_gate():
    """The engine's Sizey and KS+ against the sequential host models of
    ``simulate_suite`` on every cell, fractions 0 (every execution scored)
    and 0.5."""
    cfg = SimConfig(min_executions=10, ksegments=KSegmentsConfig(error_mode="progressive"))
    wfs = traces.generate_suite(seed=5, scale=0.2)
    methods, fracs = ("sizey", "ksplus"), (0.0, 0.5)
    got = batch_engine.simulate_grid(wfs, methods, fracs, cfg, device="cpu")
    want = simulate_suite(wfs, methods, fracs, cfg)
    assert [(r.task, r.method, r.train_frac) for r in got] == [(r.task, r.method, r.train_frac) for r in want]
    assert len(got) >= 40
    for g, w in zip(got, want):
        _oracle_gate(g, w)


def test_grid_rejects_unported_methods_and_unbounded_insample():
    wf = traces.generate_eager(seed=5, scale=0.12)
    assert batch_engine.GRID_METHODS == ref_engine.GRID_METHODS
    with pytest.raises(ValueError, match="does not implement 'sizey-lr'"):
        batch_engine.simulate_grid([wf], methods=("default", "sizey-lr"), device="cpu")
    with pytest.raises(ValueError, match="explicit history bound"):
        batch_engine.simulate_grid([wf], cfg=SimConfig(), device="cpu")
