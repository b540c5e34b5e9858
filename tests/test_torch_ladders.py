"""The cluster's retry ladders: ``compute_cluster_ladders(device="cpu")`` of
the port against the reference's, on the same seeded corpus, with float32
and float64 (x64) predictions.

Tolerances: attempt counts and failure indices exact; allocation values,
boundaries and attempt wastage rtol 1e-5, because XLA fuses float32
multiply-adds (one rounding) where PyTorch rounds each op, and the float64
wastage sums run in another order."""

import jax
import jax.experimental
import numpy as np
import pytest

from repro.core.ksegments import KSegmentsConfig as RefKConfig
from repro.sim.batch_engine import compute_cluster_ladders as ref_ladders
from repro.sim.traces import generate_workflow as ref_workflow
from repro_torch.core.ksegments import KSegmentsConfig
from repro_torch.sim import torch_sim
from repro_torch.sim.batch_engine import compute_cluster_ladders
from repro_torch.sim.traces import generate_workflow

METHODS = ("default", "witt-lr", "ppm", "ppm-improved", "ksegments-selective", "ksegments-partial", "sizey", "ksplus")
CAP_MIB = 64 * 1024.0
TOL = dict(rtol=1e-5, atol=1e-9)


@pytest.fixture
def x64(monkeypatch):
    """The reference's ladder program holds ``jax.experimental.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


@pytest.mark.parametrize("x64_ladders", [False, True])
def test_ladders_match_reference(x64, x64_ladders):
    ref_tasks = ref_workflow("sarek", seed=11, scale=0.04).eligible_tasks(8)
    tasks = generate_workflow("sarek", seed=11, scale=0.04).eligible_tasks(8)
    want = ref_ladders(ref_tasks, METHODS, CAP_MIB, RefKConfig(error_mode="progressive"), 16, x64=x64_ladders)
    got = compute_cluster_ladders(tasks, METHODS, CAP_MIB, KSegmentsConfig(error_mode="progressive"), 16,
                                  x64=x64_ladders, device="cpu")
    assert got.keys() == want.keys() and len(got) > 1
    retried = 0
    for key, w in want.items():
        g = got[key]
        np.testing.assert_array_equal(g.n_attempts, w.n_attempts)
        np.testing.assert_array_equal(g.failure_index, w.failure_index)
        np.testing.assert_allclose(g.boundaries, w.boundaries, **TOL)
        np.testing.assert_allclose(g.values, w.values, **TOL)
        np.testing.assert_allclose(g.wastage_gib_s, w.wastage_gib_s, **TOL)
        retried += int((w.n_attempts > 1).sum())
        for m in METHODS:  # the AttemptLadder rows the scheduler consumes
            a, b = g.row(m, 0), w.row(m, 0)
            assert a.n_attempts == b.n_attempts
            assert a.total_wastage_gib_s == pytest.approx(b.total_wastage_gib_s, rel=1e-5)
    assert retried > 0  # the corpus exercises the retry ladders


def test_unconverged_ladder_raises():
    """A ladder cut at max_attempts ends on a failure; ``row`` refuses it."""
    tasks = generate_workflow("eager", seed=3, scale=0.12).eligible_tasks(8)
    # a 1 MiB node cap: every attempt of every execution is killed
    lad = compute_cluster_ladders(tasks, ("default",), 1.0, KSegmentsConfig(error_mode="progressive"), 2,
                                  device="cpu")
    tl = next(iter(lad.values()))
    np.testing.assert_array_equal(tl.n_attempts, 2)
    assert (tl.failure_index >= 0).all()
    with pytest.raises(RuntimeError, match="did not converge"):
        tl.row("default", 0)


def test_sizey_and_ksplus_name_the_roadmap_item():
    """Sizey and KS+ have ladders (``test_ladders_match_reference``); a
    method the engine does not know raises."""
    assert {"sizey", "ksplus"} <= set(torch_sim.ENGINE_METHODS)
    tasks = generate_workflow("eager", seed=3, scale=0.12).eligible_tasks(8)
    with pytest.raises(ValueError, match="does not implement 'sizey-q'"):
        compute_cluster_ladders(tasks, ("default", "sizey-q"), CAP_MIB, device="cpu")
