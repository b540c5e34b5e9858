"""The port's failure recovery and straggler detection against the
reference's, on the CPU: the same runtime stream flags the same events with
the same predictions (float64 numpy on both sides, exactly), and the
supervisor loop gives the same restart counts."""

import numpy as np
import pytest

from repro.distributed.fault_tolerance import SimulatedFailure as RefSimulatedFailure
from repro.distributed.fault_tolerance import StragglerDetector as RefStragglerDetector
from repro.distributed.fault_tolerance import _RuntimeModel as RefRuntimeModel
from repro.distributed.fault_tolerance import run_with_recovery as ref_run_with_recovery
from repro_torch.distributed import SimulatedFailure, StragglerDetector, StragglerEvent, run_with_recovery
from repro_torch.distributed.fault_tolerance import _RuntimeModel


def _stream(seed: int, n: int):
    """(task_type, work_size, runtime_s): three task types with linear
    runtimes, 1% noise, and about one execution in twenty a straggler."""
    rng = np.random.default_rng(seed)
    slopes = {"prep": 0.1, "step": 0.02, "ckpt": 1.5}
    out = []
    for _ in range(n):
        t = str(rng.choice(list(slopes)))
        w = float(rng.uniform(10, 200))
        r = slopes[t] * w * (1 + rng.normal(0, 0.01)) + 0.05
        if rng.random() < 0.05:
            r *= float(rng.uniform(2, 6))
        out.append((t, w, r))
    return out


@pytest.mark.parametrize("seed,factor,min_obs", [(0, 1.5, 5), (1, 1.2, 3), (2, 2.0, 10), (3, 1.5, 1)])
def test_straggler_events_equal_the_reference(seed, factor, min_obs):
    ref, port = RefStragglerDetector(factor, min_obs), StragglerDetector(factor, min_obs)
    for t, w, r in _stream(seed, 400):
        assert port.observe(t, w, r) == ref.observe(t, w, r)
    assert len(port.events) == len(ref.events) > 0
    for a, b in zip(port.events, ref.events):
        assert isinstance(a, StragglerEvent)
        assert (a.task_type, a.work_size, a.runtime_s, a.predicted_s) == \
            (b.task_type, b.work_size, b.runtime_s, b.predicted_s)


def test_straggler_detector_flags_a_slow_step():
    det = StragglerDetector(factor=1.5, min_observations=5)
    rng = np.random.default_rng(0)
    for _ in range(20):
        w = rng.uniform(10, 20)
        det.observe("step", w, 0.1 * w * (1 + rng.normal(0, 0.01)))
    assert not det.events
    assert det.observe("step", 15.0, 10.0)
    assert len(det.events) == 1 and det.events[0].runtime_s > 1.5 * det.events[0].predicted_s


def test_runtime_model_predicts_as_the_reference():
    """The runtime half of k-Segments, observation after observation: the
    OLS fit plus the largest underprediction so far (after (10, 1.0) alone
    the fit is flat at 1.0, so (20, 2.0) sets the offset to 1.0)."""
    port, ref = _RuntimeModel(), RefRuntimeModel()
    for w, r in [(10.0, 1.0), (20.0, 2.0), (30.0, 3.5), (40.0, 4.0), (25.0, 2.4)] + [(w, r) for _, w, r in _stream(5, 50)]:
        port.observe(w, r)
        ref.observe(w, r)
        for x in (5.0, 30.0, 180.0):
            assert port.predict(x) == ref.predict(x)
    assert port.n == ref.n == 55 and port._max_under >= 1.0


class _Trainer:
    """A stub: ``run()`` raises its package's SimulatedFailure while the
    shared plan says this attempt fails, else returns the final state."""

    def __init__(self, failure, plan: list, attempts: list):
        self.failure, self.plan, self.attempts = failure, plan, attempts

    def run(self):
        self.attempts.append(len(self.attempts))
        if self.plan and self.plan.pop(0):
            raise self.failure(len(self.attempts) * 10)
        return {"step": 16}


def _recover(run, failure, plan: list, max_restarts: int):
    attempts = []
    plan = list(plan)
    try:
        state, restarts = run(lambda: _Trainer(failure, plan, attempts), max_restarts=max_restarts)
    except failure as e:
        return "gave up", len(attempts), e.step
    return state, restarts, len(attempts)


@pytest.mark.parametrize("plan,max_restarts", [([], 3), ([True], 3), ([True, True, False], 3),
                                               ([True, True, True], 3), ([True] * 4, 3), ([True] * 3, 2),
                                               ([True], 0)])
def test_run_with_recovery_restarts_as_the_reference(plan, max_restarts):
    got = _recover(run_with_recovery, SimulatedFailure, plan, max_restarts)
    want = _recover(ref_run_with_recovery, RefSimulatedFailure, plan, max_restarts)
    assert got == want
    if sum(plan) > max_restarts:
        assert got[0] == "gave up" and got[1] == max_restarts + 1


def test_other_errors_are_not_retried():
    class Broken:
        def run(self):
            raise ValueError("not a node failure")

    with pytest.raises(ValueError):
        run_with_recovery(Broken)
    assert str(SimulatedFailure(4)) == "simulated node failure at step 4" and SimulatedFailure(4).step == 4
