"""Failure recovery and straggler mitigation.

Port of ``repro.distributed.fault_tolerance``, host code over numpy.
``run_with_recovery`` is the supervisor loop: a step failure (preemption,
host OOM, an injected failure) falls back to the latest validated
checkpoint and resumes; the data pipeline is deterministic in (seed, step),
so the resumed run consumes the identical stream.

``StragglerDetector`` reuses the *runtime model* of the paper's k-Segments
predictor (OLS runtime ~ work size + largest-error offset): a step or task
running past ``factor x`` the offset prediction is flagged for speculative
rescheduling, the paper's Sec. III-B runtime component doing double duty as
the straggler signal.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core import regression


class SimulatedFailure(RuntimeError):
    """Injected node failure (tests / examples)."""

    def __init__(self, step: int):
        super().__init__(f"simulated node failure at step {step}")
        self.step = step


def run_with_recovery(make_trainer, max_restarts: int = 3):
    """Run a Trainer factory to completion, restarting from checkpoints on
    failure.  Returns (final_state, restarts_used)."""
    restarts = 0
    while True:
        trainer = make_trainer()
        try:
            return trainer.run(), restarts
        except SimulatedFailure:
            restarts += 1
            if restarts > max_restarts:
                raise


@dataclasses.dataclass
class StragglerEvent:
    task_type: str
    work_size: float
    runtime_s: float
    predicted_s: float


class _RuntimeModel:
    """The runtime half of k-Segments (paper Sec. III-B): OLS
    ``runtime ~ work_size`` with the largest historical *under*prediction as
    an upward offset (for straggler detection runtimes are bounded from
    above, the mirror image of the paper's downward memory-schedule
    offset)."""

    def __init__(self):
        self._stats = np.zeros(regression.NUM_STATS, dtype=np.float64)
        self._x0 = 0.0
        self._max_under = 0.0  # max(actual - predicted, 0)
        self.n = 0

    def predict(self, work_size: float) -> float:
        u = work_size - self._x0
        return float(regression.predict_np(self._stats, u)) + self._max_under

    def observe(self, work_size: float, runtime_s: float) -> None:
        if self.n == 0:
            self._x0 = work_size
        u = work_size - self._x0
        if self.n > 0:
            e = runtime_s - float(regression.predict_np(self._stats, u))
            self._max_under = max(self._max_under, e)
        self._stats = regression.update_stats_np(self._stats, u, runtime_s)
        self.n += 1


class StragglerDetector:
    """Flags executions that exceed the k-Segments runtime prediction."""

    def __init__(self, factor: float = 1.5, min_observations: int = 5):
        self.factor = factor
        self.min_observations = min_observations
        self._models: dict[str, _RuntimeModel] = {}
        self.events: list[StragglerEvent] = []

    def observe(self, task_type: str, work_size: float, runtime_s: float) -> bool:
        """Record an execution; returns True if it was a straggler."""
        m = self._models.setdefault(task_type, _RuntimeModel())
        is_straggler = False
        if m.n >= self.min_observations:
            pred = m.predict(work_size)
            if runtime_s > self.factor * max(pred, 1e-9):
                self.events.append(StragglerEvent(task_type, work_size, runtime_s, pred))
                is_straggler = True
        if not is_straggler:  # stragglers don't contaminate the model
            m.observe(work_size, runtime_s)
        return is_straggler
