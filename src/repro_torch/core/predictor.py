"""Online memory-prediction service, the component the paper's Fig. 2/6
call "memory predictor" (port of ``repro.core.predictor``).

The method names and their retry policies: a "cap jump" method reassigns
the node's full memory on failure (original PPM); every other method
multiplies by the retry factor: only the failed segment for selective
methods, the failed segment onward for partial.  For the k = 1 baselines
the two coincide, so they ride selective.  The batched engine
(``sim.torch_sim``) reads these tables; the sequential oracle
(``sim.simulator``, ``sim.cluster.run_cluster``) and the
``MemoryPredictorService`` use the host adapters below, one
``AllocationMethod`` per (task type, method), in float64 numpy.
"""

from __future__ import annotations

import dataclasses
from typing import Protocol

import numpy as np

from repro_torch.core.allocation import StepAllocation
from repro_torch.core.baselines import make_baseline
from repro_torch.core.ksegments import KSegmentsConfig, KSegmentsModel

METHODS = (
    "default",
    "witt-lr",
    "witt-lr-max",
    "ppm",
    "ppm-improved",
    "ksegments-selective",
    "ksegments-partial",
    "sizey",
    "ksplus",
)

RETRY_SELECTIVE = {m: m != "ksegments-partial" for m in METHODS}
RETRY_CAP_JUMP = {m: m == "ppm" for m in METHODS}


def retry_flags(methods: tuple[str, ...]) -> tuple[tuple[bool, ...], tuple[bool, ...]]:
    """(selective, cap_jump) flag rows for a method tuple, in row order."""
    return (
        tuple(RETRY_SELECTIVE[m] for m in methods),
        tuple(RETRY_CAP_JUMP[m] for m in methods),
    )


class AllocationMethod(Protocol):
    """What the scheduler needs from any predictor.

    ``observe`` takes optional precomputed features of the series (its
    global peak, sample count and k-segment peaks), so grid evaluators
    derive them once per trace; every implementation recomputes what it
    needs when they are omitted.
    """

    def predict(self, input_size: float) -> StepAllocation: ...

    def observe(
        self,
        input_size: float,
        series_mib: np.ndarray,
        *,
        peak: float | None = None,
        n_samples: float | None = None,
        peaks: np.ndarray | None = None,
    ) -> None: ...

    def on_failure(self, alloc: StepAllocation, failed_segment: int, node_cap_mib: float) -> StepAllocation: ...


class KSegmentsMethod:
    """Adapter: the k-Segments model and its retry strategy behind the common API."""

    def __init__(self, default_mib: float, config: KSegmentsConfig):
        self.model = KSegmentsModel(config)
        self.default_mib = float(default_mib)

    def predict(self, input_size: float) -> StepAllocation:
        if self.model.n_observations == 0:
            return StepAllocation(np.asarray([1.0]), np.asarray([self.default_mib]))
        return self.model.predict(input_size)

    def observe(self, input_size, series_mib, *, peak=None, n_samples=None, peaks=None) -> None:
        self.model.observe(input_size, series_mib, peaks=peaks)

    def on_failure(self, alloc, failed_segment, node_cap_mib):
        cfg = self.model.config
        new = alloc.with_retry(failed_segment, cfg.strategy, cfg.retry_factor)
        new.values = np.minimum(new.values, node_cap_mib)
        return new


class _StaticAdapter:
    """Baselines ignore which segment failed (they have only one)."""

    def __init__(self, baseline):
        self.baseline = baseline

    def predict(self, input_size):
        return self.baseline.predict(input_size)

    def observe(self, input_size, series_mib, *, peak=None, n_samples=None, peaks=None):
        self.baseline.observe(input_size, series_mib, peak=peak, n_samples=n_samples)

    def on_failure(self, alloc, failed_segment, node_cap_mib):
        return self.baseline.on_failure(alloc, node_cap_mib)


def make_method(
    name: str,
    default_mib: float,
    node_cap_mib: float,
    ksegments_config: KSegmentsConfig | None = None,
) -> AllocationMethod:
    """The adapter of one method: k-Segments with the strategy its name
    gives, KS+ (relative offsets, selective retries), or a baseline."""
    name = name.lower()
    cfg = ksegments_config or KSegmentsConfig()
    if name.startswith("ksegments"):
        strategy = name.split("-", 1)[1] if "-" in name else cfg.strategy
        return KSegmentsMethod(default_mib, dataclasses.replace(cfg, strategy=strategy))
    if name == "ksplus":
        return KSegmentsMethod(default_mib, dataclasses.replace(cfg, offset_mode="relative", strategy="selective"))
    return _StaticAdapter(make_baseline(name, default_mib, node_cap_mib))


class MemoryPredictorService:
    """Per-task-type registry of online predictors (paper Fig. 2, green box)."""

    def __init__(
        self,
        method: str = "ksegments-selective",
        node_cap_mib: float = 128 * 1024.0,
        ksegments_config: KSegmentsConfig | None = None,
    ):
        self.method = method
        self.node_cap_mib = node_cap_mib
        self.ksegments_config = ksegments_config or KSegmentsConfig()
        self._models: dict[str, AllocationMethod] = {}

    def _get(self, task_type: str, default_mib: float) -> AllocationMethod:
        if task_type not in self._models:
            self._models[task_type] = make_method(self.method, default_mib, self.node_cap_mib, self.ksegments_config)
        return self._models[task_type]

    def predict(self, task_type: str, input_size: float, default_mib: float) -> StepAllocation:
        return self._get(task_type, default_mib).predict(input_size)

    def observe(self, task_type: str, input_size: float, series_mib, default_mib: float = 1024.0) -> None:
        self._get(task_type, default_mib).observe(input_size, np.asarray(series_mib))

    def on_failure(self, task_type: str, alloc: StepAllocation, failed_segment: int, default_mib: float = 1024.0):
        return self._get(task_type, default_mib).on_failure(alloc, failed_segment, self.node_cap_mib)
