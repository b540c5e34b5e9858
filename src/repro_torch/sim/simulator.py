"""Grid configuration, per-task results and the paper's Fig. 7 aggregations
(port of the data half of ``repro.sim.simulator``).

For each (task type, method, training fraction) the first ``frac * n``
executions are history and every later one is scored online; a result holds
the per-execution wastage (GiB*s) and retry counts of the scored ones.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.ksegments import KSegmentsConfig


@dataclasses.dataclass
class SimConfig:
    node_cap_mib: float = 128 * 1024.0  # the paper's 128 GB evaluation machine
    min_executions: int = 20  # eligibility threshold for evaluation
    ksegments: KSegmentsConfig = dataclasses.field(default_factory=KSegmentsConfig)


@dataclasses.dataclass
class TaskResult:
    task: str
    workflow: str
    method: str
    train_frac: float
    n_train: int
    n_test: int
    wastage_gib_s: np.ndarray  # (n_test,) per-execution wastage
    retries: np.ndarray  # (n_test,) per-execution retry counts

    @property
    def mean_wastage(self) -> float:
        return float(self.wastage_gib_s.mean()) if len(self.wastage_gib_s) else 0.0

    @property
    def mean_retries(self) -> float:
        return float(self.retries.mean()) if len(self.retries) else 0.0


def fig7a_mean_wastage(results: list[TaskResult]) -> dict[tuple[str, float], float]:
    """Mean over tasks of per-task mean wastage, keyed by (method, frac)."""
    acc: dict[tuple[str, float], list[float]] = {}
    for r in results:
        acc.setdefault((r.method, r.train_frac), []).append(r.mean_wastage)
    return {k: float(np.mean(v)) for k, v in acc.items()}


def fig7b_lowest_counts(results: list[TaskResult]) -> dict[tuple[str, float], int]:
    """Per (method, frac): number of tasks where the method ties the lowest
    mean wastage (ties all score, as in the paper).  Tasks are identified by
    (workflow, task): names can collide across workflows."""
    by_task: dict[tuple[str, str, float], dict[str, float]] = {}
    for r in results:
        by_task.setdefault((r.workflow, r.task, r.train_frac), {})[r.method] = r.mean_wastage
    counts: dict[tuple[str, float], int] = {}
    for (_wf, _task, frac), per_method in by_task.items():
        best = min(per_method.values())
        for m, w in per_method.items():
            counts.setdefault((m, frac), 0)
            if np.isclose(w, best, rtol=1e-9, atol=1e-12):
                counts[(m, frac)] += 1
    return counts


def fig7c_mean_retries(results: list[TaskResult]) -> dict[tuple[str, float], float]:
    """Mean over tasks of per-task mean retries, keyed by (method, frac)."""
    acc: dict[tuple[str, float], list[float]] = {}
    for r in results:
        acc.setdefault((r.method, r.train_frac), []).append(r.mean_retries)
    return {k: float(np.mean(v)) for k, v in acc.items()}
