"""Online simulation of the paper's evaluation protocol (Sec. IV-B): the
sequential oracle, the grid configuration, per-task results and the Fig. 7
aggregations (port of ``repro.sim.simulator``, float64 numpy on the host).

For each (task type, method, training fraction):

1. the first ``frac * n`` executions are history: they ran under the
   workflow defaults, and the method observes them;
2. every later execution is scored online: the method predicts, the
   execution replays against the prediction, OOM kills trigger the
   method's retry strategy until success, and the finished execution is
   folded back into the model.

A result holds the per-execution wastage (GiB*s) and retry counts of the
scored executions.  ``simulate_suite`` is the oracle the batched engine
(``sim.batch_engine.simulate_grid``) is held against.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.allocation import MIB_PER_GIB, StepAllocation
from repro_torch.core.ksegments import KSegmentsConfig
from repro_torch.core.predictor import AllocationMethod, make_method
from repro_torch.core.segmentation import segment_peaks_np
from repro_torch.sim.traces import TaskTrace, WorkflowTrace


@dataclasses.dataclass
class SimConfig:
    node_cap_mib: float = 128 * 1024.0  # the paper's 128 GB evaluation machine
    max_retries: int = 64
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


def run_execution(
    series_mib: np.ndarray,
    interval_s: float,
    alloc: StepAllocation,
    method: AllocationMethod,
    node_cap_mib: float,
    max_retries: int = 64,
) -> tuple[float, int]:
    """Replay one execution under a method's allocation + retry policy.

    Retries do not re-score the series from t = 0: a retry bump only raises
    values from the failed segment on (boundaries are unchanged and the
    schedule stays pointwise >= its predecessor), so the allocation row is
    recomputed only from the failed segment's start and the failure search
    resumes at the previous failure index.  Wastage sums still run over the
    same full slices of the same float64 row, so results are bit-identical
    to attempt-from-scratch scoring.
    """
    y = np.asarray(series_mib, dtype=np.float64)
    t = (np.arange(len(y)) + 0.5) * interval_s  # sample midpoints
    cur = StepAllocation(alloc.boundaries.copy(), np.minimum(alloc.values, node_cap_mib))
    a = cur.at(t)
    total, retries, search_from = 0.0, 0, 0
    while True:
        over = y[search_from:] > a[search_from:]
        if not over.any():
            total += float(np.sum(a - y) * interval_s) / MIB_PER_GIB
            return total, retries
        fi = search_from + int(np.argmax(over))
        total += float(np.sum(a[: fi + 1]) * interval_s) / MIB_PER_GIB
        retries += 1
        if retries > max_retries:
            raise RuntimeError("allocation never satisfied the task (check node cap)")
        seg = cur.segment_of((fi + 0.5) * interval_s)
        nxt = method.on_failure(cur, seg, node_cap_mib)
        nxt = StepAllocation(nxt.boundaries, np.minimum(nxt.values, node_cap_mib))
        if np.array_equal(nxt.boundaries, cur.boundaries):
            seg_start = 0.0 if seg == 0 else float(nxt.boundaries[seg - 1])
            s0 = int(np.searchsorted(t, seg_start, side="left"))
            a[s0:] = nxt.at(t[s0:])
            search_from = fi
        else:  # defensive: a custom method moved the boundaries — rescore fully
            a = nxt.at(t)
            search_from = 0
        cur = nxt


@dataclasses.dataclass
class TraceFeatures:
    """Per-execution observation features of one task trace.

    Every (method x fraction) cell of the grid observes the same executions,
    so the O(T) reductions — global peak, sample count, k-segment peaks —
    are computed once per (trace, k) and shared across all cells instead of
    being re-derived inside every ``observe`` call.
    """

    k: int
    peaks: np.ndarray  # (B,) global peak per execution
    n_samples: np.ndarray  # (B,) sample counts
    seg_peaks: np.ndarray  # (B, k) segment peaks (paper Sec. III-B)


def trace_features(trace: TaskTrace, k: int) -> TraceFeatures:
    execs = trace.executions
    peaks = np.asarray([float(np.asarray(e.series, dtype=np.float64).max()) for e in execs])
    n_samples = np.asarray([float(len(e.series)) for e in execs])
    seg_peaks = np.stack([segment_peaks_np(e.series, k) for e in execs]) if execs else np.zeros((0, k))
    return TraceFeatures(k=k, peaks=peaks, n_samples=n_samples, seg_peaks=seg_peaks)


def simulate_task(
    trace: TaskTrace,
    method_name: str,
    train_frac: float,
    cfg: SimConfig | None = None,
    features: TraceFeatures | None = None,
) -> TaskResult:
    cfg = cfg or SimConfig()
    if features is None or features.k != cfg.ksegments.k:
        features = trace_features(trace, cfg.ksegments.k)
    method = make_method(method_name, trace.default_mib, cfg.node_cap_mib, cfg.ksegments)
    execs = trace.executions

    def observe(i: int) -> None:
        e = execs[i]
        method.observe(
            e.input_size,
            e.series,
            peak=float(features.peaks[i]),
            n_samples=float(features.n_samples[i]),
            peaks=features.seg_peaks[i],
        )

    n_train = int(len(execs) * train_frac)
    for i in range(n_train):
        observe(i)

    wastages, retries = [], []
    for i in range(n_train, len(execs)):
        e = execs[i]
        alloc = method.predict(e.input_size)
        w, r = run_execution(e.series, trace.interval_s, alloc, method, cfg.node_cap_mib, cfg.max_retries)
        wastages.append(w)
        retries.append(r)
        observe(i)  # online feedback loop

    return TaskResult(
        task=trace.name,
        workflow=trace.workflow,
        method=method_name,
        train_frac=train_frac,
        n_train=n_train,
        n_test=len(execs) - n_train,
        wastage_gib_s=np.asarray(wastages),
        retries=np.asarray(retries),
    )


def simulate_suite(
    workflows: list[WorkflowTrace],
    methods: tuple[str, ...],
    train_fracs: tuple[float, ...] = (0.25, 0.5, 0.75),
    cfg: SimConfig | None = None,
) -> list[TaskResult]:
    """The full grid the paper reports: every eligible task x method x fraction.

    Observation features (segment peaks, global peaks, sample counts) are
    computed once per trace and shared across the task's method x fraction
    cells — they depend only on (trace, k), never on the method under test.
    """
    cfg = cfg or SimConfig()
    results = []
    for wf in workflows:
        for trace in wf.eligible_tasks(cfg.min_executions):
            features = trace_features(trace, cfg.ksegments.k)
            for frac in train_fracs:
                for m in methods:
                    results.append(simulate_task(trace, m, frac, cfg, features))
    return results


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
