"""The paper's Fig. 7 grid, Fig. 8 k-sweep and the cluster's retry ladders
on the two-phase engine.

Port of ``repro.sim.batch_engine`` (``simulate_grid``, ``simulate_ksweep``,
``TaskLadders``, ``compute_cluster_ladders``).
The corpus packs into bucket-padded ``(L, B, T)`` batches
(``traces.pack_traces``); each bucket's L task types run as the lanes of one
``torch_sim.simulate_lanes`` call, one bucket after another on one stream.
A training fraction is a slice of the same per-execution outcomes, so the
fraction axis costs nothing.  The k-sweep runs its segment counts as the
lanes of one call over one series.  ``compute_cluster_ladders`` records
every queued execution's full retry ladder for the cluster scheduler
(``repro_torch.sim.cluster``) over the same packing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.allocation import AttemptLadder
from repro_torch.core.ksegments import KSegmentsConfig
from repro_torch.device import resolve_device
from repro_torch.sim.simulator import SimConfig, TaskResult
from repro_torch.sim.torch_sim import ENGINE_METHODS, MAX_RETRIES, _check_methods, ladder_lanes, simulate_lanes
from repro_torch.sim.traces import TaskTrace, WorkflowTrace, pack_traces

GRID_METHODS = tuple(m for m in ENGINE_METHODS if m != "witt-lr-max")


def _engine_error_mode(kcfg: KSegmentsConfig) -> tuple[str, int]:
    """``(error_mode, insample_window)`` of a config.  Progressive
    normalizes the window to 0; insample needs an explicit bound, because
    the engine rescans a fixed-size window of observations."""
    if kcfg.error_mode == "progressive":
        return "progressive", 0
    if kcfg.insample_window is None:
        raise ValueError(
            "the engine's insample mode needs an explicit history bound: "
            "set KSegmentsConfig(insample_window=W), or use error_mode='progressive'"
        )
    return "insample", int(kcfg.insample_window)


def _engine_kwargs(cfg: SimConfig, methods: tuple[str, ...], k: int) -> dict:
    kcfg = cfg.ksegments
    emode, ewin = _engine_error_mode(kcfg)
    return dict(
        methods=methods,
        k=k,
        interval_s=kcfg.interval_s,
        factor=kcfg.retry_factor,
        floor_mib=kcfg.floor_mib,
        cap_mib=cfg.node_cap_mib,
        error_mode=emode,
        insample_window=ewin,
    )


def _to_device(a: np.ndarray, dtype: torch.dtype, dev: torch.device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=dtype).to(dev)


def simulate_grid(
    workflows: list[WorkflowTrace],
    methods: tuple[str, ...] = GRID_METHODS,
    train_fracs: tuple[float, ...] = (0.25, 0.5, 0.75),
    cfg: SimConfig | None = None,
    device=None,
) -> list[TaskResult]:
    """The Fig. 7 grid: ``TaskResult`` rows ordered workflow -> task ->
    fraction -> method, every (method x fraction) cell of a task from one
    engine pass."""
    dev = resolve_device(device)
    cfg = cfg or SimConfig()
    methods = _check_methods(methods)
    kw = _engine_kwargs(cfg, methods, cfg.ksegments.k)
    tasks = [t for wf in workflows for t in wf.eligible_tasks(cfg.min_executions)]
    per_task: dict[int, tuple[np.ndarray, np.ndarray]] = {}
    for batch in pack_traces(tasks):
        L, B, T = batch.shape
        x = _to_device(batch.x, torch.float32, dev)
        waste, retries = simulate_lanes(
            x - x[:, :1],
            _to_device(batch.y.reshape(L * B, T), torch.float32, dev),
            _to_device(batch.lengths.reshape(L * B), torch.int32, dev),
            torch.arange(L * B, dtype=torch.int32, device=dev).view(L, B),
            _to_device(batch.default_mib, torch.float32, dev),
            torch.full((L,), cfg.ksegments.k, dtype=torch.int32, device=dev),
            **kw,
        )
        waste = waste.cpu().numpy().astype(np.float64)  # (L, M, B)
        retries = retries.cpu().numpy()
        for li, trace in enumerate(batch.tasks):
            n = int(batch.n_execs[li])
            per_task[id(trace)] = (waste[li, :, :n], retries[li, :, :n])

    results = []
    for trace in tasks:
        w, r = per_task[id(trace)]
        n = trace.n_executions
        for frac in train_fracs:
            n_train = int(n * frac)
            for mi, m in enumerate(methods):
                results.append(
                    TaskResult(
                        task=trace.name,
                        workflow=trace.workflow,
                        method=m,
                        train_frac=frac,
                        n_train=n_train,
                        n_test=n - n_train,
                        wastage_gib_s=w[mi, n_train:],
                        retries=r[mi, n_train:],
                    )
                )
    return results


def simulate_ksweep(
    trace: TaskTrace,
    ks: tuple[int, ...],
    train_frac: float = 0.5,
    cfg: SimConfig | None = None,
    method: str = "ksegments-selective",
    device=None,
) -> dict[int, TaskResult]:
    """Fig. 8: one task's wastage as a function of k, every k a lane of one
    engine pass (arrays sized by max(ks))."""
    dev = resolve_device(device)
    cfg = cfg or SimConfig()
    x, y, lengths = trace.padded()
    K, B = len(ks), len(x)
    x = _to_device(x, torch.float32, dev)
    waste, retries = simulate_lanes(
        (x - x[0]).expand(K, B),
        _to_device(y, torch.float32, dev),
        _to_device(lengths, torch.int32, dev),
        torch.arange(B, dtype=torch.int32, device=dev).expand(K, B),
        torch.full((K,), trace.default_mib, dtype=torch.float32, device=dev),
        torch.tensor(list(ks), dtype=torch.int32, device=dev),
        **_engine_kwargs(cfg, (method,), max(ks)),
    )
    waste = waste.cpu().numpy().astype(np.float64)  # (K, 1, B)
    retries = retries.cpu().numpy()
    n = trace.n_executions
    n_train = int(n * train_frac)
    return {
        kv: TaskResult(
            task=trace.name,
            workflow=trace.workflow,
            method=method,
            train_frac=train_frac,
            n_train=n_train,
            n_test=n - n_train,
            wastage_gib_s=waste[ki, 0, n_train:],
            retries=retries[ki, 0, n_train:],
        )
        for ki, kv in enumerate(ks)
    }


@dataclasses.dataclass
class TaskLadders:
    """All methods' retry ladders for one task type, host-side (float64).

    Arrays are indexed [method, execution, attempt(, segment)] (see
    ``torch_sim.ladder_lanes``); ``row`` materializes one (method,
    execution) cell as the ``AttemptLadder`` the cluster scheduler consumes.
    """

    methods: tuple[str, ...]
    boundaries: np.ndarray  # (M, B, k)
    values: np.ndarray  # (M, B, A, k)
    failure_index: np.ndarray  # (M, B, A)
    wastage_gib_s: np.ndarray  # (M, B, A)
    n_attempts: np.ndarray  # (M, B)

    def row(self, method: str, execution: int) -> AttemptLadder:
        mi = self.methods.index(method)
        n = int(self.n_attempts[mi, execution])
        if int(self.failure_index[mi, execution, n - 1]) >= 0:
            hint = (
                "raise max_attempts"
                if self.values.shape[2] <= MAX_RETRIES
                else f"the engine caps retries at {MAX_RETRIES}; the task cannot be scheduled"
            )
            raise RuntimeError(
                f"retry ladder of execution {execution} under {method!r} did not "
                f"converge within the recorded {self.values.shape[2]} attempts; {hint}"
            )
        return AttemptLadder(
            boundaries=self.boundaries[mi, execution],
            values=self.values[mi, execution],
            failure_index=self.failure_index[mi, execution],
            wastage_gib_s=self.wastage_gib_s[mi, execution],
            n_attempts=n,
        )


def compute_cluster_ladders(
    tasks: list[TaskTrace],
    methods: tuple[str, ...],
    node_cap_mib: float,
    kcfg: KSegmentsConfig | None = None,
    max_attempts: int = 32,
    x64: bool = False,
    device=None,
) -> dict[tuple[str, str], TaskLadders]:
    """Every execution's retry ladder for every method, one engine pass per
    padded bucket.  Returns ``{(workflow, task name): TaskLadders}``.

    ``x64=False`` predicts and decides in float32, as the reference's
    default; ``x64=True`` in float64 (the reference's fix for the rare
    seed where a float32 prediction sits on a capacity ulp).  Attempt
    wastage is summed in float64 either way."""
    dev = resolve_device(device)
    kcfg = kcfg or KSegmentsConfig()
    methods = _check_methods(methods)
    for t in tasks:
        if t.interval_s != kcfg.interval_s:
            raise ValueError(
                f"trace {t.name!r} interval {t.interval_s} != config interval {kcfg.interval_s}; "
                "the ladder engine takes one monitoring interval"
            )
    emode, ewin = _engine_error_mode(kcfg)
    dt = torch.float64 if x64 else torch.float32
    out: dict[tuple[str, str], TaskLadders] = {}
    for batch in pack_traces(tasks):
        L, B, T = batch.shape
        x = _to_device(batch.x, dt, dev)
        tbl = ladder_lanes(
            x - x[:, :1],
            _to_device(batch.y.reshape(L * B, T), torch.float32, dev),
            _to_device(batch.lengths.reshape(L * B), torch.int32, dev),
            torch.arange(L * B, dtype=torch.int32, device=dev).view(L, B),
            _to_device(batch.default_mib, dt, dev),
            torch.full((L,), kcfg.k, dtype=torch.int32, device=dev),
            methods=methods,
            k=kcfg.k,
            interval_s=kcfg.interval_s,
            factor=kcfg.retry_factor,
            floor_mib=kcfg.floor_mib,
            cap_mib=node_cap_mib,
            error_mode=emode,
            insample_window=ewin,
            max_attempts=max_attempts,
        )
        tbl = {name: v.cpu().numpy() for name, v in tbl.items()}
        for li, trace in enumerate(batch.tasks):
            n = int(batch.n_execs[li])
            out[(trace.workflow, trace.name)] = TaskLadders(
                methods=methods,
                boundaries=tbl["boundaries"][li, :, :n].astype(np.float64),
                values=tbl["values"][li, :, :n].astype(np.float64),
                failure_index=tbl["failure_index"][li, :, :n],
                wastage_gib_s=tbl["wastage_gib_s"][li, :, :n].astype(np.float64),
                n_attempts=tbl["n_attempts"][li, :, :n],
            )
    return out
