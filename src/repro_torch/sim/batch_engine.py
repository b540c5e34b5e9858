"""The paper's Fig. 7 grid and Fig. 8 k-sweep on the two-phase engine.

Port of ``repro.sim.batch_engine`` (``simulate_grid``, ``simulate_ksweep``).
The corpus packs into bucket-padded ``(L, B, T)`` batches
(``traces.pack_traces``); each bucket's L task types run as the lanes of one
``torch_sim.simulate_lanes`` call, one bucket after another on one stream.
A training fraction is a slice of the same per-execution outcomes, so the
fraction axis costs nothing.  The k-sweep runs its segment counts as the
lanes of one call over one series.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.ksegments import KSegmentsConfig
from repro_torch.device import resolve_device
from repro_torch.sim.simulator import SimConfig, TaskResult
from repro_torch.sim.torch_sim import _check_methods, simulate_lanes
from repro_torch.sim.traces import TaskTrace, WorkflowTrace, pack_traces

# The reference's grid methods less those not ported yet (sizey, ksplus).
GRID_METHODS = ("default", "witt-lr", "ppm", "ppm-improved", "ksegments-selective", "ksegments-partial")


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
