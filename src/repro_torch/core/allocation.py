"""Step allocations and scoring an attempt against a measured series (Sec. IV-D).

``StepAllocation`` (the paper's Eq. 1 schedule) and ``AttemptLadder`` (one
execution's recorded retry ladder) are the numpy host types the cluster
scheduler consumes; ``pack_step_allocations`` pads a list of schedules for
the serving admission controller's demand profile; ``score_attempt_np`` and
``run_with_retries_np`` score one attempt, or one execution with its
retries, in float64 for the sequential oracle (ports of
``repro.core.allocation``).

``attempt_outcomes_batch`` is the plain PyTorch version of the wastage
kernel (``repro_torch/kernels/csrc/wastage.cu``); ``kernels.ops`` reaches it
for CPU tensors.  Its semantics are the reference engine's ``_attempt``
(``repro/sim/jax_sim.py``):

* the allocation is a right-open step function, evaluated at the sample
  midpoints ``t = (pos + 0.5) * interval`` as
  ``a(t) = values[min(#{bounds < t}, k - 1)]``;
* the attempt fails at the first valid sample with ``y > a``;
* a success wastes ``sum(a - y)`` over its valid samples, a failure its
  whole allocation up to and including the kill sample;
* decisions (the step function and ``y > a``) run in the schedule's dtype;
  sums accumulate in ``acc_dtype`` (the schedule's dtype unless asked: the
  cluster ladders sum float32 attempts in float64, as the reference does
  under its x64 context) and are scaled by ``interval / 1024`` to GiB*s.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

MIB_PER_GIB = 1024.0


@dataclasses.dataclass
class StepAllocation:
    """A k-step allocation schedule: right-open ``boundaries`` (k,) seconds,
    non-decreasing ``values`` (k,) MiB; holds ``values[-1]`` past the end."""

    boundaries: np.ndarray
    values: np.ndarray

    @property
    def k(self) -> int:
        return len(self.values)

    def at(self, t: np.ndarray) -> np.ndarray:
        """Allocation at time(s) ``t`` (vectorized)."""
        idx = np.minimum(np.searchsorted(self.boundaries, np.asarray(t), side="left"), self.k - 1)
        return self.values[idx]

    def segment_of(self, t: float) -> int:
        return int(min(np.searchsorted(self.boundaries, t, side="left"), self.k - 1))

    def with_retry(self, failed_segment: int, strategy: str, factor: float) -> "StepAllocation":
        """Paper Sec. III-D: selective bumps only the failed segment, partial
        bumps the failed segment and every later one; then monotone again."""
        v = self.values.copy()
        if strategy == "selective":
            v[failed_segment] = v[failed_segment] * factor
        elif strategy == "partial":
            v[failed_segment:] = v[failed_segment:] * factor
        else:
            raise ValueError(f"unknown retry strategy: {strategy!r}")
        v = np.maximum.accumulate(v)
        return StepAllocation(self.boundaries.copy(), v)


def static_allocation(value_mib: float, runtime_s: float) -> StepAllocation:
    """A single-value allocation (every baseline is the k = 1 special case)."""
    return StepAllocation(np.asarray([runtime_s], dtype=np.float64), np.asarray([value_mib], dtype=np.float64))


@dataclasses.dataclass
class AttemptOutcome:
    failed: bool
    failure_index: int  # sample index of the OOM kill (-1 on success)
    wastage_gib_s: float  # GiB*s wasted by this attempt
    alloc_gib_s: float  # total allocation integral of the attempt


def score_attempt_np(series_mib: np.ndarray, interval_s: float, alloc: StepAllocation) -> AttemptOutcome:
    """Score one attempt of one execution against a schedule, in float64:
    it fails at the first sample above the allocation and then wastes its
    whole allocation up to and including that sample; a success wastes
    ``alloc(t) - usage(t)`` over its runtime."""
    y = np.asarray(series_mib, dtype=np.float64)
    t = (np.arange(len(y)) + 0.5) * interval_s  # sample midpoints
    a = alloc.at(t)
    over = y > a
    if over.any():
        fi = int(np.argmax(over))
        waste = float(np.sum(a[: fi + 1]) * interval_s)
        return AttemptOutcome(True, fi, waste / MIB_PER_GIB, waste / MIB_PER_GIB)
    alloc_int = float(np.sum(a) * interval_s)
    waste = float(np.sum(a - y) * interval_s)
    return AttemptOutcome(False, -1, waste / MIB_PER_GIB, alloc_int / MIB_PER_GIB)



def pack_step_allocations(allocs: list[StepAllocation]) -> tuple[np.ndarray, np.ndarray]:
    """Pad R step allocations into the layout ``step_demand_profile``
    consumes: (R, kmax) inf-padded boundaries and (R, kmax + 1) hold-last
    values (the extra column is the value held past the final boundary)."""
    R = len(allocs)
    kmax = max((a.k for a in allocs), default=1)
    bnd = np.full((R, kmax), np.inf)
    val = np.empty((R, kmax + 1))
    for r, a in enumerate(allocs):
        kk = a.k
        bnd[r, :kk] = a.boundaries
        val[r, :kk] = a.values
        val[r, kk:] = a.values[-1]
    return bnd, val

@dataclasses.dataclass
class AttemptLadder:
    """The recorded retry ladder of one execution under one method: attempt
    ``a`` holds ``values[a]`` on the shared ``boundaries``;
    ``failure_index[a]`` is its OOM-kill sample (-1 on the final, successful
    attempt) and ``wastage_gib_s[a]`` its wastage."""

    boundaries: np.ndarray  # (k,) seconds
    values: np.ndarray  # (A, k) MiB, one row per attempt
    failure_index: np.ndarray  # (A,) int, -1 = success
    wastage_gib_s: np.ndarray  # (A,)
    n_attempts: int  # recorded attempts (retries + 1)

    def alloc(self, attempt: int) -> StepAllocation:
        return StepAllocation(self.boundaries, self.values[attempt])

    def run_time_s(self, attempt: int, duration_s: float, interval_s: float) -> float:
        """Node occupancy of one attempt: the full duration on success, up to
        and including the kill sample on failure."""
        fi = int(self.failure_index[attempt])
        return duration_s if fi < 0 else (fi + 1) * interval_s

    @property
    def total_wastage_gib_s(self) -> float:
        return float(self.wastage_gib_s[: self.n_attempts].sum())


def run_with_retries_np(
    series_mib: np.ndarray,
    interval_s: float,
    alloc: StepAllocation,
    strategy: str,
    factor: float,
    node_cap_mib: float,
    max_retries: int = 64,
) -> tuple[float, int, StepAllocation]:
    """Run one execution to success under a retry strategy, every attempt
    capped at the node's memory.  Returns (total wastage GiB*s over all
    attempts, retries, final allocation); a series whose peak exceeds the
    node raises."""
    total = 0.0
    retries = 0
    peak = float(np.max(series_mib))
    if peak > node_cap_mib:
        raise ValueError(f"task peak {peak} MiB exceeds node capacity {node_cap_mib} MiB")
    cur = StepAllocation(alloc.boundaries.copy(), np.minimum(alloc.values, node_cap_mib))
    while True:
        out = score_attempt_np(series_mib, interval_s, cur)
        total += out.wastage_gib_s
        if not out.failed:
            return total, retries, cur
        retries += 1
        if retries > max_retries:
            raise RuntimeError("retry loop did not converge")
        t_fail = (out.failure_index + 0.5) * interval_s
        seg = cur.segment_of(t_fail)
        cur = cur.with_retry(seg, strategy, factor)
        cur = StepAllocation(cur.boundaries, np.minimum(cur.values, node_cap_mib))


def step_allocation(t: torch.Tensor, boundaries: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """``a(t)`` for (T,) times under (B, k) step schedules -> (B, T)."""
    k = values.shape[-1]
    idx = torch.zeros((boundaries.shape[0], t.shape[0]), dtype=torch.int64, device=t.device)
    for s in range(k):
        idx += t[None, :] > boundaries[:, s : s + 1]
    return torch.gather(values, 1, torch.clamp(idx, max=k - 1))


def attempt_outcomes_batch(
    y: torch.Tensor,
    lengths: torch.Tensor,
    interval_s: float,
    boundaries: torch.Tensor,
    values: torch.Tensor,
    acc_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score B attempts: y (B, T), lengths (B,), boundaries/values (B, k).

    Returns (wastage GiB*s (B,) in ``acc_dtype``, failure index (B,) int32,
    -1 on success).
    """
    y = y.to(values.dtype)
    B, T = y.shape
    dev = y.device
    pos = torch.arange(T, device=dev)
    t = (pos.to(y.dtype) + 0.5) * interval_s
    a = step_allocation(t, boundaries, values)
    valid = pos[None, :] < lengths[:, None]
    over = (y > a) & valid
    failed = over.any(dim=1)
    fail_idx = torch.where(failed, torch.argmax(over.to(torch.int32), dim=1), -1)
    acc = acc_dtype or y.dtype
    a, y = a.to(acc), y.to(acc)
    zero = torch.zeros((), dtype=acc, device=dev)
    succ_w = torch.where(valid, a - y, zero).sum(dim=1)
    fail_w = torch.where((pos[None, :] <= fail_idx[:, None]) & valid, a, zero).sum(dim=1)
    waste = torch.where(failed, fail_w, succ_w) * interval_s / MIB_PER_GIB
    return waste, fail_idx.to(torch.int32)
