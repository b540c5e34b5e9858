"""Scoring an allocation attempt against a measured series (Sec. IV-D).

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
* sums accumulate in the series' dtype (float32 on the main path) and are
  scaled by ``interval / 1024`` to GiB*s.
"""

from __future__ import annotations

import torch

MIB_PER_GIB = 1024.0


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score B attempts: y (B, T), lengths (B,), boundaries/values (B, k).

    Returns (wastage GiB*s (B,), failure index (B,) int32, -1 on success).
    """
    B, T = y.shape
    dev = y.device
    pos = torch.arange(T, device=dev)
    t = (pos.to(y.dtype) + 0.5) * interval_s
    a = step_allocation(t, boundaries, values)
    valid = pos[None, :] < lengths[:, None]
    over = (y > a) & valid
    failed = over.any(dim=1)
    fail_idx = torch.where(failed, torch.argmax(over.to(torch.int32), dim=1), -1)
    zero = torch.zeros((), dtype=y.dtype, device=dev)
    succ_w = torch.where(valid, a - y, zero).sum(dim=1)
    fail_w = torch.where((pos[None, :] <= fail_idx[:, None]) & valid, a, zero).sum(dim=1)
    waste = torch.where(failed, fail_w, succ_w) * interval_s / MIB_PER_GIB
    return waste, fail_idx.to(torch.int32)
