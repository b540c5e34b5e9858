"""Dispatch of the kernels by the tensors' device.

A CUDA tensor goes to the hand-written kernel (or the call raises); a CPU
tensor goes to the plain PyTorch version.  Rows index series: row r reads
``y[series[r]]``, so rows that share a series (the methods of one
execution, the k values of a sweep) never copy it on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.allocation import attempt_outcomes_batch
from repro_torch.core.segmentation import segment_peaks_dynamic
from repro_torch.kernels import segmax, wastage


def _route(y: torch.Tensor) -> bool:
    """True for the kernel, False for the plain version."""
    if y.device.type == "cuda":
        return True
    if y.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {y.device}")


def segment_peaks(
    y: torch.Tensor, lengths: torch.Tensor, series: torch.Tensor, k_eff: torch.Tensor, k_max: int
) -> torch.Tensor:
    """Segment peaks of rows ``y[series]`` with per-row ``k_eff`` -> (R, k_max)."""
    if _route(y):
        return segmax.segmax_cuda(y, lengths, series, k_eff, k_max)
    return segment_peaks_dynamic(y[series], lengths[series], k_eff, k_max)


def attempt_wastage(
    y: torch.Tensor,
    lengths: torch.Tensor,
    series: torch.Tensor,
    bounds: torch.Tensor,
    values: torch.Tensor,
    interval_s: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score attempt rows on ``y[series]`` -> (waste GiB*s (R,), fail index (R,), -1 on success)."""
    if _route(y):
        return wastage.wastage_cuda(y, lengths, series, bounds, values, interval_s)
    return attempt_outcomes_batch(y[series], lengths[series], interval_s, bounds, values)


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel."""
    return {"segmax": segmax.launches, "wastage": wastage.launches}


def reset_launch_counts() -> None:
    segmax.launches = 0
    wastage.launches = 0
