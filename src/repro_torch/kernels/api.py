"""The public kernels API: the port of ``repro.kernels`` (``ops.segment_peaks``,
``ops.fit_stats``, ``ops.attempt_wastage`` and the flash kernel), with their
signatures.

Each function takes tensors and runs where they lie: on CUDA tensors it
launches the hand-written kernels, on CPU tensors their plain versions
(``kernels.ops``).  Inputs are cast to float32 as the reference casts them,
and every row reads its own series (``series = arange(B)``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import ops
from repro_torch.kernels.fitstats import MAX_K
from repro_torch.kernels.ops import flash_attention

__all__ = ["attempt_wastage", "fit_stats", "flash_attention", "segment_peaks"]


def _tensor(name: str, a) -> torch.Tensor:
    if not isinstance(a, torch.Tensor):
        raise TypeError(f"{name}: need a torch.Tensor (the API runs where its tensors lie), got {type(a).__name__}")
    return a


def _rows(B: int, dev: torch.device) -> torch.Tensor:
    return torch.arange(B, dtype=torch.int32, device=dev)


def segment_peaks(y: torch.Tensor, lengths: torch.Tensor, k: int) -> torch.Tensor:
    """(B, T) padded series + (B,) lengths -> (B, k) float32 segment peaks.

    A length below 1 counts as 1.  An empty segment takes the peak to its
    left; a row with no sample in any segment gets 0.
    """
    y = _tensor("y", y).to(torch.float32).contiguous()
    dev, B = y.device, y.shape[0]
    lengths = torch.clamp(_tensor("lengths", lengths).to(dev, torch.int32), min=1).contiguous()
    k_eff = torch.full((B,), k, dtype=torch.int32, device=dev)
    return ops.segment_peaks(y, lengths, _rows(B, dev), k_eff, k)


def fit_stats(x: torch.Tensor, peaks: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(B,) inputs + (B, k) segment peaks + (B,) weights -> (k, 5) float32
    bank ``(n, Σx, Σx², Σy, Σxy)``, k <= 128.

    ``x`` should be pre-shifted (``u = x - x0``) for float32 conditioning.
    Every row counts with its weight: a row of weight 0 holding NaN or inf
    poisons the bank, as in the reference.
    """
    peaks = _tensor("peaks", peaks).to(torch.float32).contiguous()
    if peaks.dim() != 2 or peaks.shape[1] > MAX_K:
        raise ValueError(f"fit_stats: need (B, k) peaks with k <= {MAX_K}, got {tuple(peaks.shape)}")
    dev = peaks.device
    x = _tensor("x", x).to(dev, torch.float32).reshape(-1).contiguous()
    valid = _tensor("valid", valid).to(dev, torch.float32).reshape(-1).contiguous()
    return ops.fit_stats(x, peaks, valid)


def attempt_wastage(
    y: torch.Tensor,
    lengths: torch.Tensor,
    bounds: torch.Tensor,
    values: torch.Tensor,
    interval_s: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Batch attempt scoring -> (wastage GiB*s (B,) float32, failure index
    (B,) int32, -1 on success); a length below 0 counts as 0."""
    y = _tensor("y", y).to(torch.float32).contiguous()
    dev, B = y.device, y.shape[0]
    lengths = torch.clamp(_tensor("lengths", lengths).to(dev, torch.int32), min=0).contiguous()
    bounds = _tensor("bounds", bounds).to(dev, torch.float32).contiguous()
    values = _tensor("values", values).to(dev, torch.float32).contiguous()
    return ops.attempt_wastage(y, lengths, _rows(B, dev), bounds, values, float(interval_s))
