"""Time-series segmentation exactly as defined in the paper (Sec. III-B).

A series of length ``j`` splits into ``k`` segments: the first ``k-1`` have
length ``i = floor(j / k)`` (guarded to >= 1) and the last absorbs the
remainder.  Each segment reduces to its peak.  Empty segments (``j < k``, or
``s >= k_eff`` in a padded ``k_max``-wide output) take the peak to their
left; a series with no sample at all gets 0.

``segment_peaks_dynamic`` is the plain PyTorch version of the segmax kernel
(``repro_torch/kernels/csrc/segmax.cu``); ``kernels.ops.segment_peaks``
reaches it for CPU tensors.  ``segment_peaks_np`` is the float64 numpy form
of one unpadded series, for the host model.  Port of
``repro.core.segmentation``.
"""

from __future__ import annotations

import numpy as np
import torch


def segment_bounds(length: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Start/end sample indices ``(..., k)`` of the paper's segmentation."""
    length = torch.as_tensor(length)
    i = torch.clamp(length // k, min=1)
    s = torch.arange(k, device=length.device)
    starts = torch.minimum(s * i[..., None], length[..., None])
    ends = torch.where(s == k - 1, length[..., None], torch.minimum((s + 1) * i[..., None], length[..., None]))
    return starts, torch.maximum(ends, starts)


def segment_peaks(y: torch.Tensor, lengths: torch.Tensor, k: int) -> torch.Tensor:
    """(B, T) padded series + (B,) lengths -> (B, k) segment peaks."""
    return segment_peaks_dynamic(y, lengths, k, k)


def segment_peaks_dynamic(y: torch.Tensor, lengths: torch.Tensor, k_eff, k_max: int) -> torch.Tensor:
    """Segment peaks with a run-time segment count, padded to ``k_max``.

    ``k_eff`` is an int or a (B,) tensor (one count per row).  Columns
    ``s >= k_eff`` are empty and forward-fill, i.e. replicate the last real
    segment's peak, so banks learned from them stay exact replicas.
    """
    B, T = y.shape
    dev = y.device
    lengths = lengths.to(torch.int64)
    k_eff = torch.as_tensor(k_eff, dtype=torch.int64, device=dev).expand(B)[:, None]  # (B, 1)
    i = torch.clamp(lengths[:, None] // torch.clamp(k_eff, min=1), min=1)  # (B, 1)
    s = torch.arange(k_max, device=dev)[None, :]
    real = s < k_eff
    len_c = lengths[:, None]
    starts = torch.where(real, torch.minimum(s * i, len_c), len_c)
    ends = torch.where(s == k_eff - 1, len_c, torch.where(real, torch.minimum((s + 1) * i, len_c), len_c))
    ends = torch.maximum(ends, starts)
    pos = torch.arange(T, device=dev)[None, None, :]
    mask = (pos >= starts[..., None]) & (pos < ends[..., None])  # (B, k_max, T)
    neg = torch.tensor(-torch.inf, dtype=y.dtype, device=dev)
    peaks = torch.where(mask, y[:, None, :], neg).amax(dim=-1)
    has = torch.isfinite(peaks)
    last_idx = torch.cummax(torch.where(has, s, -1), dim=1).values
    filled = torch.gather(peaks, 1, torch.clamp(last_idx, min=0))
    peaks = torch.where(has, peaks, filled)
    return torch.where(torch.isfinite(peaks), peaks, torch.zeros((), dtype=y.dtype, device=dev))


def segment_peaks_np(y: np.ndarray, k: int) -> np.ndarray:
    """Float64 numpy peaks of one unpadded series (the host model's)."""
    y = np.asarray(y, dtype=np.float64)
    j = len(y)
    if j == 0:
        return np.zeros(k)
    i = max(j // k, 1)
    peaks = np.empty(k)
    prev = y[0]
    for s in range(k):
        lo = min(s * i, j)
        hi = j if s == k - 1 else min((s + 1) * i, j)
        hi = max(hi, lo)
        if hi > lo:
            prev = float(np.max(y[lo:hi]))
        peaks[s] = prev
    return peaks
