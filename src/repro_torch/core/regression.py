"""Closed-form simple linear regression in sufficient-statistic form.

Each regression is five running statistics ``(n, Sx, Sxx, Sy, Sxy)`` along
the trailing axis, so banks of regressions (k segments x lanes x steps)
evaluate as one elementwise expression.  Port of ``repro.core.regression``
(the tensor half); callers pass inputs pre-shifted by the first observation
(``u = x - x0``) so float32 does not cancel on byte-scale input sizes.
The float64 numpy half (``*_np``) serves the sequential host model
(``core.ksegments.KSegmentsModel``), one observation at a time.
"""

from __future__ import annotations

import numpy as np
import torch

# Statistic layout along the trailing axis.
N, SX, SXX, SY, SXY = 0, 1, 2, 3, 4
NUM_STATS = 5

# Degenerate-fit guard: denominators below this fall back to the mean model.
_EPS = 1e-9


def empty_stats(*batch_shape: int, dtype=torch.float32, device=None) -> torch.Tensor:
    """A bank of regressions with no observations."""
    return torch.zeros((*batch_shape, NUM_STATS), dtype=dtype, device=device)


def stats_terms(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """The ``(1, x, x*x, y, x*y)`` terms one observation adds; ``x`` and
    ``y`` broadcast (one ``x`` against k segment peaks)."""
    x, y = torch.broadcast_tensors(x, y)
    return torch.stack([torch.ones_like(y), x, x * x, y, x * y], dim=-1)


def update_stats(stats: torch.Tensor, x, y) -> torch.Tensor:
    """Fold one observation ``(x, y)`` into each regression of the bank."""
    x = torch.as_tensor(x, dtype=stats.dtype, device=stats.device)
    y = torch.as_tensor(y, dtype=stats.dtype, device=stats.device)
    return stats + stats_terms(x, y)


def merge_stats(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sufficient statistics of the union of two observation sets."""
    return a + b


def fit(stats: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Solve each regression: ``(intercept, slope)``.  With fewer than two
    observations or all x identical the slope is 0 and the intercept the
    mean of y (0 when empty)."""
    n = stats[..., N]
    sx, sxx, sy, sxy = stats[..., SX], stats[..., SXX], stats[..., SY], stats[..., SXY]
    denom = n * sxx - sx * sx
    safe = denom.abs() > _EPS
    zero = torch.zeros((), dtype=stats.dtype, device=stats.device)
    slope = torch.where(safe, (n * sxy - sx * sy) / torch.where(safe, denom, torch.ones_like(denom)), zero)
    intercept = torch.where(n > 0, (sy - slope * sx) / torch.clamp(n, min=1.0), zero)
    return intercept, slope


def predict(stats: torch.Tensor, x) -> torch.Tensor:
    """Evaluate each regression of the bank at ``x`` (broadcasting)."""
    intercept, slope = fit(stats)
    return intercept + slope * torch.as_tensor(x, dtype=stats.dtype, device=stats.device)


# ---------------------------------------------------------------------------
# Plain-numpy float64 twins (the reference's ``*_np`` functions, unchanged).
# ---------------------------------------------------------------------------


def update_stats_np(stats: np.ndarray, x: float, y) -> np.ndarray:
    y = np.asarray(y, dtype=np.float64)
    upd = np.stack([np.ones_like(y), np.broadcast_to(x, y.shape), np.broadcast_to(x * x, y.shape), y, x * y], axis=-1)
    return stats + upd


def fit_np(stats: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    n = stats[..., N]
    sx, sxx, sy, sxy = stats[..., SX], stats[..., SXX], stats[..., SY], stats[..., SXY]
    denom = n * sxx - sx * sx
    safe = np.abs(denom) > _EPS
    slope = np.where(safe, (n * sxy - sx * sy) / np.where(safe, denom, 1.0), 0.0)
    intercept = np.where(n > 0, (sy - slope * sx) / np.maximum(n, 1.0), 0.0)
    return intercept, slope


def predict_np(stats: np.ndarray, x) -> np.ndarray:
    intercept, slope = fit_np(stats)
    return intercept + slope * x
