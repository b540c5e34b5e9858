"""Sizey-style portfolio predictor (Bader et al. 2024, arxiv 2407.16353); a
float64 numpy copy of ``repro.core.sizey``.

Sizey maintains a *portfolio* of per-task peak-memory models and, before each
execution, selects the one with the best resource-allocation quality (RAQ) so
far.  This implementation carries the two models the portfolio needs to be
interesting on the paper's workloads:

* **linear** — online OLS ``peak ~ input_size`` (the feedback-regression
  family, same sufficient-statistic form as Witt-LR), and
* **quantile** — the empirical ``SIZEY_QUANTILE_PCT``-th percentile of the
  observed peaks (input-size-agnostic; robust when peaks don't correlate with
  input size).

Each model keeps its own *underprediction offset*: the running maximum of its
one-step-ahead underpredictions (prediction errors on executions it had not
yet seen — the honest online protocol shared with the progressive k-Segments
offsets).  A model's proposed allocation is ``prediction + offset`` floored at
``floor_mib``.

Allocation quality of a model after j observations is the mean over its past
one-step-ahead proposals of ``min(alloc, peak) / max(alloc, peak)`` (Sizey's
efficiency ratio: 1.0 = perfect sizing, small = heavy over- or
under-sizing), minus ``SIZEY_UNDER_PENALTY`` times its underprediction
frequency (underpredictions trigger retries, which Sizey penalizes beyond the
pure wastage ratio).  Scoring uses proposals from the model state *before*
each observation was folded, so the selection never rewards hindsight.

The quantile rank is computed in exact integer arithmetic
(``ceil(pct * (n - 1) / 100)`` over the ascending sort — numpy's "higher"
interpolation) so a float32 device engine and this float64 host model pick
the same order statistic (the engine's ``sim.torch_sim._sizey_prefix_values``,
as the reference engine's).

Failure handling follows the baseline protocol: double the allocation, capped
at the node's memory (the k = 1 ``StepAllocation`` special case).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import regression
from repro_torch.core.baselines import _PeakBaseline

# Portfolio constants, the reference engine's too.
SIZEY_QUANTILE_PCT = 95  # integer percent: rank = ceil(pct * (n-1) / 100)
SIZEY_UNDER_PENALTY = 0.5  # RAQ penalty weight on underprediction frequency
RAQ_EPS = 1e-9  # guards the efficiency ratio against zero peaks/allocs


def quantile_rank(n: int) -> int:
    """0-based index of the ``SIZEY_QUANTILE_PCT``-th percentile in an
    ascending sort of n values — ``ceil(pct * (n-1) / 100)`` in exact integer
    arithmetic (float ceil of e.g. 0.95 * 20 is representation-dependent and
    would let f32/f64 engines pick different order statistics)."""
    return -((-SIZEY_QUANTILE_PCT * (n - 1)) // 100)


class SizeyPortfolio(_PeakBaseline):
    """Online Sizey portfolio: {linear, quantile} scored by allocation quality.

    Model index 0 is linear, 1 is quantile; ties (and the cold start, before
    any one-step-ahead proposal exists) go to linear.
    """

    def __init__(self, default_mib: float, floor_mib: float = 100.0):
        super().__init__(default_mib, floor_mib)
        self._stats = np.zeros(regression.NUM_STATS, dtype=np.float64)
        self._x0 = 0.0  # input-size reference shift, see regression.py
        self._peaks: list[float] = []
        self._res_max = np.full(2, -np.inf)  # per-model max one-step underprediction
        self._sum_ratio = np.zeros(2)  # per-model efficiency-ratio sums
        self._sum_under = np.zeros(2)  # per-model underprediction counts
        self._cnt = 0  # scored proposals per model (same for both)

    # -- model predictions -------------------------------------------------

    def _raw_preds(self, u: float) -> np.ndarray:
        """(2,) raw predictions [linear, quantile] from the current state."""
        p_lin = float(regression.predict_np(self._stats, u))
        sp = np.sort(np.asarray(self._peaks, dtype=np.float64))
        p_q = float(sp[quantile_rank(len(sp))])
        return np.asarray([p_lin, p_q])

    def _alloc_preds(self, u: float) -> np.ndarray:
        """(2,) offset + floored allocations each model would propose."""
        return np.maximum(self._raw_preds(u) + np.maximum(self._res_max, 0.0), self.floor_mib)

    # -- online protocol ---------------------------------------------------

    def _observe(self, x: float, peak: float, samples: float) -> None:
        if self._n == 0:
            self._x0 = x
        u = x - self._x0
        if self._n >= 1:
            # Score both models' one-step-ahead proposals on this execution
            # BEFORE folding it in, then extend their offsets with its error.
            raw = self._raw_preds(u)
            v = np.maximum(raw + np.maximum(self._res_max, 0.0), self.floor_mib)
            self._sum_ratio += np.minimum(v, peak) / np.maximum(np.maximum(v, peak), RAQ_EPS)
            self._sum_under += (v < peak).astype(np.float64)
            self._cnt += 1
            self._res_max = np.maximum(self._res_max, peak - raw)
        self._stats = regression.update_stats_np(self._stats, u, peak)
        self._peaks.append(peak)

    def _choice(self) -> int:
        if self._cnt == 0:
            return 0
        score = (self._sum_ratio - SIZEY_UNDER_PENALTY * self._sum_under) / self._cnt
        return 1 if score[1] > score[0] else 0

    def _value(self, x: float) -> float:
        return float(self._alloc_preds(x - self._x0)[self._choice()])
