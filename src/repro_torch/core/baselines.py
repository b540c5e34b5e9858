"""State-of-the-art baselines the paper evaluates against (Sec. IV-C); a
float64 numpy copy of ``repro.core.baselines``.

All baselines predict a single static peak value (the k = 1 special case of a
step allocation) and learn online, exactly like the paper's simulation:

* ``DefaultAllocator`` — the workflow developers' static per-task defaults.
* ``WittLR`` — Witt et al. 2019 (feedback-based): online linear regression
  ``peak ~ input_size`` with a prediction-error offset (variants: +stddev of
  errors ["std"], stddev of negative errors ["std_neg"], largest
  underprediction ["max"]); doubles the allocation on failure.
* ``TovarPPM`` — Tovar et al. 2017: picks the initial allocation from the
  empirical peak distribution minimizing expected wastage under the
  slow-peaks model (tasks fail at the end of their run); on failure assigns
  the node's full memory.
* ``PPMImproved`` — the paper's own improvement of Tovar: identical candidate
  selection, but failure doubles the allocation instead of jumping to the
  node maximum.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import regression
from repro_torch.core.allocation import StepAllocation, static_allocation


class _PeakBaseline:
    """Shared bookkeeping: observes (input_size, peak, runtime) triples."""

    def __init__(self, default_mib: float, floor_mib: float = 100.0):
        self.default_mib = float(default_mib)
        self.floor_mib = float(floor_mib)
        self._n = 0

    def observe(
        self,
        input_size: float,
        series_mib: np.ndarray,
        *,
        peak: float | None = None,
        n_samples: float | None = None,
    ) -> None:
        if peak is None:
            peak = float(np.asarray(series_mib, dtype=np.float64).max())
        if n_samples is None:
            n_samples = float(len(series_mib))
        self._observe(float(input_size), float(peak), float(n_samples))
        self._n += 1

    def _observe(self, x: float, peak: float, samples: float) -> None:
        raise NotImplementedError

    def _value(self, x: float) -> float:
        raise NotImplementedError

    def predict(self, input_size: float) -> StepAllocation:
        if self._n == 0:
            return static_allocation(self.default_mib, 1.0)
        return static_allocation(max(self._value(float(input_size)), self.floor_mib), 1.0)

    def on_failure(self, alloc: StepAllocation, node_cap_mib: float) -> StepAllocation:
        return static_allocation(min(float(alloc.values[-1]) * 2.0, node_cap_mib), 1.0)


class DefaultAllocator(_PeakBaseline):
    """The workflow's out-of-the-box memory directive (sanity baseline)."""

    def _observe(self, x, peak, samples):
        pass

    def _value(self, x):
        return self.default_mib

    def predict(self, input_size: float) -> StepAllocation:
        return static_allocation(self.default_mib, 1.0)


class WittLR(_PeakBaseline):
    """Witt et al. 2019 feedback-based LR with error offsetting."""

    def __init__(self, default_mib: float, offset: str = "std", floor_mib: float = 100.0):
        super().__init__(default_mib, floor_mib)
        if offset not in ("std", "std_neg", "max"):
            raise ValueError(f"unknown offset strategy: {offset!r}")
        self.offset = offset
        self._stats = np.zeros(regression.NUM_STATS, dtype=np.float64)
        self._x0 = 0.0  # input-size reference shift, see regression.py
        self._hist_u: list[float] = []
        self._hist_peak: list[float] = []

    def _observe(self, x, peak, samples):
        if self._n == 0:
            self._x0 = x
        u = x - self._x0
        self._stats = regression.update_stats_np(self._stats, u, peak)
        self._hist_u.append(u)
        self._hist_peak.append(peak)

    def _offset_value(self) -> float:
        """Offset from the residuals e = actual - predicted of the current fit
        (positive e == underprediction == dangerous)."""
        e = np.asarray(self._hist_peak) - regression.predict_np(self._stats, np.asarray(self._hist_u))
        if self.offset == "std":  # Witt's "LR mean +/-"
            return float(e.std()) if len(e) >= 2 else 0.0
        if self.offset == "std_neg":  # Witt's "LR mean -": negative errors only
            under = e[e > 0]
            return float(under.std()) if len(under) >= 2 else (float(under.max()) if len(under) else 0.0)
        return float(max(e.max(), 0.0))  # Witt's "LR max"

    def _value(self, x):
        return float(regression.predict_np(self._stats, x - self._x0)) + self._offset_value()


class TovarPPM(_PeakBaseline):
    """Tovar et al. 2017 probability-of-peak-memory sizing.

    Candidate allocations are the observed peaks; the pick minimizes the
    empirical expected wastage under the slow-peaks model, including the cost
    of the second allocation step (node max for the original method, doubling
    for ``improved=True`` — the paper's PPM Improved)."""

    MAX_CANDIDATES = 256  # above this, candidates are peak-distribution quantiles

    def __init__(self, default_mib: float, node_cap_mib: float, improved: bool = False, floor_mib: float = 100.0):
        super().__init__(default_mib, floor_mib)
        self.node_cap_mib = float(node_cap_mib)
        self.improved = improved
        self._peaks: list[float] = []
        self._runtimes: list[float] = []  # in samples; relative weights only

    def _observe(self, x, peak, samples):
        self._peaks.append(peak)
        self._runtimes.append(samples)

    def _value(self, x):
        # Sort peaks once; expected wastage for every candidate comes from
        # cumulative sums (O(n log n) total instead of O(n^2)).
        peaks = np.asarray(self._peaks, dtype=np.float64)
        rts = np.asarray(self._runtimes, dtype=np.float64)
        order = np.argsort(peaks)
        p, rt = peaks[order], rts[order]
        n = len(p)
        C = np.cumsum(rt)  # C[m] = sum rt_i for p_i <= p_m
        S = np.cumsum(p * rt)
        uniq_idx = np.flatnonzero(np.diff(p, append=np.inf) > 0)  # last index of each unique peak
        if len(uniq_idx) > self.MAX_CANDIDATES:
            sel = np.linspace(0, len(uniq_idx) - 1, self.MAX_CANDIDATES).astype(int)
            uniq_idx = uniq_idx[sel]
            if uniq_idx[-1] != n - 1:
                uniq_idx[-1] = n - 1  # always include the max peak
        q = p[uniq_idx]
        waste_ok = q * C[uniq_idx] - S[uniq_idx]  # successes: (q - p_i) * rt_i
        rt_bad = C[-1] - C[uniq_idx]
        s_bad = S[-1] - S[uniq_idx]
        if not self.improved:
            # failed first attempt wastes q*rt; retry at node max wastes (cap - p)*rt
            waste_bad = q * rt_bad + self.node_cap_mib * rt_bad - s_bad
        else:
            # doubling ladder: smallest a = q*2^D >= p wastes (2a - q - p)*rt
            # (sum of the failed geometric attempts + final overshoot).
            waste_bad = np.zeros_like(q)
            for ci, (qq, mi) in enumerate(zip(q, uniq_idx)):
                acc = 0.0
                a = qq
                lo = mi + 1  # first index with p > qq
                while lo < n:
                    a = min(a * 2.0, self.node_cap_mib)
                    hi = np.searchsorted(p, a, side="right")  # peaks <= a succeed at ladder level a
                    hi = max(hi, lo + 1) if a >= self.node_cap_mib else hi
                    if hi > lo:
                        acc += (2.0 * a - qq) * (C[hi - 1] - C[lo - 1]) - (S[hi - 1] - S[lo - 1])
                        lo = hi
                    if a >= self.node_cap_mib:
                        break
                waste_bad[ci] = acc
        best = int(np.argmin(waste_ok + waste_bad))
        return float(q[best])

    def on_failure(self, alloc: StepAllocation, node_cap_mib: float) -> StepAllocation:
        if self.improved:
            return static_allocation(min(float(alloc.values[-1]) * 2.0, node_cap_mib), 1.0)
        return static_allocation(node_cap_mib, 1.0)


def make_baseline(name: str, default_mib: float, node_cap_mib: float):
    """Factory used by the simulator and benchmarks."""
    name = name.lower()
    if name == "default":
        return DefaultAllocator(default_mib)
    if name == "witt-lr":
        return WittLR(default_mib, offset="std")
    if name == "witt-lr-max":
        return WittLR(default_mib, offset="max")
    if name == "ppm":
        return TovarPPM(default_mib, node_cap_mib, improved=False)
    if name == "ppm-improved":
        return TovarPPM(default_mib, node_cap_mib, improved=True)
    if name == "sizey":
        from repro_torch.core.sizey import SizeyPortfolio  # deferred: sizey builds on this module

        return SizeyPortfolio(default_mib)
    raise ValueError(f"unknown baseline: {name!r}")
