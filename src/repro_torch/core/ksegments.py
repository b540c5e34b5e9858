"""k-Segments configuration, the host model, and the engine's carry.

The model (two regression banks plus error offsets, Sec. III) exists twice.
The engine (``repro_torch.sim.torch_sim``) evaluates it for every execution
of a task at once, in tensors; ``KSegmentsModel`` here is the online host
model, one observation at a time in float64 numpy, a copy of
``repro.core.ksegments.KSegmentsModel`` (the serving admission controller
learns with it).  ``carry_from_numpy``/``carry_to_numpy`` move the learned
state between the two forms: the flat dict that ``KSegmentsModel.state()``
returns.

Units: MiB / seconds (see ``allocation.py``).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import regression
from repro_torch.core.allocation import StepAllocation
from repro_torch.core.segmentation import segment_peaks_np


@dataclasses.dataclass
class KSegmentsConfig:
    k: int = 4  # paper default
    interval_s: float = 2.0  # paper's monitoring interval
    floor_mib: float = 100.0  # paper: 100 MB minimum when the model predicts < 0
    retry_factor: float = 2.0  # paper default l = 2
    strategy: str = "selective"  # retry strategy: "selective" | "partial"
    # "insample": offsets are the extreme residuals of the current fit over
    # the history; "progressive": running max of one-step-ahead errors.
    error_mode: str = "insample"
    # Bounded-history insample: the last ``insample_window`` executions are
    # rescanned under the live fit; evicted ones keep their eviction-time
    # residual as a running maximum.  The engine needs it set (>= 1) in
    # insample mode.  ``None`` (the host model only) keeps every execution
    # and refreshes the extremes when the fit has drifted by more than
    # ``insample_refresh_tol`` of the offset scale.
    insample_window: int | None = None
    insample_refresh_tol: float = 1e-3
    # "absolute" offsets (MiB / seconds, the paper) or "relative" (KS+:
    # residuals normalized by the prediction, the ``"ksplus"`` method, which
    # the engine, ``sim.torch_sim``, also runs).
    offset_mode: str = "absolute"


_CARRY_ARRAYS = ("rt_stats", "rt_over_err", "seg_stats", "seg_under_err")


def carry_from_numpy(state: dict, device, dtype=torch.float32) -> dict:
    """Tensors of a k-Segments state dict (``rt_stats`` (5,),
    ``rt_over_err`` (), ``seg_stats`` (k, 5), ``seg_under_err`` (k,), and
    the input shift ``x0``, which stays a Python float)."""
    carry = {name: torch.as_tensor(np.asarray(state[name]), dtype=dtype, device=device) for name in _CARRY_ARRAYS}
    carry["x0"] = float(state["x0"])
    return carry


def carry_to_numpy(carry: dict) -> dict:
    """The state dict of a carry, as float64 numpy arrays."""
    state = {name: carry[name].detach().cpu().numpy().astype(np.float64) for name in _CARRY_ARRAYS}
    state["rt_over_err"] = float(state["rt_over_err"])
    state["x0"] = float(carry["x0"])
    return state


class KSegmentsModel:
    """Online k-Segments predictor for a single task type."""

    def __init__(self, config: KSegmentsConfig | None = None):
        self.config = config or KSegmentsConfig()
        if self.config.error_mode not in ("insample", "progressive"):
            raise ValueError(f"unknown error_mode {self.config.error_mode!r}")
        if self.config.offset_mode not in ("absolute", "relative"):
            raise ValueError(f"unknown offset_mode {self.config.offset_mode!r}")
        if self.config.insample_window is not None and self.config.insample_window < 1:
            raise ValueError("insample_window must be >= 1 (or None for unbounded)")
        k = self.config.k
        self._rt_stats = np.zeros(regression.NUM_STATS, dtype=np.float64)
        self._rt_over_err = 0.0  # max(pred_runtime - actual_runtime, 0) over history
        self._seg_stats = np.zeros((k, regression.NUM_STATS), dtype=np.float64)
        self._seg_under_err = np.zeros(k, dtype=np.float64)  # max(actual_peak - pred, 0)
        self._n_obs = 0
        self._x0 = 0.0  # input-size reference shift (first observation), for conditioning
        # History for in-sample residual offsets (error_mode="insample"),
        # kept in amortized-growth buffers (rows [0, _n_obs) are live).
        self._hist_u = np.empty(0, dtype=np.float64)
        self._hist_rt = np.empty(0, dtype=np.float64)
        self._hist_peaks = np.empty((0, k), dtype=np.float64)
        # Lazy-refresh bookkeeping: the fits the stored residual extremes were
        # last computed under and the input-shift radius (a fit change
        # (da, db) moves any historical residual by at most |da| + |db|*umax).
        # The current drift bounds are *added* to the offsets at prediction
        # time, so a stale extreme is conservative, never unsafe.
        self._ref_fits: tuple | None = None
        self._rt_drift = 0.0
        self._seg_drift = 0.0
        self._umax = 0.0
        # Bounded-window mode: residual extremes of points evicted from the
        # window, frozen under their eviction-time fit (monotone maxima).
        self._ev_rt = -np.inf
        self._ev_seg = np.full(k, -np.inf, dtype=np.float64)

    # -- state ------------------------------------------------------------

    @property
    def n_observations(self) -> int:
        return self._n_obs

    def state(self) -> dict:
        """Flat state dict: the engine's carry (``carry_from_numpy``)."""
        return {
            "rt_stats": self._rt_stats.copy(),
            "rt_over_err": self._rt_over_err,
            "seg_stats": self._seg_stats.copy(),
            "seg_under_err": self._seg_under_err.copy(),
            "x0": self._x0,
        }

    # -- online learning ----------------------------------------------------

    def observe(self, input_size: float, series_mib: np.ndarray, *, peaks: np.ndarray | None = None) -> None:
        """Fold one finished execution into the model (O(k) given ``peaks``).

        ``peaks`` are the series' k-segment peaks; grid evaluators precompute
        them once per (trace, k) and pass them in, otherwise they are derived
        here (O(T)).
        """
        cfg = self.config
        runtime = len(series_mib) * cfg.interval_s
        if peaks is None:
            peaks = segment_peaks_np(np.asarray(series_mib, dtype=np.float64), cfg.k)
        else:
            peaks = np.asarray(peaks, dtype=np.float64)
        if self._n_obs == 0:
            self._x0 = float(input_size)
        u = float(input_size) - self._x0

        if cfg.error_mode == "progressive" and self._n_obs > 0:
            rt_pred = float(regression.predict_np(self._rt_stats, u))
            seg_pred = regression.predict_np(self._seg_stats, u)
            if cfg.offset_mode == "relative":
                self._rt_over_err = max(
                    self._rt_over_err, (rt_pred - runtime) / max(rt_pred, cfg.interval_s)
                )
                self._seg_under_err = np.maximum(
                    self._seg_under_err, (peaks - seg_pred) / np.maximum(seg_pred, cfg.floor_mib)
                )
            else:
                self._rt_over_err = max(self._rt_over_err, rt_pred - runtime)
                self._seg_under_err = np.maximum(self._seg_under_err, peaks - seg_pred)

        self._rt_stats = regression.update_stats_np(self._rt_stats, u, runtime)
        self._seg_stats = regression.update_stats_np(self._seg_stats, u, peaks)
        self._n_obs += 1

        if cfg.error_mode == "insample":
            self._observe_insample(u, runtime, peaks)

    def _residuals(self, rt_fit, seg_fit, hu, hrt, hpk) -> tuple[np.ndarray, np.ndarray]:
        """Residuals of a fit over history rows, in the configured offset
        units: runtime overprediction (rows,) and per-segment peak
        underprediction (rows, k) — absolute (seconds / MiB), or normalized by
        the (floored) prediction in the KS+ relative mode."""
        rt_pred = rt_fit[0] + rt_fit[1] * hu
        seg_pred = seg_fit[0][None, :] + seg_fit[1][None, :] * hu[:, None]
        rt_res = rt_pred - hrt
        seg_res = hpk - seg_pred
        if self.config.offset_mode == "relative":
            rt_res = rt_res / np.maximum(rt_pred, self.config.interval_s)
            seg_res = seg_res / np.maximum(seg_pred, self.config.floor_mib)
        return rt_res, seg_res

    def _observe_insample(self, u: float, runtime: float, peaks: np.ndarray) -> None:
        """Maintain the extreme residuals of the *current* fit over history.

        Recomputing them from scratch per observation is O(n) — O(n^2) per
        task.  Two bounded-cost schemes are implemented:

        * ``insample_window=W``: only the last W executions are rescanned
          exactly; a point leaving the window freezes its residual under the
          eviction-time fit into a monotone running maximum.  Offsets are
          exact over the window and conservative (never decaying) for evicted
          history — the same recurrence the batch engine carries.
        * unbounded (``insample_window=None``, absolute offsets): the stored
          extremes are extended with the new point's residual under the
          *reference* fit — the fit of the last exact rescan — so every stored
          extreme is a residual under ONE fit, and a drift bound covers them
          all uniformly: a fit change (d_intercept, d_slope) moves any
          residual by at most |d_intercept| + |d_slope| * max|u|.  (Folding
          under the *current* fit instead — a previous version's behaviour —
          let a point inserted mid-drift escape the bound by up to its
          insertion-time drift; the reference's tests pin the guarantee
          against a brute-force exact rescan.)  Only when the bound could
          move an offset materially (relative ``insample_refresh_tol``) is
          the full history rescanned — fits converge as observations
          accumulate, so refreshes thin out and amortized maintenance is
          O(1) per observation.

        Relative (KS+) offsets are not Lipschitz in the fit the way absolute
        residuals are (the normalizer moves with the prediction), so the
        unbounded relative mode rescans exactly every observation instead of
        using the drift bound — the windowed mode is the fast path there.
        """
        n = self._n_obs  # already includes this observation
        if n > len(self._hist_u):  # amortized doubling growth
            cap = max(2 * len(self._hist_u), 16)
            k = self._hist_peaks.shape[1]
            self._hist_u = np.resize(self._hist_u, cap)
            self._hist_rt = np.resize(self._hist_rt, cap)
            grown = np.empty((cap, k), dtype=np.float64)
            grown[: n - 1] = self._hist_peaks[: n - 1]
            self._hist_peaks = grown
        self._hist_u[n - 1] = u
        self._hist_rt[n - 1] = runtime
        self._hist_peaks[n - 1] = peaks
        self._umax = max(self._umax, abs(u))

        rt_fit = regression.fit_np(self._rt_stats)  # (intercept, slope) scalars
        seg_fit = regression.fit_np(self._seg_stats)  # ((k,), (k,))

        W = self.config.insample_window
        if W is not None:
            if n > W:
                # The oldest windowed point (n-1-W) leaves the window now:
                # freeze its residual under the eviction-time (current) fit.
                j = n - 1 - W
                rt_r, seg_r = self._residuals(
                    rt_fit, seg_fit, self._hist_u[j : j + 1], self._hist_rt[j : j + 1], self._hist_peaks[j : j + 1]
                )
                self._ev_rt = max(self._ev_rt, float(rt_r[0]))
                self._ev_seg = np.maximum(self._ev_seg, seg_r[0])
            lo = max(n - W, 0)
            rt_r, seg_r = self._residuals(
                rt_fit, seg_fit, self._hist_u[lo:n], self._hist_rt[lo:n], self._hist_peaks[lo:n]
            )
            self._rt_over_err = max(float(rt_r.max()), self._ev_rt)
            self._seg_under_err = np.maximum(np.max(seg_r, axis=0), self._ev_seg)
            self._rt_drift = self._seg_drift = 0.0
            return

        if self._ref_fits is None or self.config.offset_mode == "relative":
            self._refresh_insample(rt_fit, seg_fit)
            return
        ref_rt, ref_seg = self._ref_fits
        self._rt_drift = abs(rt_fit[0] - ref_rt[0]) + abs(rt_fit[1] - ref_rt[1]) * self._umax
        self._seg_drift = float(np.max(np.abs(seg_fit[0] - ref_seg[0]) + np.abs(seg_fit[1] - ref_seg[1]) * self._umax))

        # Fold the new point under the REFERENCE fit: every stored extreme is
        # then a residual under the same fit, and "exact <= stored + drift"
        # holds for all of history uniformly (|u| <= umax covers this point).
        rt_r, seg_r = self._residuals(
            ref_rt, ref_seg, self._hist_u[n - 1 : n], self._hist_rt[n - 1 : n], self._hist_peaks[n - 1 : n]
        )
        self._rt_over_err = max(self._rt_over_err, float(rt_r[0]))
        self._seg_under_err = np.maximum(self._seg_under_err, seg_r[0])

        tol = self.config.insample_refresh_tol
        if self._rt_drift > tol * (abs(self._rt_over_err) + 1.0) or self._seg_drift > tol * (
            float(np.max(np.abs(self._seg_under_err))) + 1.0
        ):
            self._refresh_insample(rt_fit, seg_fit)

    def _refresh_insample(self, rt_fit, seg_fit) -> None:
        """Exact O(n) rescan of the residual extremes under the current fit."""
        n = self._n_obs
        rt_res, seg_res = self._residuals(
            rt_fit, seg_fit, self._hist_u[:n], self._hist_rt[:n], self._hist_peaks[:n]
        )
        self._rt_over_err = float(rt_res.max())  # largest runtime overprediction
        self._seg_under_err = np.max(seg_res, axis=0)
        self._ref_fits = (rt_fit, seg_fit)
        self._rt_drift = self._seg_drift = 0.0

    # -- prediction ---------------------------------------------------------

    def predict_runtime(self, input_size: float) -> float:
        """Offset (under-)predicted runtime, floored at one interval."""
        cfg = self.config
        raw = float(regression.predict_np(self._rt_stats, float(input_size) - self._x0))
        # + drift: a possibly-stale insample extreme stays conservative.
        off = max(self._rt_over_err + self._rt_drift, 0.0)
        if cfg.offset_mode == "relative":  # KS+: offsets scale with the prediction
            off = off * max(raw, cfg.interval_s)
        return max(raw - off, cfg.interval_s)

    def predict(self, input_size: float) -> StepAllocation:
        """Paper Sec. III-C: the monotone k-step allocation for a new run."""
        cfg = self.config
        k = cfg.k
        r_e = self.predict_runtime(input_size)
        # Boundaries r_i = i * r_e/k (continuous form of the paper's
        # r_s = floor(r_e / k); flooring to whole seconds is an artifact of
        # the paper's integer clock and degenerates for r_e < k).
        bounds = np.arange(1, k + 1, dtype=np.float64) * (r_e / k)
        bounds[-1] = r_e

        v = np.asarray(
            regression.predict_np(self._seg_stats, float(input_size) - self._x0), dtype=np.float64
        )
        if cfg.offset_mode == "relative":
            v = v + np.maximum(self._seg_under_err + self._seg_drift, 0.0) * np.maximum(v, cfg.floor_mib)
        else:
            v = v + np.maximum(self._seg_under_err + self._seg_drift, 0.0)
        if v[0] < 0:  # paper: negative first prediction -> 100 MB default
            v[0] = cfg.floor_mib
        v = np.maximum.accumulate(v)  # monotone: v_s := max(v_s, v_{s-1})
        v = np.maximum(v, cfg.floor_mib)
        return StepAllocation(bounds, v)

    def predict_batch(self, input_sizes: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Vectorized ``predict`` over C input sizes: ((C, k) boundaries,
        (C, k) values), with row ``i`` bit-identical to
        ``predict(input_sizes[i])`` — every op is the same elementwise IEEE
        expression, just broadcast over the batch axis.  The batched admission
        engine relies on that equality to reproduce the scalar controller's
        decisions exactly."""
        cfg = self.config
        k = cfg.k
        u = np.asarray(input_sizes, dtype=np.float64) - self._x0  # (C,)
        raw = regression.predict_np(self._rt_stats, u)
        rt_off = max(self._rt_over_err + self._rt_drift, 0.0)
        if cfg.offset_mode == "relative":
            r_e = np.maximum(raw - rt_off * np.maximum(raw, cfg.interval_s), cfg.interval_s)
        else:
            r_e = np.maximum(raw - rt_off, cfg.interval_s)
        bounds = np.arange(1, k + 1, dtype=np.float64)[None, :] * (r_e[:, None] / k)
        bounds[:, -1] = r_e

        v = regression.predict_np(self._seg_stats, u[:, None])  # (C, k)
        if cfg.offset_mode == "relative":
            v = v + np.maximum(self._seg_under_err + self._seg_drift, 0.0)[None, :] * np.maximum(v, cfg.floor_mib)
        else:
            v = v + np.maximum(self._seg_under_err + self._seg_drift, 0.0)[None, :]
        neg = v[:, 0] < 0
        v[neg, 0] = cfg.floor_mib
        v = np.maximum.accumulate(v, axis=1)
        v = np.maximum(v, cfg.floor_mib)
        return bounds, v
