"""In-memory time-series store with an InfluxDB-flavoured API (a copy of
``repro.monitoring.store``).

The paper's prototype stores periodic cgroup metrics in InfluxDB keyed by
task; Nextflow and the memory predictor both read from it.  This store is the
offline-friendly equivalent: measurements are (series_key, field, time, value)
rows; the predictor-facing query returns a task execution's memory series as a
dense array on the monitoring grid.
"""

from __future__ import annotations

import bisect
import dataclasses
import threading

import numpy as np


@dataclasses.dataclass
class SeriesPoint:
    t: float  # seconds since execution start
    value: float


class TimeSeriesStore:
    """Thread-safe append-only store: (task_type, execution_id) -> series."""

    def __init__(self, interval_s: float = 2.0):
        self.interval_s = interval_s
        self._lock = threading.Lock()
        self._series: dict[tuple[str, str], list[SeriesPoint]] = {}
        self._meta: dict[tuple[str, str], dict] = {}

    # -- write path (collector) -------------------------------------------

    def write(self, task_type: str, execution_id: str, t: float, value: float) -> None:
        with self._lock:
            self._series.setdefault((task_type, execution_id), []).append(SeriesPoint(t, value))

    def annotate(self, task_type: str, execution_id: str, **meta) -> None:
        """Attach metadata (e.g. total input size in bytes) to an execution."""
        with self._lock:
            self._meta.setdefault((task_type, execution_id), {}).update(meta)

    # -- read path (memory predictor) --------------------------------------

    def executions(self, task_type: str) -> list[str]:
        with self._lock:
            return sorted(eid for (tt, eid) in self._series if tt == task_type)

    def task_types(self) -> list[str]:
        with self._lock:
            return sorted({tt for (tt, _) in self._series})

    def metadata(self, task_type: str, execution_id: str) -> dict:
        with self._lock:
            return dict(self._meta.get((task_type, execution_id), {}))

    def series(self, task_type: str, execution_id: str) -> np.ndarray:
        """The execution's memory series resampled onto the monitoring grid
        (last-observation-carried-forward, like a Grafana query)."""
        with self._lock:
            pts = list(self._series.get((task_type, execution_id), []))
        if not pts:
            return np.zeros(0, dtype=np.float32)
        pts.sort(key=lambda p: p.t)
        ts = [p.t for p in pts]
        end = ts[-1]
        n = max(int(np.floor(end / self.interval_s)) + 1, 1)
        grid = np.arange(n) * self.interval_s
        out = np.empty(n, dtype=np.float32)
        for i, g in enumerate(grid):
            j = bisect.bisect_right(ts, g) - 1
            out[i] = pts[max(j, 0)].value
        return out
