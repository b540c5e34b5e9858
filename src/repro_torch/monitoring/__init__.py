"""Time-series monitoring (paper Fig. 6; port of ``repro.monitoring``): an
Influx-like in-memory store, and a /proc-based RSS collector so the
predictor can monitor real local processes as well as simulated ones."""

from repro_torch.monitoring.store import SeriesPoint, TimeSeriesStore
from repro_torch.monitoring.collector import MemoryMonitor, sample_rss_mib

__all__ = ["SeriesPoint", "TimeSeriesStore", "MemoryMonitor", "sample_rss_mib"]
