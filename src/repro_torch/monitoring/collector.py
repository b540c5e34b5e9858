"""Process-memory collector: the offline stand-in for the paper's
Docker-API/cgroup monitor (a copy of ``repro.monitoring.collector``).

``sample_rss_mib`` reads VmRSS from ``/proc/<pid>/status`` (own process by
default) — the same kernel accounting the cgroup memory controller exposes,
so the predictor sees equivalent numbers without a container runtime.
``MemoryMonitor`` samples it on the paper's 2 s interval (configurable) in a
daemon thread and writes into a ``TimeSeriesStore``, giving real local task
executions genuine monitoring series.
"""

from __future__ import annotations

import os
import threading
import time

from repro_torch.monitoring.store import TimeSeriesStore


def sample_rss_mib(pid: int | None = None) -> float:
    """Resident set size of a process in MiB (0.0 if unreadable)."""
    path = f"/proc/{pid or os.getpid()}/status"
    try:
        with open(path) as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return float(line.split()[1]) / 1024.0  # kB -> MiB
    except OSError:
        pass
    return 0.0


class MemoryMonitor:
    """Context manager recording a task execution's memory series.

    >>> store = TimeSeriesStore(interval_s=0.1)
    >>> with MemoryMonitor(store, "train_step", "exec-0", interval_s=0.1):
    ...     do_work()
    >>> series = store.series("train_step", "exec-0")
    """

    def __init__(
        self,
        store: TimeSeriesStore,
        task_type: str,
        execution_id: str,
        interval_s: float = 2.0,
        pid: int | None = None,
        input_size: float | None = None,
    ):
        self.store = store
        self.task_type = task_type
        self.execution_id = execution_id
        self.interval_s = interval_s
        self.pid = pid
        self.input_size = input_size
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._t0 = 0.0

    def _loop(self) -> None:
        while not self._stop.is_set():
            t = time.monotonic() - self._t0
            self.store.write(self.task_type, self.execution_id, t, sample_rss_mib(self.pid))
            self._stop.wait(self.interval_s)

    def __enter__(self) -> "MemoryMonitor":
        self._t0 = time.monotonic()
        if self.input_size is not None:
            self.store.annotate(self.task_type, self.execution_id, input_size=self.input_size)
        self.store.write(self.task_type, self.execution_id, 0.0, sample_rss_mib(self.pid))
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        # final sample so short tasks still get a series
        t = time.monotonic() - self._t0
        self.store.write(self.task_type, self.execution_id, t, sample_rss_mib(self.pid))
