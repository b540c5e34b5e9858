"""The port's monitoring (``repro_torch.monitoring``) against the
reference's: the store's grid resampling on the same writes, its listing
and metadata, and a live ``MemoryMonitor`` series of this process."""

import time

import numpy as np
import pytest

from repro.monitoring import TimeSeriesStore as RefStore
from repro_torch.monitoring import MemoryMonitor, TimeSeriesStore, sample_rss_mib


def test_store_grid_resampling_locf():
    store = TimeSeriesStore(interval_s=1.0)
    store.write("t", "e0", 0.0, 10.0)
    store.write("t", "e0", 2.5, 30.0)
    store.write("t", "e0", 4.0, 20.0)
    np.testing.assert_allclose(store.series("t", "e0"), [10, 10, 10, 30, 20])


@pytest.mark.parametrize("seed", range(4))
def test_store_resampling_matches_reference(seed):
    """Random, unordered writes to several executions: the same series."""
    rng = np.random.default_rng(seed)
    interval = float(rng.choice([0.05, 0.5, 2.0]))
    store, ref = TimeSeriesStore(interval_s=interval), RefStore(interval_s=interval)
    for _ in range(200):
        eid = f"e{int(rng.integers(0, 4))}"
        t, v = float(rng.uniform(0.0, 30.0)), float(rng.uniform(0.0, 1e4))
        store.write("task", eid, t, v)
        ref.write("task", eid, t, v)
    assert store.executions("task") == ref.executions("task")
    for eid in ref.executions("task"):
        got, want = store.series("task", eid), ref.series("task", eid)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert store.series("task", "missing").shape == ref.series("task", "missing").shape == (0,)


def test_store_metadata_and_listing():
    store = TimeSeriesStore()
    store.annotate("t", "e1", input_size=123.0)
    store.write("t", "e1", 0.0, 5.0)
    assert store.executions("t") == ["e1"]
    assert store.task_types() == ["t"]
    assert store.metadata("t", "e1")["input_size"] == 123.0


def test_rss_sampling_positive():
    assert sample_rss_mib() > 1.0  # this very process
    assert sample_rss_mib(pid=2**22 + 12345) == 0.0  # no such process


def test_memory_monitor_records_a_live_series():
    store = TimeSeriesStore(interval_s=0.05)
    with MemoryMonitor(store, "task", "e", interval_s=0.05, input_size=42.0):
        junk = [bytearray(2_000_000) for _ in range(20)]  # grow the RSS
        time.sleep(0.25)
        del junk
    series = store.series("task", "e")
    assert len(series) >= 2 and series.max() > 0
    assert store.metadata("task", "e")["input_size"] == 42.0
