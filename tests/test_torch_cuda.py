"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card.  These tests need a CUDA card and skip without one; they import
nothing of JAX, so they run where only PyTorch is installed:

    python -m pytest -q tests/test_torch_cuda.py

Tolerances: segment peaks, fail indices, range-max tables, compacted rows
and cluster placements exact; wastage rtol 1e-5 with atol 1e-4 GiB*s when
summed in f32, rtol 1e-9 with atol 1e-9 GiB*s when summed in f64, because
the sums over a series run in another order."""

import numpy as np
import pytest
import torch

from repro_torch.core.allocation import attempt_outcomes_batch
from repro_torch.core.segmentation import segment_peaks_dynamic
from repro_torch.kernels import compaction, ops, rangemax, segmax, wastage

WASTE_TOL = dict(rtol=1e-5, atol=1e-4)
WASTE_TOL_F64 = dict(rtol=1e-9, atol=1e-9)


def _series(seed: int, B: int, T: int):
    rng = np.random.default_rng(seed)
    y = (rng.random((B, T)) * 4000.0 + 10.0).astype(np.float32)
    lengths = rng.integers(0, T + 1, size=B).astype(np.int32)
    lengths[:4] = [0, 1, 2, 3]  # shorter than k
    lengths[-1] = T
    return y, lengths


def _schedules(seed: int, B: int, T: int, k: int, interval: float):
    """Monotone step schedules, some boundaries on sample midpoints, some +inf."""
    rng = np.random.default_rng(seed)
    mids = (rng.integers(0, T, size=(B, k)) + 0.5) * interval
    free = np.sort(rng.random((B, k)) * T * interval, axis=1)
    bounds = np.sort(np.where(rng.random((B, k)) < 0.5, mids, free), axis=1).astype(np.float32)
    bounds[:, -1] = np.inf
    bounds[::5] = np.inf
    values = np.sort(rng.random((B, k)) * 4500.0 + 50.0, axis=1).astype(np.float32)
    return bounds, values


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the hand-written kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("k_max", [4, 15])
def test_segmax_kernel_matches_plain_on_card(cuda, k_max):
    y, lengths = _series(10, 300, 2048)
    yt, lt = torch.from_numpy(y).to(cuda), torch.from_numpy(lengths).to(cuda)
    series = torch.arange(300, dtype=torch.int32, device=cuda).repeat(2)
    k_eff = (torch.arange(600, device=cuda) % k_max + 1).to(torch.int32)
    before = segmax.launches
    got = ops.segment_peaks(yt, lt, series, k_eff, k_max)
    assert segmax.launches == before + 1
    want = segment_peaks_dynamic(yt[series], lt[series], k_eff, k_max)
    assert torch.equal(got, want)


@pytest.mark.parametrize("k", [1, 4, 15])
def test_wastage_kernel_matches_plain_on_card(cuda, k):
    y, lengths = _series(11, 300, 2048)
    bounds, values = _schedules(12, 900, 2048, k, 2.0)
    yt, lt = torch.from_numpy(y).to(cuda), torch.from_numpy(lengths).to(cuda)
    bt, vt = torch.from_numpy(bounds).to(cuda), torch.from_numpy(values).to(cuda)
    series = torch.arange(300, dtype=torch.int32, device=cuda).repeat_interleave(3)
    before = wastage.launches
    got_w, got_idx = ops.attempt_wastage(yt, lt, series, bt, vt, 2.0)
    assert wastage.launches == before + 1
    want_w, want_idx = attempt_outcomes_batch(yt[series], lt[series], 2.0, bt, vt)
    assert torch.equal(got_idx, want_idx)
    torch.testing.assert_close(got_w, want_w, **WASTE_TOL)


@pytest.mark.parametrize("vdt,acc", [(torch.float32, torch.float64), (torch.float64, torch.float64)])
def test_wastage_kernel_f64_sums_match_plain_on_card(cuda, vdt, acc):
    y, lengths = _series(13, 300, 2048)
    bounds, values = _schedules(14, 900, 2048, 4, 2.0)
    yt, lt = torch.from_numpy(y).to(cuda), torch.from_numpy(lengths).to(cuda)
    bt, vt = torch.from_numpy(bounds).to(cuda, vdt), torch.from_numpy(values).to(cuda, vdt)
    if vdt == torch.float64:  # values that float32 cannot hold
        vt = vt * (1.0 + 1e-9)
    series = torch.arange(300, dtype=torch.int32, device=cuda).repeat_interleave(3)
    before = wastage.launches
    got_w, got_idx = ops.attempt_wastage(yt, lt, series, bt, vt, 2.0, acc)
    assert wastage.launches == before + 1 and got_w.dtype == acc
    want_w, want_idx = attempt_outcomes_batch(yt[series], lt[series], 2.0, bt, vt, acc)
    assert torch.equal(got_idx, want_idx)
    torch.testing.assert_close(got_w, want_w, **WASTE_TOL_F64)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("L", [1, 77, 256, 1024, 8192])  # f64 at 8192 takes the global-memory path
def test_rangemax_kernel_matches_plain_on_card(cuda, dtype, L):
    rng = np.random.default_rng(L)
    x = np.round(rng.standard_normal((16, L)) * 3e4, 1)
    x[rng.random((16, L)) < 0.3] = -np.inf
    xt = torch.from_numpy(x).to(cuda, dtype)
    before = rangemax.launches
    got = ops.range_max_table(xt)
    assert rangemax.launches == before + 1
    assert torch.equal(got, rangemax.table_levels(xt))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["none", "all", "half"])
@pytest.mark.parametrize("L", [1, 77, 256, 8192])
def test_compaction_kernel_matches_plain_on_card(cuda, dtype, mode, L):
    rng = np.random.default_rng(L + 1)
    t = np.sort(rng.random((64, L)) * 1e4, axis=1)
    fin = np.arange(L)[None, :] < rng.integers(0, L + 1, size=64)[:, None]
    t = np.where(fin, t, np.inf)
    d = np.where(fin, rng.standard_normal((64, L)) * 512.0, 0.0)
    keep = {"none": fin, "all": np.zeros_like(fin), "half": fin & (rng.random((64, L)) < 0.5)}[mode]
    tt, dd = torch.from_numpy(t).to(cuda, dtype), torch.from_numpy(d).to(cuda, dtype)
    kk = torch.from_numpy(keep).to(cuda)
    before = compaction.launches
    got_t, got_d = ops.compact_events(tt, dd, kk)
    assert compaction.launches == before + 1
    want_t, want_d = compaction.compact_events_plain(tt, dd, kk)
    assert torch.equal(got_t, want_t) and torch.equal(got_d, want_d)


@pytest.mark.parametrize("placement,x64", [("windows", False), ("sweep", False), ("windows", True)])
def test_cluster_on_card_matches_cpu_run(cuda, placement, x64):
    """The whole cluster path on the card: the same placements as the port's
    own CPU run, through the rangemax (windows) or compaction (sweep) kernel."""
    from repro_torch.sim.cluster import run_cluster_batched
    from repro_torch.sim.traces import generate_workflow

    wfs = [generate_workflow("eager", seed=7, scale=0.25)]
    policies = ("default", "witt-lr", "ksegments-selective")
    kw = dict(n_nodes=2, node_mib=24 * 1024.0, max_tasks_per_type=12, min_executions=6, train_frac=0.5,
              placement=placement, ladder_x64=x64)
    ops.reset_launch_counts()
    got = run_cluster_batched(wfs, policies, **kw)
    counts = ops.launch_counts()
    want = run_cluster_batched(wfs, policies, device="cpu", **kw)
    assert counts["wastage"] > 0 and counts["segmax"] > 0
    assert counts["rangemax" if placement == "windows" else "compaction"] > 0
    for p in policies:
        assert got[p].retries == want[p].retries
        assert got[p].makespan_s == want[p].makespan_s
        for g, w in zip(got[p].records, want[p].records, strict=True):
            assert g.placements == w.placements
        np.testing.assert_allclose(got[p].wastage_gib_s, want[p].wastage_gib_s, rtol=1e-6)
