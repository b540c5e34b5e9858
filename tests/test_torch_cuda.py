"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card.  These tests need a CUDA card and skip without one; they import
nothing of JAX, so they run where only PyTorch is installed:

    python -m pytest -q tests/test_torch_cuda.py

Tolerances: segment peaks and fail indices exact; wastage rtol 1e-5 with
atol 1e-4 GiB*s, because the f32 sums over a series run in another order."""

import numpy as np
import pytest
import torch

from repro_torch.core.allocation import attempt_outcomes_batch
from repro_torch.core.segmentation import segment_peaks_dynamic
from repro_torch.kernels import ops, segmax, wastage

WASTE_TOL = dict(rtol=1e-5, atol=1e-4)


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
