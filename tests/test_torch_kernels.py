"""segmax and wastage: the port's plain versions against the reference (its
jnp functions and its Pallas kernels in interpret mode) on the same seeded
inputs, and the dispatch by device.  The hand-written kernels themselves are
held against these plain versions on the card by tests/test_torch_cuda.py.

Tolerances: segment peaks and fail indices exact; wastage rtol 1e-5 with
atol 1e-4 GiB*s, because the f32 sums over a series run in another order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.segmentation import segment_bounds as ref_bounds
from repro.core.segmentation import segment_peaks_dynamic as ref_peaks_dynamic
from repro.kernels import ops as ref_ops
from repro.sim.jax_sim import _attempt as ref_attempt
from repro_torch.core.allocation import attempt_outcomes_batch
from repro_torch.core.segmentation import segment_bounds, segment_peaks, segment_peaks_dynamic
from repro_torch.kernels import ops

WASTE_TOL = dict(rtol=1e-5, atol=1e-4)


def _series(seed: int, B: int, T: int, min_len: int = 0):
    rng = np.random.default_rng(seed)
    y = (rng.random((B, T)) * 4000.0 + 10.0).astype(np.float32)
    lengths = rng.integers(min_len, T + 1, size=B).astype(np.int32)
    lengths[:4] = [min_len, 1, 2, 3][: min(4, B)]  # shorter than k
    lengths[-1] = T
    return y, lengths


@pytest.mark.parametrize("k", [1, 4, 15])
def test_segment_bounds_match_reference(k):
    lengths = np.arange(0, 70, dtype=np.int32)
    for got, want in zip(segment_bounds(torch.from_numpy(lengths), k), ref_bounds(jnp.asarray(lengths), k)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("k_max", [1, 4, 15])
def test_segmax_plain_matches_reference_per_k_eff(k_max):
    y, lengths = _series(0, 48, 77)
    for k_eff in range(1, k_max + 1):
        want = np.asarray(ref_peaks_dynamic(jnp.asarray(y), jnp.asarray(lengths), k_eff, k_max))
        got = segment_peaks_dynamic(torch.from_numpy(y), torch.from_numpy(lengths), k_eff, k_max).numpy()
        np.testing.assert_array_equal(got, want)


def test_segmax_plain_with_ragged_k_eff_per_row():
    y, lengths = _series(1, 60, 40)
    k_max = 15
    k_eff = (np.arange(60) % k_max + 1).astype(np.int32)
    got = segment_peaks_dynamic(torch.from_numpy(y), torch.from_numpy(lengths), torch.from_numpy(k_eff), k_max).numpy()
    for ke in np.unique(k_eff):
        rows = k_eff == ke
        want = np.asarray(ref_peaks_dynamic(jnp.asarray(y[rows]), jnp.asarray(lengths[rows]), int(ke), k_max))
        np.testing.assert_array_equal(got[rows], want)


@pytest.mark.parametrize("k", [1, 4, 7])
def test_segmax_plain_matches_pallas_kernel(k):
    y, lengths = _series(2, 20, 600, min_len=1)  # the Pallas wrapper takes lengths >= 1
    want = np.asarray(ref_ops.segment_peaks(jnp.asarray(y), jnp.asarray(lengths), k))
    got = segment_peaks(torch.from_numpy(y), torch.from_numpy(lengths), k).numpy()
    np.testing.assert_array_equal(got, want)


def test_segmax_dispatch_reads_rows_by_series():
    y, lengths = _series(3, 10, 33)
    series = torch.tensor([9, 0, 0, 4, 9, 2], dtype=torch.int32)
    k_eff = torch.tensor([4, 4, 2, 1, 3, 4], dtype=torch.int32)
    yt, lt = torch.from_numpy(y), torch.from_numpy(lengths)
    got = ops.segment_peaks(yt, lt, series, k_eff, 4)
    want = segment_peaks_dynamic(yt[series.long()], lt[series.long()], k_eff, 4)
    assert torch.equal(got, want)


def _schedules(seed: int, B: int, T: int, k: int, interval: float):
    """Monotone step schedules with some boundaries exactly on sample
    midpoints and some +inf (the k = 1 baselines' rows)."""
    rng = np.random.default_rng(seed)
    mids = (rng.integers(0, T, size=(B, k)) + 0.5) * interval
    free = np.sort(rng.random((B, k)) * T * interval, axis=1)
    bounds = np.sort(np.where(rng.random((B, k)) < 0.5, mids, free), axis=1).astype(np.float32)
    bounds[:, -1] = np.inf
    bounds[::5] = np.inf
    values = np.sort(rng.random((B, k)) * 4500.0 + 50.0, axis=1).astype(np.float32)
    return bounds, values


@pytest.mark.parametrize("k", [1, 4, 15])
def test_wastage_plain_matches_reference_attempt(k):
    interval = 2.0
    y, lengths = _series(4, 64, 300)
    bounds, values = _schedules(5, 64, 300, k, interval)
    failed, fail_idx, w = jax.vmap(lambda yy, ll, b, v: ref_attempt(yy, ll, interval, b, v))(
        jnp.asarray(y), jnp.asarray(lengths), jnp.asarray(bounds), jnp.asarray(values)
    )
    want_idx = np.where(np.asarray(failed), np.asarray(fail_idx), -1)
    got_w, got_idx = attempt_outcomes_batch(
        torch.from_numpy(y), torch.from_numpy(lengths), interval, torch.from_numpy(bounds), torch.from_numpy(values)
    )
    assert 0 < (want_idx >= 0).sum() < len(want_idx)  # both outcomes are exercised
    np.testing.assert_array_equal(got_idx.numpy(), want_idx)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(w), **WASTE_TOL)


def test_wastage_plain_matches_pallas_kernel():
    interval = 2.0
    y, lengths = _series(6, 24, 700)
    bounds, values = _schedules(7, 24, 700, 4, interval)
    want_w, want_idx = ref_ops.attempt_wastage(
        jnp.asarray(y), jnp.asarray(lengths), jnp.asarray(bounds), jnp.asarray(values), interval
    )
    got_w, got_idx = attempt_outcomes_batch(
        torch.from_numpy(y), torch.from_numpy(lengths), interval, torch.from_numpy(bounds), torch.from_numpy(values)
    )
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), **WASTE_TOL)


def test_wastage_dispatch_reads_rows_by_series():
    y, lengths = _series(8, 6, 50)
    bounds, values = _schedules(9, 5, 50, 4, 2.0)
    series = torch.tensor([5, 0, 5, 3, 1], dtype=torch.int32)
    yt, lt = torch.from_numpy(y), torch.from_numpy(lengths)
    bt, vt = torch.from_numpy(bounds), torch.from_numpy(values)
    got = ops.attempt_wastage(yt, lt, series, bt, vt, 2.0)
    want = attempt_outcomes_batch(yt[series.long()], lt[series.long()], 2.0, bt, vt)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
