"""The port's kernels API (``repro_torch.kernels``: ``fit_stats``,
``segment_peaks``, ``attempt_wastage``) on the CPU against the reference's
(``repro.kernels.ops``, its Pallas kernels in interpret mode, and the jnp
oracles of ``repro.kernels.ref``), at ``tests/test_kernels.py``'s shapes,
seeds and tolerances: segment peaks rtol 1e-6; the fitstats bank rtol 1e-4
with atol 1e-2 (float32 sums in another order); wastage fail indices exact,
waste rtol 1e-4 with atol 1e-3 GiB*s."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import ref
from repro_torch import kernels
from repro_torch.kernels import fitstats

SHAPES = [(3, 100, 4), (8, 512, 4), (17, 1333, 7), (1, 5, 4), (5, 2048, 1), (12, 600, 16), (9, 513, 3)]
DTYPES = [np.float32, np.float64]


def test_api_exports_the_reference_names():
    assert sorted(kernels.__all__) == ["attempt_wastage", "fit_stats", "flash_attention", "segment_peaks"]


@pytest.mark.parametrize("B,T,k", SHAPES)
def test_fit_stats_matches_reference(B, T, k):
    rng = np.random.default_rng(B + T + k)
    x = rng.uniform(-50, 50, B)
    peaks = rng.uniform(0, 1e3, (B, k)).astype(np.float32)
    valid = rng.integers(0, 2, B)
    got = kernels.fit_stats(torch.from_numpy(x), torch.from_numpy(peaks), torch.from_numpy(valid))
    assert got.dtype == torch.float32 and tuple(got.shape) == (k, 5)
    for want in (ref_ops.fit_stats, ref.fit_stats):
        want = np.asarray(want(jnp.asarray(x), jnp.asarray(peaks), jnp.asarray(valid)))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-2)


def _masked_poison(B: int, k: int, bad):
    rng = np.random.default_rng(B * k)
    x = rng.uniform(-50, 50, B).astype(np.float32)
    peaks = rng.uniform(0, 1e3, (B, k)).astype(np.float32)
    valid = np.ones(B, np.float32)
    valid[B // 2] = 0.0
    peaks[B // 2, k - 1] = bad
    return x, peaks, valid


@pytest.mark.parametrize("bad", [np.nan, np.inf])
def test_fit_stats_masked_row_poisons_the_bank_as_in_reference(bad):
    """Weight 0 times NaN or inf is NaN: the masked row is not skipped."""
    x, peaks, valid = _masked_poison(37, 5, bad)
    got = kernels.fit_stats(torch.from_numpy(x), torch.from_numpy(peaks), torch.from_numpy(valid)).numpy()
    want = np.asarray(ref_ops.fit_stats(jnp.asarray(x), jnp.asarray(peaks), jnp.asarray(valid)))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    assert np.isnan(got[-1, 3]) and np.isnan(got[-1, 4]) and np.isfinite(got[:-1]).all()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


@pytest.mark.parametrize("B,T,k", SHAPES)
def test_fit_stats_non_binary_weights_match_reference(B, T, k):
    rng = np.random.default_rng(7 * B + k)
    x = rng.uniform(-50, 50, B)
    peaks = rng.uniform(0, 1e3, (B, k))
    valid = rng.uniform(0.0, 2.0, B)
    got = kernels.fit_stats(torch.from_numpy(x), torch.from_numpy(peaks), torch.from_numpy(valid)).numpy()
    want = np.asarray(ref_ops.fit_stats(jnp.asarray(x), jnp.asarray(peaks), jnp.asarray(valid)))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-2)


def test_fit_stats_refuses_more_than_128_segments():
    kernels.fit_stats(torch.zeros(3), torch.zeros((3, fitstats.MAX_K)), torch.ones(3))
    with pytest.raises(ValueError, match="k <= 128"):
        kernels.fit_stats(torch.zeros(3), torch.zeros((3, fitstats.MAX_K + 1)), torch.ones(3))


@pytest.mark.parametrize("B,k", [(0, 4), (1, 1), (512, 4), (1512, 15), (1 << 20, 128), (5000, 3)])
def test_fitstats_grid_covers_every_row_in_one_wave(B, k):
    rows, blocks = fitstats.grid(B, k)
    assert rows * blocks >= B and (blocks - 1) * rows < max(B, 1)
    assert 1 <= blocks <= fitstats.MAX_BLOCKS


@pytest.mark.parametrize("B,T,k", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_segment_peaks_matches_reference(B, T, k, dtype):
    rng = np.random.default_rng(B * 1000 + T + k)
    y = rng.uniform(1, 1e4, (B, T)).astype(dtype)
    lengths = rng.integers(1, T + 1, B).astype(np.int32)
    lengths[0] = 0  # counts as 1
    got = kernels.segment_peaks(torch.from_numpy(y), torch.from_numpy(lengths), k)
    assert got.dtype == torch.float32
    want = np.asarray(ref_ops.segment_peaks(jnp.asarray(y, jnp.float32), jnp.asarray(lengths), k))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("B,T,k", SHAPES)
def test_attempt_wastage_matches_reference(B, T, k):
    rng = np.random.default_rng(B * 7 + T + k)
    y = rng.uniform(1, 1200, (B, T)).astype(np.float32)
    lengths = rng.integers(1, T + 1, B).astype(np.int32)
    bounds = np.sort(rng.uniform(1, T * 2.0, (B, k)), axis=1).astype(np.float32)
    values = np.maximum.accumulate(rng.uniform(10, 1400, (B, k)), axis=1).astype(np.float32)
    wk, ik = kernels.attempt_wastage(*(torch.from_numpy(a) for a in (y, lengths, bounds, values)), 2.0)
    wr, ir = ref_ops.attempt_wastage(jnp.asarray(y), jnp.asarray(lengths), jnp.asarray(bounds), jnp.asarray(values), 2.0)
    np.testing.assert_array_equal(ik.numpy(), np.asarray(ir))
    np.testing.assert_allclose(wk.numpy(), np.asarray(wr), rtol=1e-4, atol=1e-3)


def test_attempt_wastage_failure_across_blocks_as_in_reference():
    """The reference's failure-state case: a failure in a late T-block."""
    B, T = 8, 1536
    y = np.full((B, T), 10.0, np.float32)
    y[:, 1100] = 1e6
    w, fi = kernels.attempt_wastage(torch.from_numpy(y), torch.full((B,), T), torch.full((B, 1), T * 2.0),
                                    torch.full((B, 1), 50.0), 2.0)
    assert torch.all(fi == 1100)
    np.testing.assert_allclose(w.numpy(), 50.0 * 1101 * 2.0 / 1024.0, rtol=1e-5)


def test_api_takes_tensors_only_and_has_no_fallback():
    with pytest.raises(TypeError, match="torch.Tensor"):
        kernels.fit_stats(np.zeros(3), np.zeros((3, 2)), np.ones(3))
    with pytest.raises(TypeError, match="torch.Tensor"):
        kernels.segment_peaks(np.zeros((2, 4)), torch.ones(2), 2)
    meta = dict(device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        kernels.fit_stats(torch.zeros(3, **meta), torch.zeros((3, 2), **meta), torch.ones(3, **meta))
