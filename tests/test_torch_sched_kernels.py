"""rangemax and compaction: the port's plain versions against the reference
on the same seeded inputs -- its float64 jnp twins (``table_levels_jnp``,
``compact_events_jnp``) and its Pallas kernels in interpret mode in float32
-- and the dispatch by device.  The hand-written kernels themselves are held
against these plain versions on the card by tests/test_torch_cuda.py.

Tolerance: none.  A range maximum and a compaction move values without
arithmetic, so every comparison is bit for bit."""

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels.compaction import compact_events_jnp
from repro.kernels.rangemax import num_levels as ref_num_levels
from repro.kernels.rangemax import table_levels_jnp
from repro_torch.kernels import compaction, ops, rangemax, scan

LENGTHS = [1, 5, 77, 128, 300]


@pytest.fixture
def x64(monkeypatch):
    """The reference's float64 programs need ``jax.experimental.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    with jax.enable_x64(True):
        yield


def _demand_rows(seed: int, B: int, L: int, dtype) -> np.ndarray:
    """Running-sum-like rows with -inf at masked positions and repeats."""
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((B, L)) * 3e4, 1)
    x[rng.random((B, L)) < 0.3] = -np.inf
    x[:, 1::4] = x[:, ::4][:, : x[:, 1::4].shape[1]]  # ties
    return x.astype(dtype)


def _event_rows(seed: int, B: int, L: int, mode: str, dtype):
    """Sorted (time, delta) rows, +inf/0 padded tails, and a keep mask."""
    rng = np.random.default_rng(seed)
    t = np.sort(rng.random((B, L)) * 1e4, axis=1)
    n_fin = rng.integers(0, L + 1, size=B)
    fin = np.arange(L)[None, :] < n_fin[:, None]
    t = np.where(fin, t, np.inf).astype(dtype)
    d = np.where(fin, np.round(rng.standard_normal((B, L)) * 512.0, 2), 0.0).astype(dtype)
    keep = {"none": np.ones((B, L), bool), "all": np.zeros((B, L), bool),
            "half": rng.random((B, L)) < 0.5}[mode] & fin
    return t, d, keep


@pytest.mark.parametrize("L", LENGTHS)
def test_rangemax_plain_matches_jnp_twin_f64(x64, L):
    x = _demand_rows(L, 6, L, np.float64)
    want = np.asarray(table_levels_jnp(jnp.asarray(x)))
    got = rangemax.table_levels(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (6, ref_num_levels(L), L)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("L", LENGTHS)
def test_rangemax_plain_matches_pallas_f32(L):
    x = _demand_rows(100 + L, 5, L, np.float32)  # 5 rows: padded to the kernel's 8-row blocks
    want = np.asarray(ref_ops.range_max_table(jnp.asarray(x), interpret=True))
    got = rangemax.table_levels(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mode", ["none", "all", "half"])
@pytest.mark.parametrize("L", [1, 77, 300])
def test_compaction_plain_matches_jnp_twin_f64(x64, mode, L):
    t, d, keep = _event_rows(L, 7, L, mode, np.float64)
    want_t, want_d = compact_events_jnp(jnp.asarray(t), jnp.asarray(d), jnp.asarray(keep))
    got_t, got_d = compaction.compact_events_plain(torch.from_numpy(t), torch.from_numpy(d), torch.from_numpy(keep))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))
    assert (got_t.numpy()[:, : int(keep.sum(axis=1).min())] < np.inf).all()


@pytest.mark.parametrize("mode", ["none", "all", "half"])
@pytest.mark.parametrize("L", [1, 77, 300])
def test_compaction_plain_matches_pallas_f32(mode, L):
    t, d, keep = _event_rows(200 + L, 5, L, mode, np.float32)
    want_t, want_d = ref_ops.compact_events(jnp.asarray(t), jnp.asarray(d), jnp.asarray(keep), interpret=True)
    got_t, got_d = compaction.compact_events_plain(torch.from_numpy(t), torch.from_numpy(d), torch.from_numpy(keep))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_d.numpy(), np.asarray(want_d))


@pytest.mark.parametrize("L", [1, 2, 3, 8, 100, 8192])
def test_num_levels_matches_reference(L):
    assert rangemax.num_levels(L) == ref_num_levels(L)


def test_cpu_tensors_take_the_plain_versions_and_no_kernel():
    ops.reset_launch_counts()
    x = torch.from_numpy(_demand_rows(1, 4, 40, np.float64))
    assert torch.equal(ops.range_max_table(x), rangemax.table_levels(x))
    t, d, keep = (torch.from_numpy(a) for a in _event_rows(2, 4, 40, "half", np.float64))
    for got, want in zip(ops.compact_events(t, d, keep), compaction.compact_events_plain(t, d, keep)):
        assert torch.equal(got, want)
    assert torch.equal(ops.prefix_sum(x, -1, 16), scan.cumsum(x, 16))
    f64 = lambda *v: torch.tensor(v, dtype=torch.float64)  # noqa: E731
    admits = ops.admission_scan(f64(0.0, 1.0, float("inf")), f64(0.0, 0.0, 0.0), f64(0.0), f64(1.0), f64(2.0),
                                f64([2.0]), f64([1.0]), f64([1.0, 1.0]), f64([2.0]), torch.tensor([[False]]),
                                torch.tensor([True]), 1.5)
    assert admits.tolist() == [True]
    assert ops.launch_counts() == {"segmax": 0, "wastage": 0, "rangemax": 0, "compaction": 0, "fitstats": 0, "flash": 0,
                                   "scan": 0, "admission": 0, "admission_epoch": 0, "moe_dispatch": 0,
                                   "moe_combine": 0, "rwkv_wkv": 0, "rglru_scan": 0}


def test_dispatch_has_no_fallback_for_other_devices():
    x = torch.zeros((2, 8), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.range_max_table(x)
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.compact_events(x, x, torch.zeros((2, 8), dtype=torch.bool, device="meta"))
