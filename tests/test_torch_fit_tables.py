"""The cluster's fit tables: ``rangemax.fit_tables_plain`` and the dispatch
``ops.fit_tables`` on the CPU against the reference's
``device_timeline._fit_tables`` in float64 -- the running demand after
every event (XLA's CPU cumsum order, plus the node's base demand), masked
to -inf off tie-group-final events, and its doubling range-max table -- at
L = 64, 224 (the cluster's common epoch shape), 257 (three levels of the
scan's blocks) and 4,096, with time ties, -0.0 deltas, all-+inf rows and
nonzero base demands.  The kernel itself is held against
``fit_tables_plain`` on the card by tests/test_torch_cuda.py.

Tolerance: none.  Placements are held bit-identical to the reference's,
so every slot is compared bit for bit (signed zeros included)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.sim import device_timeline as ref_dt
from repro_torch.kernels import ops, rangemax

LENGTHS = [64, 224, 257, 4096]


def _event_rows(seed: int, L: int):
    """Five node rows (N, L) of sorted event times (+inf padded) and MiB
    deltas, and base demands (N,): row 0 dense with time ties, row 1 all
    +inf, row 2 with -0.0 deltas (one leading), row 3 half full, row 4
    full with every delta cancelled by a later one."""
    rng = np.random.default_rng(seed)
    N = 5
    t = np.sort(np.round(rng.random((N, L)) * 5e3, 1), axis=1)  # rounding makes ties
    d = np.round(rng.standard_normal((N, L)) * 4096.0, 3)
    t[0, 1::5] = t[0, ::5][: t[0, 1::5].shape[0]]  # more ties
    t[1], d[1] = np.inf, 0.0
    d[2, ::3] = -0.0
    d[2, 0] = -0.0
    n3 = L // 2
    t[3, n3:], d[3, n3:] = np.inf, 0.0
    half = L // 2
    d[4, half : 2 * half] = -d[4, :half]
    t = np.sort(t, axis=1)
    base0 = np.array([0.0, 512.0, -0.0, 1234.56789, 65536.25])
    return t, d, base0


def _bits(a) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(a, dtype=np.float64)).view(np.uint64)


def _reference(t, d, base0):
    with jax.enable_x64(True):
        csm, tbl = ref_dt._fit_tables(jnp.asarray(t), jnp.asarray(d), jnp.asarray(base0))
        return np.asarray(csm), np.asarray(tbl)


@pytest.mark.parametrize("L", LENGTHS)
def test_fit_tables_match_reference_bitwise(L):
    t, d, base0 = _event_rows(L, L)
    want_csm, want_tbl = _reference(t, d, base0)
    assert want_tbl.shape == (5, rangemax.num_levels(L), L)
    assert np.isneginf(want_csm).any() and np.isfinite(want_csm).any()  # ties and padding are masked
    args = [torch.from_numpy(a) for a in (t, d, base0)]
    ops.reset_launch_counts()
    for fn in (rangemax.fit_tables_plain, ops.fit_tables):
        csm, tbl = fn(*args)
        assert csm.dtype == tbl.dtype == torch.float64
        np.testing.assert_array_equal(_bits(csm.numpy()), _bits(want_csm))
        np.testing.assert_array_equal(_bits(tbl.numpy()), _bits(want_tbl))
    assert ops.launch_counts()["rangemax"] == 0  # CPU tensors launch nothing


def test_negative_zero_deltas_sum_to_positive_zero():
    """A leading -0.0 delta folds from +0.0, as XLA's cumsum does: the
    running demand there is +0.0, and -0.0 never appears."""
    L = 40
    t = np.arange(L, dtype=np.float64)[None]
    d = np.zeros((1, L))
    d[0, :20] = -0.0
    want_csm, _ = _reference(t, d, np.zeros(1))
    csm, _ = rangemax.fit_tables_plain(*(torch.from_numpy(a) for a in (t, d, np.zeros(1))))
    assert not np.signbit(want_csm).any()
    np.testing.assert_array_equal(_bits(csm.numpy()), _bits(want_csm))


def test_fit_tables_is_the_table_of_the_masked_sums():
    """Level 0 of the table is the masked running demand itself."""
    t, d, base0 = _event_rows(7, 100)
    csm, tbl = rangemax.fit_tables_plain(*(torch.from_numpy(a) for a in (t, d, base0)))
    assert torch.equal(tbl[:, 0], csm)
    assert torch.equal(tbl, rangemax.table_levels(csm))


def test_fit_tables_cuda_refuses_cpu_tensors():
    """The kernel's wrapper raises on a CPU tensor; it never falls back to
    the plain chain."""
    t, d, base0 = (torch.from_numpy(a) for a in _event_rows(8, 64))
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        rangemax.fit_tables_cuda(t, d, base0)
    assert ops.launch_counts()["rangemax"] == 0


def test_fit_tables_dispatch_has_no_fallback_for_other_devices():
    t = torch.zeros((2, 8), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.fit_tables(t, t, torch.zeros(2, dtype=torch.float64, device="meta"))
