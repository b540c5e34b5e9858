"""The sweep's chunk-boundary fold: ``compaction.fold_compact_plain``, and
``device_timeline._fold_and_compact`` through ``ops.fold_compact`` on the
CPU, against the reference's fold composed from its own pieces exactly as
its sweep's ``chunk_step`` composes them (``_count_sorted``, ``jnp.cumsum``,
``repro.kernels.ops.compact_events``, ``_tie_last``), in float64 at L = 64,
257 (three levels of the scan's blocks), 1,024 (the sweep's common axis)
and 4,096.  The rows hold a clock before every event, one after every event
of full rows, one on a tie group, an all-+inf row, -0.0 deltas and -0.0
bases, and deltas that cancel or are zero, so that the sums' bits do not
change and the events are dropped.  The kernel itself is held against
``fold_compact_plain`` on the card by tests/test_torch_cuda.py.

Tolerance: none.  Placements are held bit-identical to the reference's,
so every value is compared bit for bit (signed zeros included)."""

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.sim import device_timeline as ref_dt
from repro_torch.kernels import compaction, ops
from repro_torch.sim import device_timeline

LENGTHS = [64, 257, 1024, 4096]
S, N = 4, 3  # lanes, nodes


@pytest.fixture
def x64(monkeypatch):
    """The reference's float64 programs need ``jax.experimental.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
    with jax.enable_x64(True):
        yield


@jax.jit
def _reference_lane(now, base, tl_t, tl_d):
    """One lane's chunk-boundary fold, as the reference's ``chunk_step``
    (``src/repro/sim/device_timeline.py``) computes it: (N, L) rows at the
    lane's clock -> (base, t, d, csm, kept counts)."""
    n, L = tl_t.shape
    nowq = jnp.broadcast_to(now, (n, 1))
    cnt = ref_dt._count_sorted(tl_t, lambda t: t <= nowq, (n, 1))
    gain = jnp.take_along_axis(jnp.cumsum(tl_d, axis=1), jnp.maximum(cnt - 1, 0), axis=1)
    base = base + jnp.where(cnt > 0, gain, 0.0)[:, 0]
    idx = jnp.arange(L)[None, :] + cnt
    ahead = idx < L
    idxc = jnp.minimum(idx, L - 1)
    tl_t = jnp.where(ahead, jnp.take_along_axis(tl_t, idxc, axis=1), jnp.inf)
    tl_d = jnp.where(ahead, jnp.take_along_axis(tl_d, idxc, axis=1), 0.0)
    cs = base[:, None] + jnp.cumsum(tl_d, axis=1)
    keep = jnp.isfinite(tl_t) & (cs != jnp.concatenate([base[:, None], cs[:, :-1]], axis=1))
    tl_t, tl_d = ref_ops.compact_events(tl_t, tl_d, keep)
    csm = jnp.where(ref_dt._tie_last(tl_t), base[:, None] + jnp.cumsum(tl_d, axis=1), -jnp.inf)
    return base, tl_t, tl_d, csm, jnp.sum(keep, axis=1)


def _reference(now, base, t, d):
    """Every lane through ``_reference_lane``: (S,) clocks, (S * N,) bases,
    (S * N, L) rows -> numpy (base, t, d, csm, kept) over all rows."""
    outs = [_reference_lane(jnp.asarray(now[s]), jnp.asarray(base[s * N:(s + 1) * N]),
                            jnp.asarray(t[s * N:(s + 1) * N]), jnp.asarray(d[s * N:(s + 1) * N])) for s in range(S)]
    return [np.concatenate([np.asarray(o[i]) for o in outs]) for i in range(5)]


def _sweep_rows(seed: int, L: int):
    """S lanes of N node rows: sorted event times with ties (+inf padded)
    and MiB deltas, bases, and the lanes' clocks.  Lane 0's clock precedes
    every event (nothing folds); lane 1's follows every event, and its node
    0 is full (the whole row folds), its node 1 all +inf; lane 2's clock
    lands on a tie group; lane 3's between two events.  Row 1 has -0.0
    deltas (one leading), row 2 deltas that cancel and a run of zeros,
    rows 0 and 4 a -0.0 base."""
    rng = np.random.default_rng(seed)
    R = S * N
    t = np.round(rng.random((R, L)) * 5e3, 1)  # rounding makes ties
    t[:, 1::5] = t[:, ::5][:, : t[:, 1::5].shape[1]]  # more ties
    t = np.sort(t, axis=1)
    d = np.round(rng.standard_normal((R, L)) * 4096.0, 3)
    fin = np.arange(L)[None, :] < rng.integers(L // 4, L + 1, size=R)[:, None]
    fin[3] = True
    fin[4] = False
    t, d = np.where(fin, t, np.inf), np.where(fin, d, 0.0)
    d[1, ::3] = -0.0
    d[1, 0] = -0.0
    half = L // 4
    d[2, half : 2 * half] = -d[2, :half]
    d[2, 2 * half : 2 * half + 10] = 0.0
    j = L // 8
    t[6, j + 1] = t[6, j]  # lane 2's clock: a tie group
    base = np.round(rng.random(R) * 65536.0, 2)
    base[[0, 4]] = -0.0
    now = np.array([-1.0, 1e4, t[6, j], (t[9, L // 6] + t[9, L // 6 + 1]) / 2])
    return now, base, t, d


def _bits(a) -> np.ndarray:
    a = np.ascontiguousarray(np.asarray(a))
    return a.view(np.uint64) if a.dtype == np.float64 else a


@pytest.mark.parametrize("path", ["plain", "sweep_step"])
@pytest.mark.parametrize("L", LENGTHS)
def test_fold_matches_reference_bitwise(x64, L, path):
    now, base, t, d = _sweep_rows(L, L)
    want = _reference(now, base, t, d)
    want_base, want_t, want_d, want_csm, want_kept = want
    # the rows reach every case: nothing folded, whole rows folded, events dropped
    assert not np.signbit(want_base[[0, 4]]).any()  # -0.0 + (+0.0)
    assert want_kept[3] == 0 and np.isposinf(want_t[3]).all()
    n_fin = np.isfinite(t).sum(axis=1)
    assert want_kept[0] == n_fin[0]  # a clock before every event, and no delta that keeps the sum
    assert (want_kept < n_fin)[[2, 6, 9]].all()  # dropped, or folded at the clock
    assert np.isneginf(want_csm).any() and np.isfinite(want_csm).any()
    args = [torch.from_numpy(a) for a in (t, d, base, now)]
    ops.reset_launch_counts()
    if path == "plain":
        got = compaction.fold_compact_plain(*args, N)
    else:
        tl_t, tl_d, b, c = args
        L = tl_t.shape[-1]
        nb, nt, nd, csm, carried = device_timeline._fold_and_compact(c, b.view(S, N), tl_t.view(S, N, L),
                                                                     tl_d.view(S, N, L))
        got = [nb.reshape(-1), nt.reshape(-1, L), nd.reshape(-1, L), csm.reshape(-1, L), None]
        np.testing.assert_array_equal(carried.numpy(), want_kept.reshape(S, N).max(axis=1))
    for g, w in zip(got[:4], want[:4]):
        assert g.dtype == torch.float64
        np.testing.assert_array_equal(_bits(g.numpy()), _bits(w))
    if got[4] is not None:
        assert got[4].dtype == torch.int64
        np.testing.assert_array_equal(got[4].numpy(), want_kept)
    assert ops.launch_counts()["compaction"] == 0  # CPU tensors launch nothing


def test_fold_compact_cuda_refuses_cpu_tensors():
    """The kernel's wrapper raises on a CPU tensor; it never falls back to
    the plain chain."""
    now, base, t, d = (torch.from_numpy(a) for a in _sweep_rows(5, 64))
    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        compaction.fold_compact_cuda(t, d, base, now, N)
    assert ops.launch_counts()["compaction"] == 0


def test_fold_compact_dispatch_has_no_fallback_for_other_devices():
    t = torch.zeros((S * N, 8), dtype=torch.float64, device="meta")
    rows = torch.zeros(S * N, dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no kernel or plain version"):
        ops.fold_compact(t, t, rows, torch.zeros(S, dtype=torch.float64, device="meta"), N)


@pytest.mark.parametrize("name", ["segmax", "compaction"])
def test_redesigned_wrappers_refuse_cpu_tensors(name):
    """The other two wrappers of this redesign raise on CPU tensors too,
    before any launch."""
    from repro_torch.kernels import segmax

    ops.reset_launch_counts()
    with pytest.raises(ValueError, match="CUDA tensors"):
        if name == "segmax":
            idx = torch.zeros(2, dtype=torch.int32)
            segmax.segmax_cuda(torch.zeros((2, 8)), idx, idx, idx + 1, 4)
        else:
            t = torch.zeros((2, 8), dtype=torch.float64)
            compaction.compaction_cuda(t, t, torch.ones((2, 8), dtype=torch.bool))
    assert ops.launch_counts()[name] == 0
