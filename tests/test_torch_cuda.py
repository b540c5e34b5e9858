"""Each hand-written CUDA kernel against its plain PyTorch version, on the
card.  These tests need a CUDA card and skip without one; they import
nothing of JAX, so they run where only PyTorch is installed:

    python -m pytest -q tests/test_torch_cuda.py

Tolerances: segment peaks, fail indices, range-max and fit tables (bit for
bit), ladder values, retries and attempt counts, compacted rows, the
sweep's fold (bit for bit), the scan's running sums (bit for bit), the
sharded controller's carried epoch (every output and the new state bit for
bit) and cluster placements exact; wastage rtol 1e-5 with atol 1e-4 GiB*s when
summed in f32, rtol 1e-9 with atol 1e-9 GiB*s when summed in f64, because
the sums over a series run in another order.  flash in float32 atol 3e-5 /
rtol 1e-4 (the reference's own kernel tolerance); in bf16 on N(0, 1)
inputs max |d| 1e-2 and mean |d| 1e-3, because p is rounded to bf16 after
a running max that depends on the tiling; decode's split partials as the
outputs, with m within 1e-4 and l within rtol 1e-4.  The model's float32 logits on
the card within 1e-4 of max |logits| of the CPU run (the products sum in
another order).  The MoE dispatch (buf, pos) and combine bit for bit,
and the reduced MoE model's float32 logits within 1e-4 as the dense
ones.  The fitstats bank within 1e-5 of each statistic's sum of
absolute terms of its plain version (float32 sums in another order;
relative to the terms because sums of u cancel), and bitwise equal from
run to run.  The WKV recurrence's o and S within 1e-4 of max |o| and max
|S| of its plain version (the kernel's three-pass TF32 products and the
plain version's float32 ones sum the same chunk form in other orders),
the RG-LRU scan bit for bit, and the reduced recurrent models'
float32 logits within 1e-4 as the dense ones; the reduced frontend models
(hubert-xlarge's audio frames, qwen2-vl-72b's patches and M-RoPE rows)
likewise; a checkpoint of CUDA tensors restores on the card bit for bit.
flash's backward (dq, dk, dv) within 1e-4 (f32) or 2e-2 (bf16) of max
|plain| of each (the plain version sums in f32 chunk by chunk; bf16
rounds P and dS as the products' operands), bit for bit from run to run;
its forward with lse gives the output of the forward without it bit for
bit, lse within 1e-4 (f32) or 1e-3 (bf16) of the plain one's.  A reduced
float32 train step on the card within 1e-4 of the CPU's (loss, grad_norm,
each first moment), reduced qwen3-moe's, rwkv6's and recurrentgemma's too.  The MoE backward: d_out_buf
and the dispatch's dxf bit for bit, dw within 1e-5 of max |dw| (f32) or one
bf16 ulp (bf16): it sums each dot product in another order than
``torch.sum``, then rounds to the dtype.  The recurrences' backward: the
RG-LRU's bit for bit, the WKV's within 1e-4 of each gradient's max |plain|
(the token form's sums in other orders), both bit for bit from run to
run."""

import numpy as np
import pytest
import torch

from repro_torch.core.allocation import attempt_outcomes_batch
from repro_torch.core.segmentation import segment_peaks_dynamic
from repro_torch import kernels
from repro_torch.kernels import (compaction, fitstats, flash, moe_combine, moe_dispatch, ops, rangemax, rglru_scan,
                                  rwkv_wkv, scan, segmax, wastage)

WASTE_TOL = dict(rtol=1e-5, atol=1e-4)
WASTE_TOL_F64 = dict(rtol=1e-9, atol=1e-9)
FITSTATS_TOL = 1e-5  # of each statistic's sum of absolute terms


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
@pytest.mark.parametrize("L", [1, 77, 256, 1024, 8192, 20000])  # f64 past ~14,500 takes the global-memory path
def test_rangemax_kernel_matches_plain_on_card(cuda, dtype, L):
    rng = np.random.default_rng(L)
    x = np.round(rng.standard_normal((16, L)) * 3e4, 1)
    x[rng.random((16, L)) < 0.3] = -np.inf
    xt = torch.from_numpy(x).to(cuda, dtype)
    before = rangemax.launches
    got = ops.range_max_table(xt)
    assert rangemax.launches == before + 1
    assert torch.equal(got, rangemax.table_levels(xt))


# Launching no kernel: allocations, views and the argument checks' reads of
# shapes.  A call whose dispatched aten ops all lie in this set launches
# only the hand-written kernel its wrapper counts.
@pytest.mark.parametrize("k_max", [1, 15, 128])
@pytest.mark.parametrize("T,offset", [(2048, 0), (2047, 0), (63, 0), (2048, 1)])  # offset 1: an unaligned base
def test_segmax_kernel_edge_cases_on_card(cuda, T, offset, k_max):
    """Lengths 0, below k_eff and not a multiple of 4, odd T, an unaligned
    row base, k_eff past k_max and below 1, and rows that share a series."""
    S = 40
    y, lengths = _series(11, S, T)
    lengths[4:8] = [5, 7, T - 1, T - 3]
    flat = torch.from_numpy(np.concatenate([np.zeros(offset, np.float32), y.reshape(-1)])).to(cuda)
    yt, lt = flat[offset:].view(S, T), torch.from_numpy(lengths).to(cuda)
    series = torch.arange(S, dtype=torch.int32, device=cuda).repeat(3)
    k_eff = torch.from_numpy(np.random.default_rng(12).integers(-1, k_max + 3, size=3 * S).astype(np.int32)).to(cuda)
    k_eff[:3] = torch.tensor([k_max, 0, 1], dtype=torch.int32)
    got = ops.segment_peaks(yt, lt, series, k_eff, k_max)
    want = segment_peaks_dynamic(yt[series], lt[series], k_eff, k_max)
    torch.cuda.synchronize()
    assert torch.equal(got, want)


_NO_LAUNCH_OPS = {"empty", "empty_strided", "select", "slice", "view", "_unsafe_view", "transpose", "alias",
                  "as_strided", "expand", "unsqueeze", "detach", "t", "permute", "reshape", "_reshape_alias"}


def _aten_ops(fn):
    """The aten ops ``fn()`` dispatches (their base names), and its result."""
    from torch.utils._python_dispatch import TorchDispatchMode

    seen = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.append(func.__name__.split(".")[0])
            return func(*args, **(kwargs or {}))

    with Record():
        out = fn()
    return seen, out


def _fit_rows(N: int, L: int, dtype, seed: int, dev):
    """Node event rows as the epoch program holds them: sorted times with
    ties and a +inf tail, MiB deltas (some -0.0), base demands."""
    rng = np.random.default_rng(seed)
    t = np.sort(np.round(rng.random((N, L)) * 5e3, 1), axis=1)
    fin = np.arange(L)[None, :] < rng.integers(L // 2, L + 1, size=N)[:, None]
    t = np.where(fin, t, np.inf)
    d = np.where(fin, np.round(rng.standard_normal((N, L)) * 4096.0, 3), 0.0)
    d[:, ::7] = -0.0
    base0 = np.round(rng.random(N) * 65536.0, 2)
    return [torch.from_numpy(a).to(dev, dtype) for a in (t, d, base0)]


@pytest.mark.parametrize("dtype,L", [(torch.float64, L) for L in (1, 17, 224, 256, 257, 1024, 8192, 20000)]
                         + [(torch.float32, L) for L in (224, 8192, 60000)])  # 20000 f64, 60000 f32: global path
def test_fit_tables_kernel_matches_plain_on_card(cuda, dtype, L):
    t, d, base0 = _fit_rows(16, L, dtype, L, cuda)
    before = rangemax.launches
    csm, tbl = ops.fit_tables(t, d, base0)
    assert rangemax.launches == before + 1
    want_csm, want_tbl = rangemax.fit_tables_plain(t, d, base0)
    torch.cuda.synchronize()
    bits = torch.int64 if dtype == torch.float64 else torch.int32
    assert torch.equal(csm.view(bits) if csm.is_contiguous() else csm.contiguous().view(bits), want_csm.view(bits))
    assert torch.equal(tbl.view(bits), want_tbl.view(bits))


def test_fit_tables_is_one_launch_on_card(cuda):
    """``device_timeline._fit_tables`` on the card: the kernel's one launch
    and no other op that launches."""
    from repro_torch.sim import device_timeline

    t, d, base0 = _fit_rows(16, 224, torch.float64, 3, cuda)
    before = rangemax.launches
    seen, (csm, tbl) = _aten_ops(lambda: device_timeline._fit_tables(t, d, base0))
    assert rangemax.launches == before + 1
    assert set(seen) <= _NO_LAUNCH_OPS, seen
    assert torch.equal(tbl, rangemax.fit_tables_plain(t, d, base0)[1])


LADDER_METHODS = ("default", "ksegments-selective", "ksegments-partial", "ppm")  # selective, partial, cap jump


def _ladder_inputs(vdt, seed: int, dev, N: int = 2, B: int = 150, T: int = 2048, k: int = 4):
    y, lengths = _series(seed, N * B, T)
    bounds, values = _schedules(seed + 1, N * B * len(LADDER_METHODS), T, k, 2.0)
    values = values * 0.6  # so that most rows retry
    values[::7] = 1e-25  # rows that reach the retry bound or fill the slots
    t = dict(
        y=torch.from_numpy(y).to(dev), lengths=torch.from_numpy(lengths).to(dev),
        series=torch.arange(N * B, dtype=torch.int32, device=dev).view(N, B),
        bounds=torch.from_numpy(bounds).to(dev, vdt).view(N, B, len(LADDER_METHODS), k),
        values=torch.from_numpy(values).to(dev, vdt).view(N, B, len(LADDER_METHODS), k),
        k_eff=torch.tensor([k, k - 1], dtype=torch.int32, device=dev),
    )
    return t


@pytest.mark.parametrize("max_attempts", [None, 32])
@pytest.mark.parametrize("factor", [2.0, 1.2])
@pytest.mark.parametrize("vdt,acc", [(torch.float32, torch.float32), (torch.float32, torch.float64),
                                     (torch.float64, torch.float64)])
def test_ladder_kernel_matches_plain_on_card(cuda, vdt, acc, factor, max_attempts):
    from repro_torch.core.predictor import retry_flags

    t = _ladder_inputs(vdt, 21, cuda)
    sel, cap = retry_flags(LADDER_METHODS)
    kw = dict(interval_s=2.0, factor=factor, cap_mib=4096.0, max_attempts=max_attempts, acc_dtype=acc)
    args = (t["y"], t["lengths"], t["series"], t["bounds"], t["values"], t["k_eff"], sel, cap)
    before = wastage.launches
    got = ops.replay_ladder(*args, **kw)
    assert wastage.launches == before + 1
    want = wastage.replay_ladder_plain(*args, **kw)
    torch.cuda.synchronize()
    tol = WASTE_TOL if acc == torch.float32 else WASTE_TOL_F64
    assert torch.equal(got[1], want[1])  # retries
    assert int(want[1].max()) == (65 if max_attempts is None else 32)  # the bound, or full slots
    torch.testing.assert_close(got[0], want[0], **tol)
    if max_attempts is not None:
        for g, w in zip(got[2][:2], want[2][:2]):  # values, failure indices
            assert torch.equal(g, w)
        torch.testing.assert_close(got[2][2], want[2][2], **tol)
        assert torch.equal(got[2][3], want[2][3])  # n_attempts


@pytest.mark.parametrize("max_attempts", [None, 32])
def test_replay_is_one_wastage_launch_on_card(cuda, max_attempts):
    """``torch_sim._replay`` on the card: one wastage launch per call and no
    other op that launches."""
    from repro_torch.sim import torch_sim

    t = _ladder_inputs(torch.float32, 22, cuda)
    before = wastage.launches
    seen, out = _aten_ops(lambda: torch_sim._replay(
        t["y"], t["lengths"], t["series"], t["bounds"], t["values"], t["k_eff"], methods=LADDER_METHODS,
        interval_s=2.0, factor=2.0, cap_mib=4096.0, max_attempts=max_attempts, acc_dtype=torch.float64))
    assert wastage.launches == before + 1
    assert set(seen) <= _NO_LAUNCH_OPS, seen
    assert out[0].shape == (2, len(LADDER_METHODS), 150)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", ["none", "all", "half"])
@pytest.mark.parametrize("L", [1, 5, 77, 129, 256, 1023, 8192])
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


def _fold_rows(S: int, N: int, L: int, dtype, seed: int, dev):
    """Node event rows of S lanes as the sweep carries them: sorted times
    with ties and +inf tails, MiB deltas (some -0.0, some cancelling), bases
    (some -0.0), and clocks before, after, on and between events."""
    rng = np.random.default_rng(seed)
    R = S * N
    t = np.sort(np.round(rng.random((R, L)) * 5e3, 1), axis=1)
    fin = np.arange(L)[None, :] < rng.integers(L // 4, L + 1, size=R)[:, None]
    fin[0] = True
    t = np.where(fin, t, np.inf)
    d = np.where(fin, np.round(rng.standard_normal((R, L)) * 4096.0, 3), 0.0)
    d[1:, ::7] = -0.0
    q = L // 4
    d[1, q:2 * q] = -d[1, :q]
    base = np.round(rng.random(R) * 65536.0, 2)
    base[::3] = -0.0
    now = np.round(rng.random(S) * 5e3, 1)
    now[0], now[1 % S] = -1.0, 1e4
    if S > 2:
        now[2] = t[2 * N, L // 3]
    return [torch.from_numpy(a).to(dev, dtype) for a in (t, d, base, now)]


def _same_bits(a, b) -> bool:
    if a.is_floating_point():
        bits = torch.int64 if a.dtype == torch.float64 else torch.int32
        a, b = a.view(bits), b.view(bits)
    return torch.equal(a, b)


@pytest.mark.parametrize("dtype,L", [(dt, L) for dt in (torch.float64, torch.float32) for L in (1, 17, 256, 1024, 8192)]
                         + [(torch.float64, 20000), (torch.float32, 40000)])  # past the shared memory
def test_fold_kernel_matches_plain_on_card(cuda, dtype, L):
    t, d, base, now = _fold_rows(4, 16, L, dtype, L, cuda)
    before = compaction.launches
    got = ops.fold_compact(t, d, base, now, 16)
    assert compaction.launches == before + 1
    want = compaction.fold_compact_plain(t, d, base, now, 16)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert _same_bits(g, w)
    assert (want[4] > 0).any() and (want[4] < torch.isfinite(t).sum(dim=-1)).any()


def test_fold_and_compact_is_one_launch_on_card(cuda):
    """``device_timeline._fold_and_compact`` on the card: the kernel's one
    launch, and the max over nodes its only other op that launches."""
    from repro_torch.sim import device_timeline

    S, N, L = 4, 16, 1024
    t, d, base, now = _fold_rows(S, N, L, torch.float64, 5, cuda)
    before = compaction.launches
    seen, out = _aten_ops(lambda: device_timeline._fold_and_compact(now, base.view(S, N), t.view(S, N, L),
                                                                    d.view(S, N, L)))
    assert compaction.launches == before + 1
    launching = [op for op in seen if op not in _NO_LAUNCH_OPS]
    assert launching == ["amax"], seen
    want = compaction.fold_compact_plain(t, d, base, now, N)
    assert _same_bits(out[1].reshape(-1, L), want[1]) and _same_bits(out[3].reshape(-1, L), want[3])
    assert torch.equal(out[4], want[4].view(S, N).amax(dim=-1))


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


# (B, T, S, H, KV, hd, causal, window, softcap, positions): the reference's
# five FLASH_CASES, then GQA, hd 80/128/256, a rolling local cache, long
# rows, and the reduced configs' hd 16 (prefill and decode); positions are
# arange (False), a ragged shifted cache (True), or a named pattern
# (``_flash_positions``)
FLASH_CARD_CASES = [
    (2, 64, 64, 4, 2, 64, True, None, None, False),
    (1, 300, 300, 8, 8, 64, True, None, 50.0, False),
    (2, 37, 37, 6, 2, 64, True, 16, None, False),
    (2, 1, 80, 4, 4, 64, True, None, None, True),
    (1, 128, 128, 4, 2, 64, False, None, None, False),
    (2, 200, 200, 24, 8, 128, True, None, None, False),
    (2, 1, 300, 24, 8, 128, True, None, None, True),
    (1, 130, 130, 16, 16, 80, False, None, None, False),
    (1, 257, 257, 16, 8, 256, True, 64, 50.0, False),
    (2, 1, 96, 16, 8, 256, True, 64, 50.0, True),
    (1, 3, 700, 12, 1, 128, True, None, None, True),
    (2, 47, 47, 4, 4, 16, True, None, None, False),
    (2, 1, 70, 4, 2, 16, True, 32, None, True),
    # rows with no valid key (S a multiple of no tile size, G = 3): the mean
    # of V over the S slots, never over the tiles' padding
    (2, 100, 141, 24, 8, 128, True, None, None, "late-keys"),
    (2, 1, 141, 24, 8, 128, True, 32, None, "window-out"),
    (2, 37, 45, 6, 2, 16, True, None, None, "late-keys"),
    (2, 1, 45, 6, 2, 16, True, 16, None, "window-out"),
    # wrapped rolling caches (k_pos not monotone, window below S): decode at
    # hd 128 and 256, and a 40-query chunk through the prefill kernels
    (2, 1, 300, 24, 8, 128, True, 100, None, "rolling"),
    (2, 1, 200, 16, 8, 256, True, 96, 50.0, "rolling"),
    (1, 40, 300, 24, 8, 128, True, 100, None, "rolling"),
    # a causal prefill at S = 4,096 + 37: a ragged last tile after the skip
    (1, 4133, 4133, 6, 2, 128, True, None, None, False),
    # the frontends' shapes: hubert's non-causal hd 80 encoder over 1,500
    # frames (a multiple of no tile), qwen2-vl's decode at G = 8 (T x G = 8:
    # the prefill kernels, not the split path) over a ragged 4,112-slot cache
    (1, 1500, 1500, 16, 16, 80, False, None, None, False),
    (2, 1, 4112, 64, 8, 128, True, None, None, True),
]


def _flash_positions(mode, B, T, S, window):
    """(q_pos, k_pos) of a named pattern.  "late-keys": keys at positions
    S // 7 + 3.., so the first queries have no valid key; "window-out":
    decode, row 0 holds S // 2 tokens and queries past its window, the other
    rows the last of 3 S // 4 tokens; "rolling": a cache written at
    pos % S, row 0 wrapped (at 3 S + 11), the others part filled."""
    if mode == "late-keys":
        return np.broadcast_to(np.arange(T)[None], (B, T)), np.broadcast_to(np.arange(S)[None] + S // 7 + 3, (B, S))
    if mode == "window-out":
        fill = np.full((B, 1), 3 * S // 4)
        fill[0] = S // 2
        kpos = np.where(np.arange(S)[None] < fill, np.arange(S)[None], -1)
        qpos = fill - 1
        qpos[0] += window + 5
        return qpos, kpos
    if mode == "rolling":
        kpos = np.full((B, S), -1)
        nows = [3 * S + 11] + [S // 2 + b for b in range(1, B)]
        for b, now in enumerate(nows):
            for p in range(max(now - S + 1, 0), now + 1):
                kpos[b, p % S] = p
        return np.asarray(nows)[:, None] - T + 1 + np.arange(T)[None], kpos
    raise KeyError(mode)


def _flash_inputs(case, dtype, dev):
    B, T, S, H, KV, hd, causal, window, cap, ragged = case
    rng = np.random.default_rng(B * 31 + T + hd)
    q = torch.from_numpy(rng.normal(0, 1, (B, T, H, hd))).to(dev, dtype)
    k = torch.from_numpy(rng.normal(0, 1, (B, S, KV, hd))).to(dev, dtype)
    v = torch.from_numpy(rng.normal(0, 1, (B, S, KV, hd))).to(dev, dtype)
    if isinstance(ragged, str):
        qpos, kpos = _flash_positions(ragged, B, T, S, window)
    elif ragged:  # a rolling cache: some slots empty, positions past the window wrapped
        lengths = rng.integers(S // 2, S + 1, size=B)
        kpos = np.where(np.arange(S)[None] < lengths[:, None], np.arange(S)[None] + S // 3, -1)
        qpos = kpos.max(axis=1, keepdims=True) + np.arange(T)[None] - T + 1
    else:
        qpos = np.broadcast_to(np.arange(T)[None], (B, T))
        kpos = np.broadcast_to(np.arange(S)[None], (B, S))
    qp = torch.from_numpy(np.ascontiguousarray(qpos, dtype=np.int32)).to(dev)
    kp = torch.from_numpy(np.ascontiguousarray(kpos, dtype=np.int32)).to(dev)
    return q, k, v, qp, kp, dict(causal=causal, window=window, softcap=cap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CARD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_kernel_matches_plain_on_card(cuda, dtype, case):
    q, k, v, qp, kp, kw = _flash_inputs(case, dtype, cuda)
    before = flash.launches
    got = ops.flash_attention(q, k, v, qp, kp, **kw)
    assert flash.launches == before + 1 and got.dtype == dtype and got.shape == q.shape
    want = flash.flash_attention_plain(q, k, v, qp, kp, **kw)
    torch.cuda.synchronize()
    d = (got.float() - want.float()).abs()
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=3e-5, rtol=1e-4)
    else:
        assert d.max().item() <= 1e-2 and d.mean().item() <= 1e-3, (d.max().item(), d.mean().item())


DECODE_CARD_CASES = [c for c in FLASH_CARD_CASES if c[1] * (c[3] // c[4]) <= flash.SPLIT_ROWS]


@pytest.mark.parametrize("splits", [None, 1, 3])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", DECODE_CARD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_split_partials_match_plain_on_card(cuda, dtype, case, splits):
    """Decode's split kernel against the plain partials (the same runs of
    64-slot tiles), and the combined output against flash_attention_plain.
    A run without a valid key for a row is (-1e30, 0, 0) on both sides;
    elsewhere m within 1e-4, l within rtol 1e-4, and acc / l within the
    flash gate of the type."""
    q, k, v, qp, kp, kw = _flash_inputs(case, dtype, cuda)
    before = flash.launches
    m, l, acc, out = flash.flash_decode_partials_cuda(q, k, v, qp, kp, splits, **kw)
    assert flash.launches == before + 1
    pm, pl, pacc = flash.flash_decode_partials_plain(q, k, v, qp, kp, m.shape[1], **kw)
    torch.cuda.synchronize()
    none = pm == flash.NEG_INF
    assert torch.equal(m == flash.NEG_INF, none)
    assert (l[none] == 0).all() and (acc[none] == 0).all()
    live = ~none
    torch.testing.assert_close(m[live], pm[live], atol=1e-4, rtol=1e-5)
    torch.testing.assert_close(l[live], pl[live], atol=0.0, rtol=1e-4)
    got, want = acc[live] / l[live][:, None], pacc[live] / pl[live][:, None]
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, atol=3e-5, rtol=1e-4)
    else:
        d = (got - want).abs()
        assert d.max().item() <= 1e-2 and d.mean().item() <= 1e-3, (d.max().item(), d.mean().item())
    want_out = flash.flash_attention_plain(q, k, v, qp, kp, **kw)
    if dtype == torch.float32:
        torch.testing.assert_close(out, want_out, atol=3e-5, rtol=1e-4)
    else:
        d = (out.float() - want_out.float()).abs()
        assert d.max().item() <= 1e-2 and d.mean().item() <= 1e-3, (d.max().item(), d.mean().item())


def test_flash_kernel_refuses_what_it_cannot_take(cuda):
    q = torch.zeros((1, 4, 2, 96), device=cuda)
    with pytest.raises(ValueError, match="head_dim 96"):
        flash.flash_attention_cuda(q, q, q, torch.zeros((1, 4), dtype=torch.int32, device=cuda),
                                   torch.zeros((1, 4), dtype=torch.int32, device=cuda),
                                   causal=True, window=None, softcap=None)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        q16 = q[..., :64].contiguous().half()
        flash.flash_attention_cuda(q16, q16, q16, torch.zeros((1, 4), dtype=torch.int32, device=cuda),
                                   torch.zeros((1, 4), dtype=torch.int32, device=cuda),
                                   causal=True, window=None, softcap=None)


# (B, T, H, KV, hd, causal, window, softcap[, positions]): the CPU tests'
# masks and groups (G 1, 3 and 8; hd 16 and 64; T a multiple of no tile, one
# past the plain version's 1,024 chunk), the full configs' head dims 80, 128
# and 256 at their models' masks, a T a multiple of neither 64 nor 128 at
# G = 3, hd 80 and 256 with windows across the tiles' edges, padded k_pos =
# -1 slots, and rows with no valid key.  positions: arange by default,
# "padded" (every slot n % 7 == 3 at -1), "empty" (keys at n + 50 and
# padded: the first 50 queries see no key)
BWD_CARD_CASES = [
    (2, 70, 4, 4, 16, True, None, None),
    (2, 70, 6, 2, 16, True, 32, 50.0),
    (1, 133, 8, 1, 64, False, None, None),
    (2, 257, 6, 2, 64, True, 100, None),
    (1, 1100, 8, 8, 64, True, None, None),
    (1, 300, 16, 16, 80, False, None, None),
    (2, 200, 24, 8, 128, True, None, None),
    (1, 150, 16, 8, 256, True, 96, 50.0),
    (2, 333, 24, 8, 128, True, None, None),
    (1, 300, 16, 16, 80, True, 100, None),
    (1, 333, 16, 8, 256, True, 100, 50.0),
    (2, 200, 24, 8, 128, True, None, None, "padded"),
    (2, 333, 24, 8, 128, True, None, None, "empty"),
    (1, 150, 16, 8, 256, True, 96, 50.0, "empty"),
    (2, 70, 6, 2, 16, True, None, None, "empty"),
    (2, 200, 64, 4, 128, True, None, None),  # qwen3-moe's heads, G = 16
]
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}  # of max |plain| per output


def _bwd_inputs(case, dtype, dev):
    B, T, H, KV, hd, causal, window, cap = case[:8]
    positions = case[8] if len(case) > 8 else None
    rng = np.random.default_rng(B * 31 + T + hd)
    q, k, v, dout = (torch.from_numpy(rng.normal(0, 1, s)).to(dev, dtype)
                     for s in ((B, T, H, hd), (B, T, KV, hd), (B, T, KV, hd), (B, T, H, hd)))
    pos = torch.arange(T, dtype=torch.int32, device=dev)[None].expand(B, T).contiguous()
    kpos = pos + 50 if positions == "empty" else pos
    if positions is not None:
        kpos = torch.where(torch.arange(T, device=dev) % 7 == 3, -1, kpos).to(torch.int32).contiguous()
    return q, k, v, dout, pos, kpos, dict(causal=causal, window=window, softcap=cap)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CARD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_kernel_matches_plain_on_card(cuda, dtype, case):
    """The backward kernel against flash_attention_bwd_plain on the same
    out and lse (the plain forward's), each of dq, dk and dv within the
    type's tolerance of max |plain|; two launches bit for bit alike (no
    atomics)."""
    from repro_torch.kernels import flash_bwd

    q, k, v, dout, pos, kpos, kw = _bwd_inputs(case, dtype, cuda)
    out, lse = flash.flash_attention_lse_plain(q, k, v, pos, kpos, **kw)
    before = flash_bwd.launches
    got = flash_bwd.flash_bwd_cuda(q, k, v, out, lse, dout, pos, kpos, **kw)
    again = flash_bwd.flash_bwd_cuda(q, k, v, out, lse, dout, pos, kpos, **kw)
    assert flash_bwd.launches == before + 2
    want = flash_bwd.flash_attention_bwd_plain(q, k, v, out, lse, dout, pos, kpos, **kw)
    torch.cuda.synchronize()
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert g.dtype == dtype and g.shape == w.shape and torch.equal(g, a), name
        err = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
        assert err <= BWD_TOL[dtype], (name, err)


# Rows with no valid key (the forward gives them mean V over the S slots):
# the minimal input (row 0, at q_pos 0, sees no key), the same with two
# padded slots, and a group of three heads over two batch rows, one of
# which has no valid slot at all.  (B, H, KV, hd, q_pos, k_pos)
EMPTY_ROW_CASES = {
    "late-keys": (1, 1, 1, 16, [[0, 5]], [[1, 2, 3, 4]]),
    "padded": (1, 1, 1, 16, [[0, 5]], [[1, -1, 3, -1]]),
    "gqa": (2, 3, 1, 16, [[0, 2, 6], [1, 2, 3]], [[2, -1, 4, 5, 6], [-1, -1, -1, -1, -1]]),
}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("name", EMPTY_ROW_CASES)
def test_flash_bwd_kernel_on_rows_with_no_valid_key_on_card(cuda, dtype, name):
    """The forward kernel's lse is +inf on the rows with no valid key and
    only there, as the plain one's; the backward kernel on its output
    against the plain backward, dq, dk and dv within the type's tolerance
    of max |plain|, dq 0 on the empty rows, bit for bit from run to run."""
    from repro_torch.kernels import flash_bwd

    B, H, KV, hd, qpos, kpos = EMPTY_ROW_CASES[name]
    qp = torch.tensor(qpos, dtype=torch.int32, device=cuda)
    kp = torch.tensor(kpos, dtype=torch.int32, device=cuda)
    T, S = qp.shape[1], kp.shape[1]
    rng = np.random.default_rng(0)
    q, k, v, dout = (torch.from_numpy(rng.normal(0, 1, s)).to(cuda, dtype)
                     for s in ((B, T, H, hd), (B, S, KV, hd), (B, S, KV, hd), (B, T, H, hd)))
    kw = dict(causal=True, window=None, softcap=None)
    out, lse = flash.flash_attention_lse_cuda(q, k, v, qp, kp, **kw)
    _, want_lse = flash.flash_attention_lse_plain(q, k, v, qp, kp, **kw)
    empty = torch.isposinf(want_lse)
    assert empty.any() and torch.equal(torch.isposinf(lse), empty)
    got = flash_bwd.flash_bwd_cuda(q, k, v, out, lse, dout, qp, kp, **kw)
    again = flash_bwd.flash_bwd_cuda(q, k, v, out, lse, dout, qp, kp, **kw)
    want = flash_bwd.flash_attention_bwd_plain(q, k, v, out, lse, dout, qp, kp, **kw)
    torch.cuda.synchronize()
    assert (got[0][empty] == 0).all()
    for name_, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        assert torch.equal(g, a), name_
        err = (g.float() - w.float()).abs().max().item() / w.float().abs().max().item()
        assert err <= BWD_TOL[dtype], (name_, err)


def test_flash_bwd_kernels_run_on_wgmma_on_card(cuda):
    """The bf16 dK/dV and dQ kernels run their products on wgmma: HGMMA in
    the SASS of flash_bwd_kernel_dkv_* and flash_bwd_kernel_dq_* at hd 128
    and 256 (cuobjdump on the built library)."""
    import os
    import re
    import shutil
    import subprocess

    from repro_torch.kernels import build

    build.library("flash_bwd")
    tool = shutil.which("cuobjdump") or os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin",
                                                      "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(build.library_path("flash_bwd"))], capture_output=True, text=True,
                          check=True).stdout
    found = {}
    for block in sass.split("Function : ")[1:]:
        m = re.search(r"flash_bwd_kernel_(dkv|dq)_wgmmaILi(\d+)E", block.split("\n", 1)[0])
        if m:
            found[(m.group(1), int(m.group(2)))] = "HGMMA" in block
    for kernel in ("dkv", "dq"):
        for hd in (128, 256):
            assert found.get((kernel, hd)), (kernel, hd, sorted(found))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", FLASH_CARD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_lse_leaves_the_output_as_it_was_on_card(cuda, dtype, case):
    """The forward with lse gives the output of the forward without it, bit
    for bit, on every path (prefill, decode's splits, rows without a valid
    key), and on rows with a valid key an lse within 1e-4 (f32) or 1e-3
    (bf16) of the plain one's."""
    q, k, v, qp, kp, kw = _flash_inputs(case, dtype, cuda)
    plain_out = flash.flash_attention_cuda(q, k, v, qp, kp, **kw)
    out, lse = flash.flash_attention_lse_cuda(q, k, v, qp, kp, **kw)
    _, want = flash.flash_attention_lse_plain(q, k, v, qp, kp, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, plain_out)
    assert torch.equal(torch.isposinf(lse), torch.isposinf(want))  # rows with no valid key
    live = torch.isfinite(want)
    tol = 1e-4 if dtype == torch.float32 else 1e-3
    torch.testing.assert_close(lse[live], want[live], atol=tol, rtol=tol)


def test_flash_gradient_is_the_kernels_on_card(cuda):
    """Autograd through ops.flash_attention on the card: one forward launch
    (with lse) and one flash_bwd launch, the gradients those of the plain
    version's autograd within the f32 gate; under inference mode no
    autograd function is recorded."""
    from repro_torch.kernels import flash_bwd

    q, k, v, dout, pos, _, kw = _bwd_inputs(BWD_CARD_CASES[1], torch.float32, cuda)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    ops.reset_launch_counts()
    out = ops.flash_attention(*leaves, pos, pos, **kw)
    grads = torch.autograd.grad(out, leaves, dout)
    assert ops.launch_counts()["flash"] == 1 and ops.launch_counts()["flash_bwd"] == 1
    plain = [t.clone().requires_grad_() for t in (q, k, v)]
    want = torch.autograd.grad(flash.flash_attention_plain(*plain, pos, pos, **kw), plain, dout)
    for g, w in zip(grads, want):
        assert (g - w).abs().max().item() <= 1e-4 * w.abs().max().item()
    with torch.inference_mode():
        assert ops.flash_attention(*leaves, pos, pos, **kw).grad_fn is None
    assert flash_bwd.launches == 1


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("head_dim", [16, 128])  # reduced()'s own, and llama3.2-3b's
def test_reduced_train_step_on_card_matches_cpu_run(cuda, head_dim, remat):
    """One train step of reduced llama3.2-3b in float32 on the card (flash
    and flash_bwd, once a layer each, twice flash under remat) against the
    same step on the CPU (the plain version under autograd): loss,
    grad_norm and lr within 1e-4, each first moment (0.1 x the clipped
    gradient) within 1e-4 of its leaf's max |mu|."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models.model import init_params
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = dataclasses.replace(get_config("llama3.2-3b").reduced(), dtype="float32", head_dim=head_dim, remat=remat)
    batch = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=70, global_batch=2)).batch(0)
    runs = {}
    for dev in ("cpu", cuda):
        model = init_params(cfg, seed=3, device="cpu").to(dev)
        state = init_train_state(model)
        step = make_train_step(cfg, TrainConfig(), model)
        ops.reset_launch_counts()
        state, m = step(state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        runs[str(dev)] = (state, m, ops.launch_counts())
    (cpu_state, cpu_m, cpu_n), (state, m, n) = runs["cpu"], runs[str(cuda)]
    assert cpu_n["flash"] == cpu_n["flash_bwd"] == 0
    assert n["flash"] == (2 if remat else 1) * cfg.num_layers and n["flash_bwd"] == cfg.num_layers
    for key in ("loss", "grad_norm", "lr"):
        assert abs(m[key].item() - cpu_m[key].item()) <= 1e-4 * abs(cpu_m[key].item()), key
    for name, mu in state["opt"]["mu"].items():
        want = cpu_state["opt"]["mu"][name]
        assert (mu.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item(), name


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_reduced_recurrent_train_step_on_card_matches_cpu_run(cuda, name, remat):
    """One train step of a reduced recurrent config (d_model 128: two RWKV
    heads) in float32 on the card against the same step on the CPU (the
    plain versions under autograd): loss, grad_norm and lr within 1e-4,
    each first moment within 1e-4 of its leaf's max |mu|.  Launches a
    recurrent layer: the forward kernel once (twice under remat) and its
    backward kernel once; recurrentgemma's local layers flash and
    flash_bwd likewise."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models.model import init_params
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32", d_model=128, remat=remat)
    batch = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=70, global_batch=2)).batch(0)
    runs = {}
    for dev in ("cpu", cuda):
        model = init_params(cfg, seed=3, device="cpu").to(dev)
        state = init_train_state(model)
        step = make_train_step(cfg, TrainConfig(), model)
        ops.reset_launch_counts()
        state, m = step(state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        runs[str(dev)] = (state, m, ops.launch_counts())
    (cpu_state, cpu_m, cpu_n), (state, m, n) = runs["cpu"], runs[str(cuda)]
    assert not any(cpu_n.values())
    f = 2 if remat else 1
    kernel = "rwkv_wkv" if name.startswith("rwkv") else "rglru_scan"
    n_rec = sum(k in ("rwkv", "rglru") for k in cfg.layer_kinds)
    n_att = cfg.num_layers - n_rec
    assert (n[kernel], n[kernel + "_bwd"]) == (f * n_rec, n_rec)
    assert (n["flash"], n["flash_bwd"]) == (f * n_att, n_att)
    for key in ("loss", "grad_norm", "lr"):
        assert abs(m[key].item() - cpu_m[key].item()) <= 1e-4 * abs(cpu_m[key].item()), key
    for leaf, mu in state["opt"]["mu"].items():
        want = cpu_state["opt"]["mu"][leaf]
        assert (mu.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item(), leaf


def test_launcher_trains_on_card_with_its_defaults(cuda, tmp_path):
    """``python -m repro_torch.launch.train`` with its defaults (reduced
    llama3.2-3b, B 8 x T 128) on the card, 12 steps, one injected failure:
    one restart, step 12, every attention forward and backward a kernel."""
    from repro_torch.launch import train as launch_train

    ops.reset_launch_counts()
    res = launch_train.main(["--steps", "12", "--fail-at", "5", "--ckpt", str(tmp_path)])
    assert res["restarts"] == 1 and res["step"] == 12
    assert all(np.isfinite(m["loss"]) for m in res["log"])
    counts = ops.launch_counts()
    assert counts["flash"] > 0 and counts["flash_bwd"] == counts["flash"]


@pytest.mark.parametrize("head_dim", [16, 64])  # reduced()'s own, and a full config's
@pytest.mark.parametrize("name", ["llama3.2-3b", "gemma2-9b"])
def test_reduced_model_on_card_matches_cpu_run(cuda, name, head_dim):
    """Prefill and decode of a reduced float32 model on the card (through
    the flash kernel) against the same weights on the CPU (its plain
    version), and greedy generation token for token."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import decode_step, forward, init_params
    from repro_torch.serve.engine import greedy_generate

    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32", head_dim=head_dim)
    cpu = init_params(cfg, seed=3, device="cpu")
    card = init_params(cfg, seed=0, device=cuda)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 41)).astype(np.int32))
    T = 40
    before = flash.launches
    full, _ = forward(card, tokens.to(cuda))
    _, cache = forward(card, tokens[:, :T].to(cuda), want_cache=True, cache_len=T + 8)
    dec, _ = decode_step(card, cache, tokens[:, T:].to(cuda), torch.full((2,), T, dtype=torch.int32))
    assert flash.launches - before == 3 * cfg.num_layers
    want_full, _ = forward(cpu, tokens)
    _, cpu_cache = forward(cpu, tokens[:, :T], want_cache=True, cache_len=T + 8)
    want_dec, _ = decode_step(cpu, cpu_cache, tokens[:, T:], torch.full((2,), T, dtype=torch.int32))
    scale = want_full.abs().max().item()
    assert (full.cpu() - want_full).abs().max().item() <= 1e-4 * scale
    assert (dec.cpu() - want_dec).abs().max().item() <= 1e-4 * scale
    for c, w in zip(cache, cpu_cache):
        assert torch.equal(c["pos"].cpu(), w["pos"])
    got = greedy_generate(card, cfg, tokens[:, :12], steps=6)
    want = greedy_generate(cpu, cfg, tokens[:, :12], steps=6, device="cpu")
    assert torch.equal(got.cpu(), want)


def test_launcher_serves_on_card_with_its_defaults(cuda):
    """``python -m repro_torch.launch.serve`` with no arguments: the reduced
    llama3.2-3b on the card, 24 requests, every attention through flash."""
    from repro_torch.launch import serve as launch_serve

    ops.reset_launch_counts()
    res = launch_serve.main([])
    assert res["done"] == 24 and sum(o.shape[0] for o in res["outputs"]) == 24
    assert all(o.is_cuda and o.shape[1] == 16 for o in res["outputs"])
    assert ops.launch_counts()["flash"] > 0


def _fitstats_inputs(B: int, k: int, weights: str, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(B).astype(np.float32) * 40.0
    peaks = rng.uniform(0.0, 1e4, (B, k)).astype(np.float32)
    w = np.ones(B, np.float32) if weights == "ones" else rng.random(B).astype(np.float32)
    return x, peaks, w


# the chip phase's three sizes: bench_kernels' batch, the corpus' largest
# task at k = 15, and 2**20 rows at the kernel's widest k
@pytest.mark.parametrize("B,k,weights", [(512, 4, "ones"), (1512, 15, "random"), (1 << 20, 128, "random")])
def test_fitstats_kernel_matches_plain_on_card(cuda, B, k, weights):
    x, peaks, w = (torch.from_numpy(a).to(cuda) for a in _fitstats_inputs(B, k, weights, B + k))
    before = fitstats.launches
    got = ops.fit_stats(x, peaks, w)
    again = ops.fit_stats(x, peaks, w)
    assert fitstats.launches == before + 2
    assert torch.equal(got, again)  # bitwise, run to run
    want = fitstats.fit_stats_plain(x, peaks, w)
    scale = fitstats.fit_stats_plain(x.abs(), peaks.abs(), w.abs())
    assert ((got - want).abs() <= FITSTATS_TOL * scale).all()


def test_fitstats_kernel_masked_poison_on_card(cuda):
    x, peaks, w = _fitstats_inputs(3000, 6, "ones", 3)
    w[1700], peaks[1700, 2] = 0.0, np.nan
    got = kernels.fit_stats(*(torch.from_numpy(a).to(cuda) for a in (x, peaks, w))).cpu()
    want = fitstats.fit_stats_plain(*(torch.from_numpy(a) for a in (x, peaks, w)))
    assert torch.equal(torch.isnan(got), torch.isnan(want)) and torch.isnan(got[2, 3:]).all()


def test_kernels_api_on_card_matches_cpu(cuda):
    """The API's three functions on CUDA tensors launch their kernels and
    give the plain versions' results on the same inputs."""
    y, lengths = _series(15, 64, 700)
    bounds, values = _schedules(16, 64, 700, 4, 2.0)
    x = np.random.default_rng(17).uniform(-50.0, 50.0, 64)
    cpu = [torch.from_numpy(a) for a in (y, lengths, bounds, values, x)]
    card = [a.to(cuda) for a in cpu]
    ops.reset_launch_counts()
    peaks = kernels.segment_peaks(card[0], card[1], 4)
    waste, fail = kernels.attempt_wastage(*card[:4], 2.0)
    bank = kernels.fit_stats(card[4], peaks, torch.ones(64, device=cuda))
    assert {n: c for n, c in ops.launch_counts().items() if c} == {"segmax": 1, "wastage": 1, "fitstats": 1}
    want_peaks = kernels.segment_peaks(cpu[0], cpu[1], 4)
    want_waste, want_fail = kernels.attempt_wastage(*cpu[:4], 2.0)
    assert torch.equal(peaks.cpu(), want_peaks) and torch.equal(fail.cpu(), want_fail)
    torch.testing.assert_close(waste.cpu(), want_waste, **WASTE_TOL)
    want_bank = kernels.fit_stats(cpu[4], want_peaks, torch.ones(64))
    scale = fitstats.fit_stats_plain(cpu[4].float().abs(), want_peaks, torch.ones(64))
    assert ((bank.cpu() - want_bank).abs() <= FITSTATS_TOL * scale).all()


def test_adaptive_k_on_card_matches_cpu_run(cuda):
    """The tuner's replays through segmax and wastage on the card pick the
    k of its CPU run."""
    from repro_torch.core.ktuner import AdaptiveKSelector
    from repro_torch.sim.traces import generate_eager

    for trace in generate_eager(seed=11, scale=0.3).eligible_tasks(20):
        card, cpu = AdaptiveKSelector(refresh=8), AdaptiveKSelector(refresh=8, device="cpu")
        ops.reset_launch_counts()
        for e in trace.executions[:32]:
            card.observe(e.input_size, e.series)
        assert ops.launch_counts()["segmax"] > 0 and ops.launch_counts()["wastage"] > 0
        for e in trace.executions[:32]:
            cpu.observe(e.input_size, e.series)
        assert card.history_k == cpu.history_k and card.history_k


# the scan phase's lengths; 2,048 / 2,049 the last length of the warp-per-line
# tier and the next; 60,000 is past the opt-in shared memory in both types
# (the global scratch path)
SCAN_LENGTHS = (1, 15, 16, 17, 255, 256, 257, 1536, 2048, 2049, 4096, 20000, 60000)


def _scan_input(shape, dtype, seed: int, dev):
    """N(0, 1e3) values with exact zeros of both signs, a -0.0 first."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape) * 1e3
    a[rng.random(shape) < 0.05] = 0.0
    a[rng.random(shape) < 0.05] = -0.0
    a[(slice(None),) * (len(shape) - 1) + (0,)] = -0.0
    return torch.from_numpy(a).to(dev, dtype)


def _same_bits(a, b):
    bits = torch.int64 if a.dtype == torch.float64 else torch.int32
    return a.shape == b.shape and torch.equal(a.contiguous().view(bits), b.contiguous().view(bits))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", ["sequential", "xla"])
@pytest.mark.parametrize("n", SCAN_LENGTHS)
def test_scan_kernel_matches_plain_on_card(cuda, n, order, dtype):
    rows = 3 if n > 4096 else 16
    a = _scan_input((rows, n), dtype, n, cuda)
    block = n if order == "sequential" else scan.XLA_SCAN_BLOCK
    before = scan.launches
    got = ops.prefix_sum(a, -1, block)
    assert scan.launches == before + 1
    assert _same_bits(got, scan.cumsum(a, block))
    assert not torch.signbit(got[:, 0]).any()  # the leading -0.0 became +0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", ["sequential", "xla"])
@pytest.mark.parametrize("shape,dim", [((4, 1536, 25), 1), ((2, 257, 7), 1), ((3, 5, 40), 0), ((2, 3, 300), 2)])
def test_scan_kernel_along_any_axis_on_card(cuda, shape, dim, order, dtype):
    """The scan along a middle or the first axis (the predict phase's fold
    and PPM's columns) without a copy before it."""
    a = _scan_input(shape, dtype, sum(shape), cuda)
    block = shape[dim] if order == "sequential" else scan.XLA_SCAN_BLOCK
    assert _same_bits(scan.scan_cuda(a, dim, block), scan.prefix_sum_plain(a, dim, block))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", ["sequential", "xla"])
@pytest.mark.parametrize("n", [17, 1536])
@pytest.mark.parametrize("inner", [1, 5, 25, 31, 32, 33, 1536])
def test_scan_kernel_tiles_of_columns_on_card(cuda, inner, n, order, dtype):
    """(3, n, inner) along n: columns flattened over (outer, inner), so 99
    columns leave a ragged last tile of 32 at inner 33, and inner 5 and 25
    put columns of several outers in one tile (the fold's chain); in XLA's
    order few columns take a warp each, 4,608 at inner 1,536 take tiles."""
    a = _scan_input((3, n, inner), dtype, inner + n, cuda)
    a[:, 0] = -0.0
    block = n if order == "sequential" else scan.XLA_SCAN_BLOCK
    got = scan.scan_cuda(a, 1, block)
    assert _same_bits(got, scan.prefix_sum_plain(a, 1, block))
    assert not torch.signbit(got[:, 0]).any()  # the leading -0.0 became +0.0


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", ["sequential", "xla"])
@pytest.mark.parametrize("shape", [(160, 300, 33), (200, 40, 25), (150, 17, 31), (2, 2049, 2400)])
def test_scan_kernel_tile_tier_on_card(cuda, shape, order, dtype):
    """Enough columns along a middle axis (4,650 to 5,280) that XLA's order
    takes tiles of 32 on an H100's 132 SMs, in tiles that straddle outers
    and end ragged, and 2,049 rows, past the warp tier."""
    a = _scan_input(shape, dtype, sum(shape), cuda)
    a[:, 0] = -0.0
    block = shape[1] if order == "sequential" else scan.XLA_SCAN_BLOCK
    got = scan.scan_cuda(a, 1, block)
    assert _same_bits(got, scan.prefix_sum_plain(a, 1, block))
    assert not torch.signbit(got[:, 0]).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("shape", [(3, 36, 1), (2, 1540, 4), (2, 50, 8), (4, 1536, 25)])
def test_scan_kernel_chain_short_last_chunk_on_card(cuda, shape, dtype):
    """The scan's order with a short last chunk of rows (all but the fold's
    shape), a chunk one aligned span of 16-byte pieces at (3, 36, 1) and
    column groups of few outers split up to a block per SM."""
    a = _scan_input(shape, dtype, sum(shape), cuda)
    a[:, 0] = -0.0
    got = scan.scan_cuda(a, 1, shape[1])
    assert _same_bits(got, scan.prefix_sum_plain(a, 1, shape[1]))
    assert not torch.signbit(got[:, 0]).any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("order", ["sequential", "xla"])
@pytest.mark.parametrize("n", [16, 257, 1536, 2048, 2049])
def test_scan_kernel_on_misaligned_lines_on_card(cuda, n, order, dtype):
    """A contiguous view one element into its storage: no line starts on a
    16-byte boundary, so the warp-per-line tier loads element by element."""
    flat = _scan_input((5 * n + 1,), dtype, n, cuda)
    a = flat[1:].view(5, n)
    assert a.is_contiguous() and a.data_ptr() % 16
    block = n if order == "sequential" else scan.XLA_SCAN_BLOCK
    assert _same_bits(scan.scan_cuda(a, -1, block), scan.cumsum(a, block))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n", [4097, 65537])
def test_scan_kernel_deep_tiles_on_card(cuda, n, dtype):
    """XLA's order along a middle axis past three and four levels: the tile
    kernel carries each level's sums from chunk to chunk."""
    a = _scan_input((2, n, 3), dtype, n, cuda)
    assert _same_bits(scan.scan_cuda(a, 1, scan.XLA_SCAN_BLOCK), scan.prefix_sum_plain(a, 1, scan.XLA_SCAN_BLOCK))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_scan_kernel_on_non_contiguous_inputs_on_card(cuda, dtype):
    a = _scan_input((40, 3, 600), dtype, 7, cuda)
    for view, dim in ((a.transpose(0, 2), 0), (a[:, 1, ::2], 1), (a.permute(2, 0, 1)[:, :, 1], 0),
                      (a[0, :, :1].expand(3, 1000), 1)):
        assert not view.is_contiguous()
        for block in (view.shape[dim], scan.XLA_SCAN_BLOCK):
            assert _same_bits(scan.scan_cuda(view, dim, block), scan.prefix_sum_plain(view, dim, block))


def test_scan_kernel_refuses_what_it_cannot_take(cuda):
    a = torch.ones(4, 40, device=cuda)
    with pytest.raises(ValueError, match="block 8"):
        scan.scan_cuda(a, -1, 8)
    with pytest.raises(ValueError, match="float32 or float64"):
        scan.scan_cuda(a.half(), -1, 16)
    with pytest.raises(ValueError, match="CUDA tensors"):
        scan.scan_cuda(a.cpu(), -1, 16)


@pytest.mark.parametrize("mode,window", [("progressive", 0), ("insample", 8)])
def test_sizey_and_ksplus_on_card_match_cpu_run(cuda, mode, window):
    """``simulate_task_methods`` with Sizey and KS+ on the card, through
    the scan kernel, against ``device="cpu"``: retries exact."""
    from repro_torch.sim import torch_sim
    from repro_torch.sim.traces import generate_eager

    methods = ("sizey", "ksplus", "ksegments-selective", "witt-lr")
    tasks = generate_eager(seed=5, scale=0.2).eligible_tasks(10)
    assert tasks
    retried = 0
    for t in tasks:
        x, y, lengths = t.padded()
        kw = dict(methods=methods, error_mode=mode, insample_window=window)
        ops.reset_launch_counts()
        w_card, r_card = torch_sim.simulate_task_methods(x, y, lengths, t.default_mib, **kw)
        assert ops.launch_counts()["scan"] >= 3  # the fold, the prefix bank, Sizey's scores
        w_cpu, r_cpu = torch_sim.simulate_task_methods(x, y, lengths, t.default_mib, device="cpu", **kw)
        assert torch.equal(r_card.cpu(), r_cpu), t.name
        torch.testing.assert_close(w_card.cpu(), w_cpu, **WASTE_TOL)
        retried += int(r_cpu.sum())
    assert retried > 0


# ---------------------------------------------------------------------------
# the admission controller's decision scan
# ---------------------------------------------------------------------------

# (Pp, C, k): each storage path of `extra` (registers, 1 to 8 probes a
# thread; the global scratch), 1 to 256 candidates, k 1 to 15
ADMISSION_CASES = [
    (0, 1, 4), (1, 3, 1), (100, 17, 4), (1024, 64, 4), (1025, 8, 2), (2048, 256, 4), (4096, 256, 4),
    (8192, 256, 4), (8192, 1, 15), (8193, 32, 4), (20000, 200, 4), (27000, 64, 15), (40000, 256, 4), (40000, 1, 1),
    (6061, 1, 4),
]
# probes put on the kernel's splits (_stress_admission's kinds), at two shapes
ADMISSION_SPLIT_CASES = [(kind, *shape) for kind in ("edges", "inf", "empty", "all", "clock")
                         for shape in ((300, 40, 4), (2048, 96, 3))]


def _admission_inputs(seed: int, Pp: int, C: int, k: int, dev, n_real: int | None = None):
    """Decision-scan arguments: ``n_real`` sorted probes in [0, 100) s
    (+inf padded to Pp, with repeats of candidates' own instants), a rough
    profile, C candidates starting in [0, 50) s with k-step plans, a few
    invalid; the budget the profile's peak plus three median plans, so the
    budget binds partway through the batch."""
    rng = np.random.default_rng(seed)
    n_real = Pp if n_real is None else n_real
    starts = np.sort(rng.uniform(0.0, 50.0, C))
    bnd = np.sort(rng.uniform(0.5, 50.0, (C, k)), axis=1)
    bnd[rng.random((C, k)) < 0.05] = np.inf
    bnd = np.sort(bnd, axis=1)
    bnd[:, -1] = np.where(np.isfinite(bnd[:, -1]), bnd[:, -1], 60.0)
    val = np.maximum.accumulate(rng.uniform(10.0, 300.0, (C, k)), axis=1)
    ends = starts + bnd[:, -1]
    rels = np.nextafter(ends, np.inf)
    sw = np.nextafter(starts[:, None] + bnd, np.inf)
    live = np.isfinite(bnd) & (starts[:, None] + bnd < rels[:, None])
    valext = np.concatenate([val, val[:, -1:]], axis=1)
    own = np.concatenate([starts, sw[np.isfinite(sw)]])
    P = np.sort(np.concatenate([rng.choice(own, min(len(own), n_real // 2)) if n_real else own[:0],
                                rng.uniform(0.0, 100.0, n_real - min(len(own), n_real // 2))]))
    prof = np.cumsum(rng.normal(0.0, 20.0, n_real)) + 2000.0
    budget = float(prof.max(initial=0.0)) + 3.0 * float(np.median(val[:, -1]))
    valid = rng.random(C) > 0.1
    f64 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float64)).to(dev)  # noqa: E731
    args = [f64(np.concatenate([P, np.full(Pp - n_real, np.inf)])), f64(np.concatenate([prof, np.zeros(Pp - n_real)])),
            f64(starts), f64(ends), f64(rels), f64(bnd), f64(val), f64(valext), f64(sw),
            torch.from_numpy(live).to(dev), torch.from_numpy(valid).to(dev)]
    return args, budget


def _stress_admission(seed: int, Pp: int, C: int, k: int, kind: str):
    """``_admission_inputs`` with probes and candidates put on the splits:
    ``edges`` probes exactly at starts, ends, start + bnd[q] and sw[q];
    ``inf`` +inf boundaries (some plans never end); ``empty`` windows with
    no probe (end before start, release at start); ``all`` windows holding
    every probe; ``clock`` every candidate starting at one instant, as the
    controller's batches do, the profile peaking there."""
    args, budget = _admission_inputs(seed, Pp, C, k, "cpu", n_real=Pp - Pp // 7)
    P, prof, starts, ends, rels, bnd, val, valext, sw, live, valid = (a.numpy().copy() for a in args)
    INF = np.inf
    rng = np.random.default_rng(seed)
    if kind == "inf":
        rows = rng.random(C) < 0.3
        bnd[rows, -1] = INF
        bnd[rng.random((C, k)) < 0.1] = INF
        bnd = np.sort(bnd, axis=1)
        ends = starts + bnd[:, -1]
        rels = np.nextafter(ends, INF)
        sw = np.nextafter(starts[:, None] + bnd, INF)
        live = np.isfinite(bnd) & (starts[:, None] + bnd < rels[:, None])
    elif kind == "empty":
        rows = rng.random(C) < 0.5
        ends[rows] = starts[rows] - 1.0
        rels[rows] = starts[rows]
    elif kind == "all":
        rows = rng.random(C) < 0.3
        starts[rows] = -1.0
        ends[rows] = 1e6
        rels[rows] = np.nextafter(1e6, INF)
    elif kind == "clock":  # the profile's peak at the clock, so the probe there binds
        starts[:] = P[len(P) // 3]
        prof[len(P) // 3] = prof.max() + 1.0
        ends = starts + bnd[:, -1]
        rels = np.nextafter(ends, INF)
        sw = np.nextafter(starts[:, None] + bnd, INF)
        live = np.isfinite(bnd) & (starts[:, None] + bnd < rels[:, None])
    on = np.concatenate([starts, ends, (starts[:, None] + bnd).ravel(), sw.ravel()])
    on = on[np.isfinite(on)]
    if kind == "edges":  # half the real probes sit on a start, end, boundary or switch
        real = P[np.isfinite(P)]
        n_on = min(len(on), len(real) // 2)
        real = np.concatenate([real[: len(real) - n_on], rng.choice(on, n_on, replace=False)])
        P = np.concatenate([np.sort(real), P[~np.isfinite(P)]])
    return [P, prof, starts, ends, rels, bnd, val, valext, sw, live, valid], budget


def _decide_both(args, budget):
    from repro_torch.kernels import admission
    from repro_torch.sim.device_timeline import admission_scan_plain

    before = admission.launches
    got = ops.admission_scan(*args, budget)
    assert admission.launches == before + 1
    want = admission_scan_plain(*args, budget)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.parametrize("Pp,C,k", ADMISSION_CASES, ids=lambda v: str(v))
def test_admission_kernel_matches_plain_on_card(cuda, Pp, C, k):
    args, budget = _admission_inputs(Pp + C + k, Pp, C, k, cuda, n_real=Pp - Pp // 7)
    got, want = _decide_both(args, budget)
    assert got.dtype == torch.bool and got.shape == (C,)
    assert torch.equal(got, want)
    if Pp >= 1024 and C >= 64:
        assert 0 < int(want.sum()) < int(args[-1].sum())  # the budget binds


def _register_edge(C: int, k: int) -> int:
    """The largest probe count the plan keeps in registers, bisected on
    ``admission.plan``."""
    from repro_torch.kernels import admission

    lo, hi = 0, 1 << 16
    assert admission.plan(lo, C, k)["tier"] == 1 and admission.plan(hi, C, k)["tier"] == 0
    while hi - lo > 1:
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if admission.plan(mid, C, k)["tier"] == 1 else (lo, mid)
    return lo


def test_admission_kernel_reaches_both_storage_tiers(cuda):
    from repro_torch.kernels import admission

    tiers = set()
    for Pp, C, k in ADMISSION_CASES:
        pl = admission.plan(Pp, C, k)
        tiers.add(admission.TIERS[pl["tier"]])
        assert pl["threads"] == min(1024, max(32, 32 * -(-Pp // 8 // 32)))  # 8 probes a thread
        owned = -(-Pp // pl["threads"]) * pl["threads"]  # each thread's consecutive probes
        assert pl["scratch"] == (8 * owned if pl["tier"] == 0 else 0)
    assert tiers == {"registers", "global"}
    assert _register_edge(64, 4) == 8192  # 8 probes a thread, up to 1,024 threads


@pytest.mark.parametrize("side", ["below", "above"])
@pytest.mark.parametrize("C,k", [(1, 4), (64, 4), (256, 15)], ids=lambda v: str(v))
def test_admission_kernel_at_the_register_edge_on_card(cuda, side, C, k):
    from repro_torch.kernels import admission

    Pp = _register_edge(C, k) + (side == "above")
    assert admission.plan(Pp, C, k)["tier"] == (side == "below")
    args, budget = _admission_inputs(Pp + C, Pp, C, k, cuda, n_real=Pp - Pp // 7)
    got, want = _decide_both(args, budget)
    assert torch.equal(got, want)


@pytest.mark.parametrize("kind,Pp,C,k", ADMISSION_SPLIT_CASES, ids=lambda v: str(v))
def test_admission_kernel_on_the_splits_on_card(cuda, kind, Pp, C, k):
    args, budget = _stress_admission(7 + Pp + C, Pp, C, k, kind)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in args]
    for b in (budget, float(args[1].max()) + 2.0 * float(args[6][:, -1].median()), float("inf")):
        got, want = _decide_both(args, b)
        assert torch.equal(got, want)


@pytest.mark.parametrize("Pp", [300, 9000, 40000])
def test_admission_kernel_edge_cases_on_card(cuda, Pp):
    C, k = 24, 4
    # nothing valid: no candidate is admitted
    args, budget = _admission_inputs(1, Pp, C, k, cuda)
    args[-1] = torch.zeros(C, dtype=torch.bool, device=cuda)
    got, want = _decide_both(args, budget)
    assert torch.equal(got, want) and not got.any()
    # everything admitted under an unbounded budget
    args, _ = _admission_inputs(2, Pp, C, k, cuda)
    args[-1] = torch.ones(C, dtype=torch.bool, device=cuda)
    got, want = _decide_both(args, float("inf"))
    assert torch.equal(got, want) and got.all()
    # a sum exactly at the budget fits (the test is strict)
    args, _ = _admission_inputs(3, Pp, C, k, cuda)
    args[1] = torch.full_like(args[1], 1000.0)
    args[6] = torch.full_like(args[6], 100.0)
    args[7] = torch.full_like(args[7], 100.0)
    args[-1] = torch.ones(C, dtype=torch.bool, device=cuda)
    args[-2] = torch.zeros_like(args[-2])  # no switch fires: D is the first value on [start, release)
    got, want = _decide_both(args, 1100.0)
    assert torch.equal(got, want) and got[0]
    got, want = _decide_both(args, float(np.nextafter(1100.0, 0.0)))
    assert torch.equal(got, want) and not got.any()
    # empty windows (end before start, release at start): always admitted, no demand
    args, budget = _admission_inputs(4, Pp, C, k, cuda)
    args[3] = args[2] - 1.0
    args[4] = args[2].clone()
    args[-1] = torch.ones(C, dtype=torch.bool, device=cuda)
    got, want = _decide_both(args, budget)
    assert torch.equal(got, want) and got.all()


def test_admission_kernel_refuses_what_it_cannot_take(cuda):
    from repro_torch.kernels import admission

    args, budget = _admission_inputs(5, 64, 4, 2, cuda)
    with pytest.raises(ValueError, match="CUDA tensors"):
        admission.admission_cuda(*(a.cpu() for a in args), budget)
    bad = list(args)
    bad[0] = args[0].float()
    with pytest.raises(ValueError, match="admission P"):
        admission.admission_cuda(*bad, budget)
    bad = list(args)
    bad[7] = args[6]  # valext must be (C, k + 1)
    with pytest.raises(ValueError, match="admission valext"):
        admission.admission_cuda(*bad, budget)


@pytest.mark.parametrize("arrival", ["poisson", "bursty", "diurnal"])
def test_batched_stream_on_card_matches_scalar(cuda, arrival):
    """``run_stream`` through the batched controller on the card, every
    batch of two or more through the decision kernel: the scalar run's
    decisions, counts and wastage."""
    from repro_torch.kernels import admission
    from repro_torch.serve.admission import BatchedAdmissionController
    from repro_torch.serve.stream import StreamConfig, run_stream

    kw = dict(poisson=dict(rate_per_s=8.0), bursty=dict(rate_per_s=40.0, burst_factor=8.0, hbm_budget_mib=150_000.0),
              diurnal=dict(rate_per_s=12.0, diurnal_amp=0.8, hbm_budget_mib=80_000.0))[arrival]
    cfg = StreamConfig(n_requests=400, arrival=arrival, seed=0, **kw)
    ctl = BatchedAdmissionController(cfg.hbm_budget_mib, k=cfg.k, interval_s=cfg.interval_s, device_min_batch=1)
    assert ctl.device == torch.device("cuda")
    before = admission.launches
    got = run_stream(cfg, "batched", controller=ctl)
    launched = admission.launches - before
    want = run_stream(cfg, "scalar")
    assert got.decisions == want.decisions
    assert (got.admitted, got.rejected, got.evicted, got.finished) == (
        want.admitted, want.rejected, want.evicted, want.finished)
    np.testing.assert_allclose(got.wastage["segmentwise_gib_s"], want.wastage["segmentwise_gib_s"], rtol=1e-12)
    assert launched > 0


def test_batched_controller_needs_cuda_unless_asked_for_cpu():
    """Runs without a card: ``device=None`` is the card and raises."""
    from repro_torch.serve.admission import BatchedAdmissionController
    from repro_torch.serve.stream import StreamConfig, run_stream

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchedAdmissionController(1000.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_stream(StreamConfig(n_requests=4, n_warmup=2), "batched")
    assert BatchedAdmissionController(1000.0, device="cpu").device == torch.device("cpu")


# ---------------------------------------------------------------------------
# the sharded controller's carried epoch (admission_epoch)
# ---------------------------------------------------------------------------

def _plan_rows(rng, start, k, dead):
    """One plan's events as the carried program splices them: +v0 at the
    start, each step at ``nextafter`` past a live boundary (+inf and 0 when
    dead), -v_end at the release; stably time-sorted."""
    b = np.sort(rng.uniform(0.5, 30.0, k))
    v = np.maximum.accumulate(rng.uniform(10.0, 500.0, k))
    if dead and k > 1:
        b[0] = b[-1] + 5.0  # past the release: this switch never fires
    rel = np.nextafter(start + b[-1], np.inf)
    live = np.isfinite(b) & (start + b < rel)
    sw = np.nextafter(start + b, np.inf)
    steps = np.append(np.diff(v), 0.0)
    v_end = np.append(v, v[-1])[live.sum()]
    t = np.concatenate([[start], np.where(live, sw, np.inf), [rel]])
    d = np.concatenate([[v[0]], np.where(live, steps, 0.0), [-v_end]])
    o = np.argsort(t, kind="stable")
    return t[o], d[o]


def random_epoch(seed, S, L, k, Cb, Rb, n_plans, Lp_mode="bucket", admit_frac=0.5, t0=100.0):
    """Carried states and a batch for ``S`` shards, made with numpy: each
    shard holds ``n_plans`` plans (some with a dead switch, some events at
    or before the clock ``t0``, ties at t0 and at candidate starts), folded
    sums of plans whose events have all been folded, releases of folded and
    unfolded plans, and Cb padded candidate rows (fresh codes, starts from
    t0 with ties, one dead switch).  The plans sit around 100 s: a clock
    ``t0`` past 150 s folds every event.  Returns (args, t0, budget, Lp)."""
    rng = np.random.default_rng(seed)
    Smax = 2 * n_plans + Cb + 8
    t_plans = 100.0
    base0 = rng.uniform(0.0, 2_000.0, S)
    tl_t = np.full((S, L), np.inf)
    tl_d = np.zeros((S, L))
    tl_c = np.full((S, L), -1, np.int32)
    slot_fold = np.zeros((S, Smax))
    rel_codes = np.full((S, Rb), -1, np.int32)
    live_max = 0
    for s in range(S):
        rows = []
        for c in range(n_plans):
            start = t_plans if c % 7 == 0 else float(rng.uniform(t_plans - 20.0, t_plans + 15.0))
            t, d = _plan_rows(rng, start, k, dead=c % 5 == 1)
            rows.append((t, d, np.full(len(t), c, np.int32)))
        t = np.concatenate([r[0] for r in rows])
        d = np.concatenate([r[1] for r in rows])
        c = np.concatenate([r[2] for r in rows])
        o = np.argsort(t, kind="stable")
        t, d, c = t[o][:L], d[o][:L], c[o][:L]
        tl_t[s, : len(t)], tl_d[s, : len(t)], tl_c[s, : len(t)] = t, d, c
        # earlier folds: every plan has a folded sum, and codes past n_plans
        # are plans folded away entirely
        folded = rng.uniform(-50.0, 400.0, n_plans + 4)
        slot_fold[s, : n_plans + 4] = folded
        n_rel = min(Rb, n_plans + 4, 1 + int(rng.integers(0, max(Rb - 1, 1))))
        rel = rng.choice(n_plans + 4, size=n_rel, replace=False).astype(np.int32)
        rel_codes[s, : len(rel)] = rel
        live_max = max(live_max, int(np.isfinite(t).sum()))
    C = rng.integers(1, Cb + 1, S)
    starts = np.full((S, Cb), np.inf)
    ends = np.full((S, Cb), -np.inf)
    rels = np.full((S, Cb), -np.inf)
    bnd = np.full((S, Cb, k), np.inf)
    val = np.zeros((S, Cb, k))
    codes = np.full((S, Cb), -1, np.int32)
    valid = np.zeros((S, Cb), bool)
    for s in range(S):
        n = int(C[s])
        st_ = np.sort(rng.uniform(t0, t0 + 3.0, n))
        st_[0] = t0
        if n > 2:
            st_[2] = st_[1]  # two candidates arrive together
            carried = tl_t[s][np.isfinite(tl_t[s]) & (tl_t[s] > t0)]
            if len(carried):
                st_[-1] = max(st_[-2], float(carried[0]))  # a start on a carried event
        b = np.sort(rng.uniform(0.5, 30.0, (n, k)), axis=1)
        v = np.maximum.accumulate(rng.uniform(10.0, 500.0, (n, k)), axis=1)
        if n > 1 and k > 1:
            b[1, 0] = b[1, -1] + 5.0  # a dead switch
        starts[s, :n] = st_
        ends[s, :n] = st_ + b[:, -1]
        rels[s, :n] = np.nextafter(ends[s, :n], np.inf)
        bnd[s, :n], val[s, :n] = b, v
        codes[s, :n] = np.arange(Smax - n, Smax, dtype=np.int32)
        valid[s, :n] = True
        if n > 3:
            valid[s, n // 2] = False  # an invalid row inside the batch
    Lp = {"bucket": max(live_max, 1), "none": None, "short": max(live_max // 2, 1)}[Lp_mode]
    if Lp is not None and Lp_mode == "bucket":
        Lp = min(L, -(-Lp // 8) * 8)
    args = (base0, tl_t, tl_d, tl_c, slot_fold, rel_codes, starts, ends, rels, bnd, val, codes, valid)
    return args, t0, _budget_admitting(args, t0, Lp, admit_frac), Lp


def _budget_admitting(args, t0, Lp, frac):
    """A budget under which about ``frac`` of the valid candidates are
    admitted (bisected with the plain epoch; above 1: every one fits)."""
    from repro_torch.sim.device_timeline import admission_epoch_plain

    lo, hi = 0.0, 1e7
    if frac > 1.0:
        return hi
    ta = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    want = frac * float(np.asarray(args[12]).sum())
    for _ in range(20):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if float(admission_epoch_plain(*ta, t0, mid, Lp)[0].sum()) < want else (lo, mid)
    return hi



EPOCH_CASES = [
    # seed, S, L, k, Cb, Rb, plans, Lp mode, share of the candidates admitted
    (0, 1, 64, 4, 8, 8, 6, "bucket", 0.6),
    (1, 2, 128, 4, 8, 8, 12, "none", 0.6),
    (2, 4, 256, 4, 16, 16, 25, "bucket", 0.5),
    (3, 4, 384, 3, 24, 8, 40, "bucket", 0.8),
    (4, 2, 512, 4, 8, 32, 60, "none", 0.5),  # Rb 32: the vectorised sum
    (5, 1, 96, 1, 8, 8, 10, "bucket", 0.7),
    (6, 4, 320, 4, 40, 16, 40, "short", 0.6),  # a live event past Lp: overflow
    (7, 2, 48, 4, 16, 8, 6, "bucket", 5.0),  # the merge runs past L: overflow
    (8, 2, 1024, 4, 32, 16, 150, "bucket", 0.7),
    (9, 2, 512, 4, 16, 64, 70, "bucket", 0.5),  # Rb 64: windows of 32
    (10, 4, 128, 2, 8, 8, 10, "none", 2.0),  # every candidate fits
]

# carried events and Q instants put on the kernel's splits (_stress_epoch's kinds)
EPOCH_SPLIT_CASES = [(kind, seed) for kind in ("ties", "dupq", "edges") for seed in (40, 41)]

def _stress_epoch(seed: int, kind: str):
    """``random_epoch`` with probes put on the splits: ``ties`` tie groups
    of carried events at candidates' starts and ends (straddling the window
    edges); ``dupq`` candidates sharing their start and boundaries, and a
    start on another's switch instant (duplicate Q instants); ``edges``
    starts, ends and start + bnd[q] exactly on carried events."""
    args, t0, _, Lp = random_epoch(seed, 4, 384, 4, 24, 8, 40, "bucket", 0.5)
    base0, tl_t, tl_d, tl_c, slot_fold, rel, starts, ends, rels, bnd, val, codes, valid = (np.array(a) for a in args)
    rng = np.random.default_rng(seed)
    INF = np.inf
    for s in range(tl_t.shape[0]):
        carried = np.flatnonzero(np.isfinite(tl_t[s]) & (tl_t[s] > t0))
        n = int(valid[s].sum())
        if len(carried) < 8 or n < 4:
            continue
        if kind == "ties":
            for j in rng.choice(carried[:-2], 4, replace=False):
                tl_t[s, j + 1] = tl_t[s, j]  # a tie group of two (the row stays sorted)
                c = int(rng.integers(0, n))
                if rng.random() < 0.5:
                    starts[s, c] = tl_t[s, j]
                else:
                    ends[s, c] = tl_t[s, j]
                    rels[s, c] = np.nextafter(ends[s, c], INF)
        elif kind == "dupq":
            starts[s, 1], bnd[s, 1] = starts[s, 0], bnd[s, 0]
            ends[s, 1], rels[s, 1] = ends[s, 0], rels[s, 0]
            starts[s, 3] = np.nextafter(starts[s, 2] + bnd[s, 2, 0], INF)
        elif kind == "edges":
            for c in range(n):
                x = tl_t[s, rng.choice(carried)]
                if x <= starts[s, c]:
                    starts[s, c] = x
                else:
                    bnd[s, c, int(rng.integers(0, 4))] = x - starts[s, c]
                    bnd[s, c] = np.sort(bnd[s, c])
                ends[s, c] = starts[s, c] + bnd[s, c, -1]
                if rng.random() < 0.3:
                    ends[s, c] = tl_t[s, rng.choice(carried)]
                rels[s, c] = np.nextafter(ends[s, c], INF)
    args = (base0, tl_t, tl_d, tl_c, slot_fold, rel, starts, ends, rels, bnd, val, codes, valid)
    return args, t0, Lp


# more shards, the microbench's shape, and a row past the shared memory
CARD_EPOCH_CASES = EPOCH_CASES + [
    (20, 8, 256, 4, 16, 16, 30, "bucket", 0.5),
    (21, 8, 1024, 4, 48, 8, 150, "bucket", 0.5),
    (22, 2, 8192, 4, 16, 16, 1300, "bucket", 0.5),
]


def _epoch_both(args, t0, budget, Lp, dev):
    """The kernel and the plain version (on the card and on the CPU) on one
    epoch; returns (kernel (res, *state), plain (admits, overflow, n_live,
    *state) on the card)."""
    from repro_torch.kernels import admission_epoch
    from repro_torch.sim.device_timeline import admission_epoch_plain

    cpu = [torch.from_numpy(np.ascontiguousarray(a)) for a in args]
    card = [a.to(dev) for a in cpu]
    before = admission_epoch.launches
    got = ops.admission_epoch(*card, t0, budget, Lp)
    assert admission_epoch.launches == before + 1
    want = admission_epoch_plain(*card, t0, budget, Lp)
    torch.cuda.synchronize()
    on_cpu = admission_epoch_plain(*cpu, t0, budget, Lp)
    for w, c in zip(want, on_cpu):  # the plain version gives the same bits on either device
        assert torch.equal(w.cpu(), c) if not c.is_floating_point() else _same_bits(w.cpu(), c)
    Cb = args[6].shape[1]
    res = got[0].cpu()
    assert torch.equal(res[:, :Cb].bool(), want[0].cpu())
    assert torch.equal(res[:, Cb].bool(), want[1].cpu())
    assert torch.equal(res[:, Cb + 1], want[2].cpu().to(torch.int32))
    for g, w in zip(got[1:], want[3:]):
        assert g.dtype == w.dtype and _same_bits(g.cpu(), w.cpu())
    return got, want


@pytest.mark.parametrize("case", CARD_EPOCH_CASES, ids=[f"seed{c[0]}-S{c[1]}-L{c[2]}-{c[7]}" for c in CARD_EPOCH_CASES])
def test_epoch_kernel_matches_plain_on_card(cuda, case):
    seed, S, L, k, Cb, Rb, n_plans, mode, frac = case
    args, t0, budget, Lp = random_epoch(seed, S, L, k, Cb, Rb, n_plans, mode, frac)
    _, want = _epoch_both(args, t0, budget, Lp, cuda)
    assert bool(want[1].any()) == (mode == "short" or seed == 7)


def test_epoch_kernel_folds_the_whole_row_on_card(cuda):
    """A clock past every event folds the whole row into base0 and the
    owners' slots, and the batch decides against an empty timeline."""
    args, t0, budget, Lp = random_epoch(30, 4, 320, 4, 16, 8, 40, "none", 0.5, t0=400.0)
    _, want = _epoch_both(args, t0, budget, None, cuda)
    admits, n_live = want[0].cpu(), want[2].cpu()
    assert int(n_live.max()) <= 6 * int(admits.sum(dim=1).max())  # only the admitted plans' events are left


def test_epoch_kernel_reaches_both_storage_plans(cuda):
    from repro_torch.kernels import admission_epoch

    plans = {}
    for seed, S, L, k, Cb, Rb, n_plans, mode, frac in CARD_EPOCH_CASES:
        pl = admission_epoch.plan(L, L, 2 * n_plans + Cb + 8, Cb, k)
        plans["global" if pl["scratch"] else "shared"] = pl
    assert set(plans) == {"shared", "global"}
    assert plans["global"]["smem"] < plans["shared"]["smem"]
    # the sharded microbench's shape (8 shards, 1,024 resident) stays in shared memory
    assert admission_epoch.plan(1024, 640, 224, 40, 4)["scratch"] == 0


@pytest.mark.parametrize("kind,seed", EPOCH_SPLIT_CASES, ids=lambda v: str(v))
def test_epoch_kernel_on_the_splits_on_card(cuda, kind, seed):
    args, t0, Lp = _stress_epoch(seed, kind)
    for frac in (0.3, 0.7, 2.0):
        _epoch_both(args, t0, _budget_admitting(args, t0, Lp, frac), Lp, cuda)


def test_epoch_kernel_refuses_what_it_cannot_take(cuda):
    from repro_torch.kernels import admission_epoch

    args, t0, budget, Lp = random_epoch(31, 2, 64, 4, 8, 8, 6)
    card = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda) for a in args]
    with pytest.raises(ValueError, match="CUDA tensors"):
        admission_epoch.admission_epoch_cuda(*(a.cpu() for a in card), t0, budget, Lp)
    bad = list(card)
    bad[3] = card[3].long()
    with pytest.raises(ValueError, match="admission_epoch tl_c"):
        admission_epoch.admission_epoch_cuda(*bad, t0, budget, Lp)
    with pytest.raises(ValueError, match="second"):
        admission_epoch.admission_epoch_cuda(*card, t0, budget, Lp, out=tuple(card[:5]))


def _sharded_pair(budget: float, n_shards: int, seed: int):
    from repro_torch.serve.admission import ShardedAdmissionController

    rng = np.random.default_rng(seed)
    pair = (ShardedAdmissionController(budget, k=4, interval_s=1.0, n_shards=n_shards),
            ShardedAdmissionController(budget, k=4, interval_s=1.0, n_shards=n_shards, device="cpu"))
    for _ in range(40):
        plen = int(rng.integers(100, 2000))
        s = (plen * 0.08 + 8.0 * np.arange(int(60 + plen * 0.05))).astype(np.float32)
        for c in pair:
            c.observe(plen, s)
    return pair, rng


def _same_controller_state(card, cpu):
    for g, w in zip(card._state, cpu._state):
        assert _same_bits(g.cpu(), w)
    assert (card._L, card._Smax, card.reseeds) == (cpu._L, cpu._Smax, cpu.reseeds)
    assert np.array_equal(card._n_live, cpu._n_live) and card._free == cpu._free


@pytest.mark.parametrize("arrival", ["poisson", "bursty", "diurnal"])
def test_sharded_stream_on_card_matches_cpu_run(cuda, arrival):
    """bench_serve's streams through the carried controller on the card: the
    CPU run's decisions, counts, wastage and final state, one
    admission_epoch launch per decision batch, nothing reseeded."""
    from repro_torch.kernels import admission_epoch
    from repro_torch.serve.stream import StreamConfig, make_controller, run_stream

    kw = dict(poisson=dict(rate_per_s=8.0), bursty=dict(rate_per_s=40.0, burst_factor=8.0, hbm_budget_mib=150_000.0),
              diurnal=dict(rate_per_s=12.0, diurnal_amp=0.8, hbm_budget_mib=80_000.0))[arrival]
    cfg = StreamConfig(n_requests=400, arrival=arrival, seed=0, **kw)
    card, cpu = make_controller(cfg, "sharded"), make_controller(cfg, "sharded", device="cpu")
    assert card.device == torch.device("cuda") and cpu.device == torch.device("cpu")
    batches = []
    real = card.try_admit_many
    card.try_admit_many = lambda ids, *a: batches.append(len(ids)) or real(ids, *a)
    before = admission_epoch.launches
    got = run_stream(cfg, "sharded", controller=card)
    launched = admission_epoch.launches - before
    want = run_stream(cfg, "sharded", controller=cpu)
    assert got.decisions == want.decisions == run_stream(cfg, "sharded-scalar").decisions
    assert (got.admitted, got.rejected, got.evicted, got.finished) == (
        want.admitted, want.rejected, want.evicted, want.finished)
    np.testing.assert_allclose(got.wastage["segmentwise_gib_s"], want.wastage["segmentwise_gib_s"], rtol=1e-12)
    assert launched == sum(n > 0 for n in batches) > 0 and card.reseeds == 0
    _same_controller_state(card, cpu)


def test_sharded_controller_on_card_through_growth_and_reseed(cuda):
    """L and Smax grow past their seeds, then an understated live count
    forces the overflow guard's reseed and replay: the card's decisions and
    state stay the CPU run's."""
    (card, cpu), rng = _sharded_pair(10_000_000.0, 2, 5)
    for step in range(14):
        if step == 11:
            for c in (card, cpu):
                c._n_live[:] = 0
        ids = [f"g{step}c{j}" for j in range(12)]
        plens = [int(rng.integers(100, 2000)) for _ in range(12)]
        got = card.try_admit_many(ids, plens, 0.5 * step)
        want = cpu.try_admit_many(ids, plens, 0.5 * step)
        assert [p is not None for p in got] == [p is not None for p in want]
        _same_controller_state(card, cpu)
        for rid in sorted(card.active)[:2]:
            card.release(rid)
            cpu.release(rid)
    assert card._L > 64 and card._Smax > 64 and card.reseeds == 1


def test_sharded_controller_needs_cuda_unless_asked_for_cpu():
    """Runs without a card: ``device=None`` is the card and raises."""
    from repro_torch.serve.admission import ShardedAdmissionController
    from repro_torch.serve.stream import StreamConfig, run_stream

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedAdmissionController(1000.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_stream(StreamConfig(n_requests=4, n_warmup=2), "sharded")
    assert ShardedAdmissionController(1000.0, device="cpu").device == torch.device("cpu")


# MoE: (N, k, E, C, D, skew, offset); skew biases the routing toward the low
# experts so that the capacity drops, offset shifts the ids as an expert
# slice sees them (ids outside [0, E) belong to other slices)
MOE_CARD_CASES = [
    (48, 2, 4, 25, 64, 0.0, 0),  # reduced qwen3-moe's widths
    (8192, 8, 128, 641, 4096, 3.0, 0),  # qwen3-moe's prefill, B 2 x 4,096
    (2, 8, 128, 1, 4096, 4.0, 0),  # qwen3-moe's decode, B 2
    (8192, 2, 8, 2561, 6144, 2.0, 0),  # grok-1-314b's widths
    (300, 3, 6, 40, 7, 3.0, 0),  # odd rows: 14 / 28 bytes
    (100, 2, 4, 10, 64, 3.0, 4),  # experts 4..7 of 8
    # token ranges split unevenly over the blocks, N k = 15,009 a multiple
    # of no chunk of ids; f32 rows of 8,448 bytes are two ring chunks
    (5003, 3, 16, 1000, 2112, 3.0, 0),
    (2000, 8, 128, 20, 4096, 3.0, 0),  # 15 or 16 tokens a block: copied through registers
]


def _moe_ids(N: int, k: int, E: int, skew: float, seed: int) -> torch.Tensor:
    """Each token's k distinct experts by biased random logits, as the
    router's top-k gives them (numpy, so the CPU tests can share it)."""
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((N, E)) - skew * np.arange(E) / E
    return torch.from_numpy(np.argsort(-logits, axis=1, kind="stable")[:, :k].astype(np.int32))


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view({torch.bfloat16: torch.int16, torch.float32: torch.int32}[t.dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MOE_CARD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_moe_kernels_match_plain_on_card(cuda, dtype, case):
    N, k, E, C, D, skew, offset = case
    ids = (_moe_ids(N, k, E + offset, skew, seed=N + E) - offset).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn((N, D), generator=g, device=cuda).to(dtype)
    before = (moe_dispatch.launches, moe_combine.launches)
    buf, pos = moe_dispatch.moe_dispatch_cuda(x, ids, E, C)
    want_buf, want_pos = moe_dispatch.moe_dispatch_plain(x, ids, E, C)
    torch.cuda.synchronize()
    assert torch.equal(pos, want_pos) and torch.equal(_bits(buf), _bits(want_buf))
    if skew > 0:
        assert int((want_pos >= C).sum()) > 0  # the capacity drops assignments
    if offset:
        assert int((want_pos < 0).sum()) > 0
    out_buf = torch.randn((E, C, D), generator=g, device=cuda).to(dtype)
    w = torch.rand((N, k), generator=g, device=cuda)
    w = w / w.sum(-1, keepdim=True)
    got = moe_combine.moe_combine_cuda(out_buf, ids, pos, w)
    want = moe_combine.moe_combine_plain(out_buf, ids, pos, w)
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))
    assert torch.equal(_bits(moe_combine.moe_combine_cuda(out_buf, ids, pos, w)), _bits(got))  # run to run
    assert (moe_dispatch.launches, moe_combine.launches) == (before[0] + 1, before[1] + 2)


def _dispatch_ids(case: str, N: int, k: int, E: int, seed: int) -> torch.Tensor:
    """ids of the dispatch's edge cases: experts repeated within a token with
    ids below 0 and at or above E in the same call; one expert that
    receives nothing; or an even spread that the capacity need not drop."""
    rng = np.random.default_rng(seed)
    if case == "repeats-and-foreign":
        ids = rng.integers(-3, E + 3, size=(N, k))
        ids[0] = 1  # the first token's k assignments all to expert 1
    elif case == "empty-expert":
        ids = rng.integers(0, E - 1, size=(N, k))
        ids[ids >= 2] += 1  # expert 2 receives nothing
    else:
        ids = rng.integers(0, E, size=(N, k))
    return torch.from_numpy(ids.astype(np.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", ["repeats-and-foreign", "empty-expert", "nothing-dropped"])
def test_moe_dispatch_edge_cases_match_plain_on_card(cuda, dtype, case):
    N, k, E, D = 777, 4, 8, 96
    ids = _dispatch_ids(case, N, k, E, seed=len(case)).to(cuda)
    counts = torch.bincount(ids[(ids >= 0) & (ids < E)].long(), minlength=E)
    C = int(counts.max()) if case == "nothing-dropped" else int(counts.max()) * 3 // 4
    x = torch.randn((N, D), generator=torch.Generator(device=cuda).manual_seed(1), device=cuda).to(dtype)
    before = moe_dispatch.launches
    buf, pos = moe_dispatch.moe_dispatch_cuda(x, ids, E, C)
    want_buf, want_pos = moe_dispatch.moe_dispatch_plain(x, ids, E, C)
    torch.cuda.synchronize()
    assert moe_dispatch.launches == before + 1
    assert torch.equal(pos, want_pos) and torch.equal(_bits(buf), _bits(want_buf))
    dropped = int((want_pos >= C).sum())
    if case == "repeats-and-foreign":
        assert int((want_pos < 0).sum()) > 0 and dropped > 0
        assert torch.equal(pos[0].sort().values, torch.arange(k, dtype=torch.int32, device=cuda))
    elif case == "empty-expert":
        assert int(counts[2]) == 0 and dropped > 0 and not buf[2].any()
    else:
        assert dropped == 0 and int((want_pos < 0).sum()) == 0


def test_moe_dispatch_on_two_streams_matches_plain_on_card(cuda):
    """Calls large enough that the kernel's blocks claim zero rows from its
    pool, alternating between two streams (each stream keeps its own claim
    counters, left zero by every launch) and shapes."""
    side = torch.cuda.Stream(device=cuda)
    cases = [(4096, 8, 64, 700, 1024), (3000, 2, 8, 1500, 2048)]
    inputs = []
    for N, k, E, C, D in cases:
        ids = _moe_ids(N, k, E, 2.0, seed=N).to(cuda)
        x = torch.randn((N, D), generator=torch.Generator(device=cuda).manual_seed(N), device=cuda)
        inputs.append((x.to(torch.bfloat16), ids, E, C))
    torch.cuda.synchronize()
    for rep in range(3):
        for i, (x, ids, E, C) in enumerate(inputs):
            with torch.cuda.stream(side if (rep + i) % 2 else torch.cuda.current_stream(cuda)):
                buf, pos = moe_dispatch.moe_dispatch_cuda(x, ids, E, C)
                want_buf, want_pos = moe_dispatch.moe_dispatch_plain(x, ids, E, C)
                assert int((want_buf == 0).all(-1).sum()) * x.shape[1] * 2 >= 16 << 20  # the pool takes part
                assert torch.equal(pos, want_pos) and torch.equal(_bits(buf), _bits(want_buf))


def test_moe_kernels_take_unaligned_rows_on_card(cuda):
    """Row bases off 16 bytes take the narrower copies and loads."""
    N, k, E, C, D = 64, 2, 4, 30, 64
    ids = _moe_ids(N, k, E, 2.0, seed=1).to(cuda)
    flat = torch.randn(N * D + 1, device=cuda).to(torch.bfloat16)
    x = flat[1:].view(N, D)  # 2 bytes past the allocation's base
    buf, pos = moe_dispatch.moe_dispatch_cuda(x, ids, E, C)
    want_buf, want_pos = moe_dispatch.moe_dispatch_plain(x, ids, E, C)
    assert torch.equal(pos, want_pos) and torch.equal(_bits(buf), _bits(want_buf))
    ob = torch.randn(E * C * D + 1, device=cuda).to(torch.bfloat16)[1:].view(E, C, D)
    w = torch.full((N, k), 0.5, device=cuda)
    assert torch.equal(_bits(moe_combine.moe_combine_cuda(ob, ids, pos, w)),
                       _bits(moe_combine.moe_combine_plain(ob, ids, pos, w)))


def test_reduced_moe_model_on_card_matches_cpu_run(cuda):
    """The reduced qwen3-moe in float32 on the card (flash, moe_dispatch and
    moe_combine) against the same weights on the CPU (their plain
    versions); greedy generation token for token."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import decode_step, forward, init_params
    from repro_torch.serve.engine import greedy_generate

    cfg = dataclasses.replace(get_config("qwen3-moe-235b-a22b").reduced(), dtype="float32")
    cpu = init_params(cfg, seed=3, device="cpu")
    card = init_params(cfg, seed=0, device=cuda)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 41)).astype(np.int32))
    T = 40
    ops.reset_launch_counts()
    full, _ = forward(card, tokens.to(cuda))
    _, cache = forward(card, tokens[:, :T].to(cuda), want_cache=True, cache_len=T + 8)
    dec, _ = decode_step(card, cache, tokens[:, T:].to(cuda), torch.full((2,), T, dtype=torch.int32))
    counts = ops.launch_counts()
    assert counts["moe_dispatch"] == counts["moe_combine"] == 3 * cfg.num_layers
    want_full, _ = forward(cpu, tokens)
    _, cpu_cache = forward(cpu, tokens[:, :T], want_cache=True, cache_len=T + 8)
    want_dec, _ = decode_step(cpu, cpu_cache, tokens[:, T:], torch.full((2,), T, dtype=torch.int32))
    scale = want_full.abs().max().item()
    assert (full.cpu() - want_full).abs().max().item() <= 1e-4 * scale
    assert (dec.cpu() - want_dec).abs().max().item() <= 1e-4 * scale
    got = greedy_generate(card, cfg, tokens[:, :12], steps=6)
    want = greedy_generate(cpu, cfg, tokens[:, :12], steps=6, device="cpu")
    assert torch.equal(got.cpu(), want)


def test_launcher_serves_an_moe_model_on_card(cuda):
    from repro_torch.launch import serve as launch_serve

    ops.reset_launch_counts()
    res = launch_serve.main(["--arch", "qwen3-moe-235b-a22b", "--requests", "8"])
    assert res["done"] == 8 and all(o.is_cuda for o in res["outputs"])
    counts = ops.launch_counts()
    assert counts["flash"] > 0 and counts["moe_dispatch"] > 0 and counts["moe_combine"] == counts["moe_dispatch"]


def _bf16_ulp(x: torch.Tensor) -> torch.Tensor:
    """The spacing of bf16 values at |x| (x float32)."""
    return torch.ldexp(torch.ones_like(x), (torch.frexp(x.abs()).exponent - 8).to(torch.int32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", MOE_CARD_CASES, ids=lambda c: "-".join(map(str, c)))
def test_moe_backward_kernels_match_plain_on_card(cuda, dtype, case):
    """The combine's backward kernel and the dispatch's (a combine launch
    with unit weights) against their plain versions on the dispatch's pos:
    d_out_buf and dxf bit for bit, dw within 1e-5 of max |dw| (f32) or one
    bf16 ulp (bf16), a dropped assignment's dw 0; each bit for bit on a
    second launch; dw alone the same bits."""
    from repro_torch.kernels import moe_combine_bwd

    N, k, E, C, D, skew, offset = case
    ids = (_moe_ids(N, k, E + offset, skew, seed=N + E) - offset).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn((N, D), generator=g, device=cuda).to(dtype)
    _, pos = moe_dispatch.moe_dispatch_cuda(x, ids, E, C)
    dbuf = torch.randn((E, C, D), generator=g, device=cuda).to(dtype)
    out_buf = torch.randn((E, C, D), generator=g, device=cuda).to(dtype)
    w = torch.rand((N, k), generator=g, device=cuda)
    w = w / w.sum(-1, keepdim=True)
    dout = torch.randn((N, D), generator=g, device=cuda).to(dtype)
    before = (moe_combine.launches, moe_combine_bwd.launches)
    dxf = moe_dispatch.moe_dispatch_bwd_cuda(dbuf, ids, pos)
    dxf2 = moe_dispatch.moe_dispatch_bwd_cuda(dbuf, ids, pos)
    d_buf, dw = moe_combine_bwd.moe_combine_bwd_cuda(dout, out_buf, ids, pos, w)
    d_buf2, dw2 = moe_combine_bwd.moe_combine_bwd_cuda(dout, out_buf, ids, pos, w)
    none, dw_only = moe_combine_bwd.moe_combine_bwd_cuda(dout, out_buf, ids, pos, w, need_buf=False)
    buf_only, none2 = moe_combine_bwd.moe_combine_bwd_cuda(dout, out_buf, ids, pos, w, need_w=False)
    assert (moe_combine.launches, moe_combine_bwd.launches) == (before[0] + 2, before[1] + 4)
    want_dxf = moe_dispatch.moe_dispatch_bwd_plain(dbuf, ids, pos)
    want_buf, want_dw = moe_combine_bwd.moe_combine_bwd_plain(dout, out_buf, ids, pos, w)
    torch.cuda.synchronize()
    assert none is None and none2 is None
    assert torch.equal(_bits(dxf), _bits(want_dxf)) and torch.equal(_bits(dxf2), _bits(dxf))
    assert torch.equal(_bits(d_buf), _bits(want_buf)) and torch.equal(_bits(d_buf2), _bits(d_buf))
    assert torch.equal(_bits(buf_only), _bits(d_buf))
    assert torch.equal(dw2, dw) and torch.equal(dw_only, dw)
    kept = (pos >= 0) & (pos < C)
    assert (dw[~kept] == 0).all()
    if dtype == torch.float32:
        assert (dw - want_dw).abs().max().item() <= 1e-5 * want_dw.abs().max().item()
    else:
        assert ((dw - want_dw).abs() <= _bf16_ulp(want_dw)).all()


def test_moe_combine_bwd_takes_unaligned_rows_on_card(cuda):
    """Row bases off 16 bytes take the one-element loads and stores."""
    from repro_torch.kernels import moe_combine_bwd

    N, k, E, C, D = 64, 2, 4, 30, 64
    ids = _moe_ids(N, k, E, 2.0, seed=1).to(cuda)
    _, pos = moe_dispatch.moe_dispatch_plain(torch.zeros((N, 1), device=cuda), ids, E, C)
    ob = torch.randn(E * C * D + 1, device=cuda).to(torch.bfloat16)[1:].view(E, C, D)
    dout = torch.randn(N * D + 1, device=cuda).to(torch.bfloat16)[1:].view(N, D)
    w = torch.full((N, k), 0.5, device=cuda)
    d_buf, dw = moe_combine_bwd.moe_combine_bwd_cuda(dout, ob, ids, pos, w)
    want_buf, want_dw = moe_combine_bwd.moe_combine_bwd_plain(dout, ob, ids, pos, w)
    assert torch.equal(_bits(d_buf), _bits(want_buf))
    assert ((dw - want_dw).abs() <= _bf16_ulp(want_dw)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moe_gradients_are_the_kernels_on_card(cuda, dtype):
    """Autograd through ops.moe_dispatch and ops.moe_combine on the card
    (``MoEDispatch``, ``MoECombine``): one dispatch, two combine (the
    forward's and the dispatch's backward's) and one combine_bwd launch,
    the gradients those of autograd through the plain versions on the CPU
    (dxf and d_out_buf bit for bit, dw within the kernel test's
    tolerance); pos not differentiable; under inference mode nothing is
    recorded."""
    from repro_torch.kernels import moe_combine_bwd

    N, k, E, C, D = 300, 4, 16, 60, 96
    ids = _moe_ids(N, k, E, 3.0, seed=5).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn((N, D), generator=g, device=cuda).to(dtype)
    ob = torch.randn((E, C, D), generator=g, device=cuda).to(dtype)
    w = torch.rand((N, k), generator=g, device=cuda)
    dbuf = torch.randn((E, C, D), generator=g, device=cuda).to(dtype)
    dout = torch.randn((N, D), generator=g, device=cuda).to(dtype)
    leaves = [t.clone().requires_grad_() for t in (x, ob, w)]
    ops.reset_launch_counts()
    buf, pos = ops.moe_dispatch(leaves[0], ids, E, C)
    out = ops.moe_combine(leaves[1], ids, pos, leaves[2])
    assert not pos.requires_grad and buf.grad_fn is not None and out.grad_fn is not None
    grads = torch.autograd.grad((buf, out), leaves, (dbuf, dout))
    counts = ops.launch_counts()
    assert (counts["moe_dispatch"], counts["moe_combine"], counts["moe_combine_bwd"]) == (1, 2, 1)
    # the plain versions' autograd on the CPU, which adds in index order
    # (on the card index_add_ and index_put_ add with atomics)
    plain = [t.cpu().requires_grad_() for t in (x, ob, w)]
    pbuf, ppos = moe_dispatch.moe_dispatch_plain(plain[0], ids.cpu(), E, C)
    pout = moe_combine.moe_combine_plain(plain[1], ids.cpu(), ppos, plain[2])
    want = torch.autograd.grad((pbuf, pout), plain, (dbuf.cpu(), dout.cpu()))
    grads = [g.cpu() for g in grads]
    assert torch.equal(pos.cpu(), ppos)
    assert torch.equal(_bits(grads[0]), _bits(want[0])) and torch.equal(_bits(grads[1]), _bits(want[1]))
    if dtype == torch.float32:
        assert (grads[2] - want[2]).abs().max().item() <= 1e-5 * want[2].abs().max().item()
    else:
        assert ((grads[2] - want[2]).abs() <= _bf16_ulp(want[2])).all()
    with torch.inference_mode():
        assert ops.moe_combine(leaves[1], ids, pos, leaves[2]).grad_fn is None
        assert ops.moe_dispatch(leaves[0], ids, E, C)[0].grad_fn is None
    assert moe_combine_bwd.launches == 1


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("name", ["qwen3-moe-235b-a22b", "grok-1-314b"])
def test_reduced_moe_train_step_on_card_matches_cpu_run(cuda, name, remat, monkeypatch):
    """One train step of a reduced MoE config in float32 on the card against
    the same step on the CPU: loss, grad_norm and lr within 1e-4, each
    first moment within 1e-4 of its leaf's max |mu|.  Launches a layer:
    flash 1 and flash_bwd 1, moe_dispatch 1, moe_combine 2 (the forward's
    and the dispatch's backward), moe_combine_bwd 1; under remat the
    recomputed forward adds a flash, a dispatch and a combine, and its
    dispatch gives the first pass's pos."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData
    from repro_torch.models.model import init_params
    from repro_torch.train import TrainConfig, init_train_state, make_train_step

    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32", remat=remat)
    batch = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=70, global_batch=2)).batch(0)
    seen = []
    dispatch = moe_dispatch.moe_dispatch_cuda

    def recording(xf, ids, E, C):
        buf, pos = dispatch(xf, ids, E, C)
        seen.append(pos.clone())
        return buf, pos

    monkeypatch.setattr(moe_dispatch, "moe_dispatch_cuda", recording)
    runs = {}
    for dev in ("cpu", cuda):
        model = init_params(cfg, seed=3, device="cpu").to(dev)
        state = init_train_state(model)
        step = make_train_step(cfg, TrainConfig(), model)
        ops.reset_launch_counts()
        state, m = step(state, {k: torch.from_numpy(v).to(dev) for k, v in batch.items()})
        runs[str(dev)] = (state, m, ops.launch_counts())
    (cpu_state, cpu_m, cpu_n), (state, m, n) = runs["cpu"], runs[str(cuda)]
    assert not any(cpu_n.values())
    L = cfg.num_layers
    f = 2 if remat else 1
    assert (n["flash"], n["flash_bwd"]) == (f * L, L)
    assert (n["moe_dispatch"], n["moe_combine"], n["moe_combine_bwd"]) == (f * L, (f + 1) * L, L)
    assert len(seen) == f * L
    if remat:  # the backward recomputes the layers last to first
        for i in range(L):
            assert torch.equal(seen[i], seen[2 * L - 1 - i]), i
    for key in ("loss", "grad_norm", "lr"):
        assert abs(m[key].item() - cpu_m[key].item()) <= 1e-4 * abs(cpu_m[key].item()), key
    for name, mu in state["opt"]["mu"].items():
        want = cpu_state["opt"]["mu"][name]
        assert (mu.cpu() - want).abs().max().item() <= 1e-4 * want.abs().max().item(), name


def test_launcher_trains_an_moe_model_on_card(cuda, tmp_path):
    """``python -m repro_torch.launch.train --arch qwen3-moe-235b-a22b``
    (reduced) on the card, 12 steps, one injected failure: one restart,
    step 12, the MoE layers' forward and backward kernels launched."""
    from repro_torch.launch import train as launch_train

    ops.reset_launch_counts()
    res = launch_train.main(["--arch", "qwen3-moe-235b-a22b", "--steps", "12", "--fail-at", "5", "--ckpt",
                             str(tmp_path)])
    assert res["restarts"] == 1 and res["step"] == 12
    assert all(np.isfinite(m["loss"]) for m in res["log"])
    counts = ops.launch_counts()
    assert counts["flash_bwd"] > 0 and counts["moe_combine_bwd"] == counts["flash_bwd"]
    assert counts["moe_dispatch"] == counts["flash"] and counts["moe_combine"] == counts["flash"] + counts["flash_bwd"]


# ---------------------------------------------------------------------------
# the recurrent mixers: WKV and RG-LRU
# ---------------------------------------------------------------------------

WKV_TOL = 1e-4  # of max |o| and of max |S|: the chunk form on the tensor cores (3 TF32 passes) against float32


def wkv_inputs(B: int, T: int, H: int, seed: int):
    """r, k, v (B, T, H, 64) N(0, 1), logw in [-1.2, -1e-6] (as the time
    mix clamps it, some at each end), u (H, 64) and a nonzero S0 (B, H, 64,
    64), float32 numpy (shared with the CPU tests)."""
    hd = 64
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, T, H, hd)).astype(np.float32) for _ in range(3))
    logw = np.clip(-np.exp(rng.uniform(-4.0, 0.5, (B, T, H, hd))), -1.2, -1e-6).astype(np.float32)
    u = (rng.standard_normal((H, hd)) * 0.1).astype(np.float32)
    S0 = rng.standard_normal((B, H, hd, hd)).astype(np.float32)
    return r, k, v, logw, u, S0


def wkv_clamp_inputs(B: int, T: int, H: int, seed: int):
    """``wkv_inputs`` with logw at the clamp -1.2 over every even chunk of
    64 tokens: the largest exp(-c) the chunk form meets (exp(76.8)), from
    a nonzero S0."""
    r, k, v, logw, u, S0 = wkv_inputs(B, T, H, seed)
    for t0 in range(0, T, 128):
        logw[:, t0:t0 + 64] = np.float32(-1.2)
    return r, k, v, logw, u, S0


def rglru_inputs(B: int, T: int, R: int, seed: int):
    """a in (0, 1) and b as the RG-LRU block makes them, and a nonzero h0,
    float32 numpy."""
    rng = np.random.default_rng(seed)
    a = np.exp(-8.0 * np.log1p(np.exp(4.0)) * rng.random((B, T, R))).astype(np.float32)
    b = (np.sqrt(np.maximum(1.0 - a.astype(np.float64) ** 2, 1e-12)) * rng.standard_normal((B, T, R))).astype(np.float32)
    return a, b, rng.standard_normal((B, R)).astype(np.float32)


@pytest.mark.parametrize("B,T,H", [(3, 37, 2), (3, 1, 2), (2, 64, 2), (1, 200, 3), (2, 16, 32), (2, 63, 2), (1, 64, 3),
                                   (2, 65, 2), (2, 129, 3), (2, 4096, 32)])
def test_wkv_kernel_matches_plain_on_card(cuda, B, T, H):
    args = [torch.from_numpy(a).to(cuda) for a in wkv_inputs(B, T, H, seed=B * T + H)]
    before = rwkv_wkv.launches
    o, S = ops.rwkv_wkv(*args)
    assert rwkv_wkv.launches == before + 1
    want_o, want_S = rwkv_wkv.wkv_plain(*args)
    torch.cuda.synchronize()
    assert o.shape == (B, T, H, 64) and S.shape == (B, H, 64, 64)
    assert (o - want_o).abs().max().item() <= WKV_TOL * want_o.abs().max().item()
    assert (S - want_S).abs().max().item() <= WKV_TOL * want_S.abs().max().item()


@pytest.mark.parametrize("T", [64, 300])
def test_wkv_kernel_at_the_decay_clamp_on_card(cuda, T):
    """logw at -1.2 for whole chunks, from a nonzero state: k_f reaches
    ~exp(76.8) |k| and q_f ~exp(-76.8) |r| within a chunk."""
    args = [torch.from_numpy(a).to(cuda) for a in wkv_clamp_inputs(2, T, 3, seed=T)]
    o, S = ops.rwkv_wkv(*args)
    want_o, want_S = rwkv_wkv.wkv_plain(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(o).all() and torch.isfinite(S).all()
    assert (o - want_o).abs().max().item() <= WKV_TOL * want_o.abs().max().item()
    assert (S - want_S).abs().max().item() <= WKV_TOL * want_S.abs().max().item()


def test_wkv_kernel_takes_unaligned_views_on_card(cuda):
    r, k, v, logw, u, S0 = (torch.from_numpy(a).to(cuda) for a in wkv_inputs(2, 5, 2, seed=7))
    flat = torch.zeros(r.numel() + 1, device=cuda)
    flat[1:] = r.flatten()
    r_off = flat[1:].view(r.shape)  # 4 bytes past the allocation's base
    o, S = ops.rwkv_wkv(r_off, k, v, logw, u, S0)
    want_o, want_S = rwkv_wkv.wkv_plain(r, k, v, logw, u, S0)
    assert (o - want_o).abs().max().item() <= WKV_TOL * want_o.abs().max().item()


@pytest.mark.parametrize("B,T,R", [(3, 37, 70), (3, 1, 70), (2, 300, 2560), (1, 4096, 33), (3, 1000, 2560),
                                   (2, 129, 96), (1, 2, 2560)])
def test_rglru_scan_kernel_matches_plain_on_card(cuda, B, T, R):
    a, b, h0 = (torch.from_numpy(x).to(cuda) for x in rglru_inputs(B, T, R, seed=T + R))
    before = rglru_scan.launches
    h_seq, h_last = ops.rglru_scan(a, b, h0)
    assert rglru_scan.launches == before + 1
    want_seq, want_last = rglru_scan.rglru_scan_plain(a, b, h0)
    torch.cuda.synchronize()
    assert torch.equal(h_seq, want_seq) and torch.equal(h_last, want_last)


@pytest.mark.parametrize("R", [2560, 70])
def test_rglru_scan_kernel_takes_unaligned_rows_on_card(cuda, R):
    """a, b and h0 views 4 bytes past a 16-byte boundary: the kernel's
    4-byte copies, never the plain version."""
    a, b, h0 = (torch.from_numpy(x).to(cuda) for x in rglru_inputs(2, 333, R, seed=R))
    views = []
    for x in (a, b, h0):
        flat = torch.zeros(x.numel() + 1, device=cuda)
        flat[1:] = x.flatten()
        views.append(flat[1:].view(x.shape))
    assert all(x.data_ptr() % 16 == 4 for x in views)
    before = rglru_scan.launches
    h_seq, h_last = ops.rglru_scan(*views)
    assert rglru_scan.launches == before + 1
    want_seq, want_last = rglru_scan.rglru_scan_plain(a, b, h0)
    torch.cuda.synchronize()
    assert torch.equal(h_seq, want_seq) and torch.equal(h_last, want_last)


def test_recurrent_kernels_refuse_what_they_cannot_take(cuda):
    r, k, v, logw, u, S0 = (torch.from_numpy(a).to(cuda) for a in wkv_inputs(1, 3, 1, seed=1))
    with pytest.raises(ValueError, match="head size 64"):
        rwkv_wkv.rwkv_wkv_cuda(r[..., :32].contiguous(), k[..., :32].contiguous(), v[..., :32].contiguous(),
                               logw[..., :32].contiguous(), u[:, :32].contiguous(), S0[..., :32, :32].contiguous())
    with pytest.raises(ValueError, match="CUDA tensors"):
        rwkv_wkv.rwkv_wkv_cuda(r.cpu(), k.cpu(), v.cpu(), logw.cpu(), u.cpu(), S0.cpu())
    a, b, h0 = (torch.from_numpy(x).to(cuda) for x in rglru_inputs(1, 3, 4, seed=1))
    with pytest.raises(ValueError, match="float32"):
        rglru_scan.rglru_scan_cuda(a.double(), b.double(), h0.double())
    with pytest.raises(ValueError, match="CUDA tensors"):
        rglru_scan.rglru_scan_cuda(a.cpu(), b.cpu(), h0.cpu())


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_reduced_recurrent_model_on_card_matches_cpu_run(cuda, name, monkeypatch):
    """A reduced recurrent model in float32 on the card against the same
    weights on the CPU: prefill, decode (the state written in place) and
    greedy generation.  On the card the recurrences never reach their
    plain versions: each call is one launch of its kernel."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import decode_step, forward, init_params
    from repro_torch.serve.engine import greedy_generate

    cfg = dataclasses.replace(get_config(name).reduced(), dtype="float32", d_model=128)
    cpu = init_params(cfg, seed=3, device="cpu")
    card = init_params(cfg, seed=0, device=cuda)
    card.load_state_dict(cpu.state_dict())
    tokens = torch.from_numpy(np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 71)).astype(np.int32))
    T = 70

    wkv_plain, lru_plain = rwkv_wkv.wkv_plain, rglru_scan.rglru_scan_plain

    def guard(fn):
        def call(*args):
            assert not any(isinstance(t, torch.Tensor) and t.is_cuda for t in args), "a CUDA tensor reached a plain version"
            return fn(*args)
        return call

    monkeypatch.setattr(rwkv_wkv, "wkv_plain", guard(wkv_plain))
    monkeypatch.setattr(rglru_scan, "rglru_scan_plain", guard(lru_plain))
    ops.reset_launch_counts()
    full, _ = forward(card, tokens.to(cuda))
    _, cache = forward(card, tokens[:, :T].to(cuda), want_cache=True, cache_len=T + 8)
    held = [{n: t.data_ptr() for n, t in c.items()} for c in cache]
    dec, cache = decode_step(card, cache, tokens[:, T:].to(cuda), torch.full((2,), T, dtype=torch.int32))
    assert held == [{n: t.data_ptr() for n, t in c.items()} for c in cache]  # written in place
    counts = ops.launch_counts()
    kind = "rwkv" if name.startswith("rwkv") else "rglru"
    n_rec = sum(k == kind for k in cfg.layer_kinds)
    assert counts["rwkv_wkv" if kind == "rwkv" else "rglru_scan"] == 3 * n_rec
    want_full, _ = forward(cpu, tokens)
    _, cpu_cache = forward(cpu, tokens[:, :T], want_cache=True, cache_len=T + 8)
    want_dec, cpu_cache = decode_step(cpu, cpu_cache, tokens[:, T:], torch.full((2,), T, dtype=torch.int32))
    scale = want_full.abs().max().item()
    assert (full.cpu() - want_full).abs().max().item() <= 1e-4 * scale
    assert (dec.cpu() - want_dec).abs().max().item() <= 1e-4 * scale
    for c, w in zip(cache, cpu_cache):
        for n in c:
            assert (c[n].cpu().float() - w[n].float()).abs().max().item() <= 1e-4 * w[n].float().abs().max().item(), n
    got = greedy_generate(card, cfg, tokens[:, :12], steps=6)
    want = greedy_generate(cpu, cfg, tokens[:, :12], steps=6, device="cpu")
    assert torch.equal(got.cpu(), want)


def _unaligned(x: torch.Tensor) -> torch.Tensor:
    """``x`` as a view 4 bytes past a 16-byte boundary."""
    flat = torch.zeros(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.flatten()
    view = flat[1:].view(x.shape)
    assert view.data_ptr() % 16 == 4
    return view


def _wkv_bwd_args(B: int, T: int, H: int, seed: int, dev):
    """``wkv_inputs`` and N(0, 1) gradients do and dS, on ``dev``."""
    rng = np.random.default_rng(seed + 1)
    do = rng.standard_normal((B, T, H, 64)).astype(np.float32)
    dS = rng.standard_normal((B, H, 64, 64)).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (*wkv_inputs(B, T, H, seed), do, dS)]


def _wkv_ckpt(args):
    """The forward kernel's checkpoints of ``_wkv_bwd_args``' inputs."""
    B, T, H, _ = args[0].shape
    ckpt = torch.empty(rwkv_wkv.checkpoint_shape(B, T, H), device=args[0].device)
    rwkv_wkv.rwkv_wkv_cuda(*args[:6], ckpt)
    return ckpt


WKV_BWD_CASES = [(3, 37, 2), (3, 1, 2), (2, 64, 2), (2, 65, 2), (1, 200, 3), (2, 129, 3), (2, 16, 32), (3, 1000, 2),
                 (2, 63, 40), (3, 65, 40), (3, 1000, 40)]


@pytest.mark.parametrize("unaligned", [False, True])
@pytest.mark.parametrize("B,T,H", WKV_BWD_CASES, ids=lambda c: str(c))
def test_wkv_bwd_kernel_matches_plain_on_card(cuda, B, T, H, unaligned):
    """Each of (dr, dk, dv, dlogw, du, dS0) within 1e-4 of its max |plain|
    (the token form's sums in other orders, the state updates fused, dlogw
    through the chunk identity), at ragged T, T = 1, a nonzero S0 and dS;
    r and do as views off 16 bytes; bit for bit from run to run."""
    from repro_torch.kernels import rwkv_wkv_bwd

    args = _wkv_bwd_args(B, T, H, seed=B * T + H, dev=cuda)
    call = [_unaligned(a) if unaligned and i in (0, 6) else a for i, a in enumerate(args)] + [_wkv_ckpt(args)]
    before = rwkv_wkv_bwd.launches
    got = rwkv_wkv_bwd.rwkv_wkv_bwd_cuda(*call)
    again = rwkv_wkv_bwd.rwkv_wkv_bwd_cuda(*call)
    assert rwkv_wkv_bwd.launches == before + 2
    want = rwkv_wkv_bwd.wkv_bwd_plain(*args)
    torch.cuda.synchronize()
    for name, g, g2, w in zip(("dr", "dk", "dv", "dlogw", "du", "dS0"), got, again, want):
        assert g.shape == w.shape and torch.isfinite(g).all(), name
        assert torch.equal(g, g2), name
        assert (g - w).abs().max().item() <= WKV_TOL * w.abs().max().item(), name


def test_wkv_bwd_kernel_writes_only_what_is_asked_on_card(cuda):
    from repro_torch.kernels import rwkv_wkv_bwd

    args = _wkv_bwd_args(2, 70, 2, seed=3, dev=cuda)
    ckpt = _wkv_ckpt(args)
    full = rwkv_wkv_bwd.rwkv_wkv_bwd_cuda(*args, ckpt)
    need = (True, False, True, True, False, False)
    part = rwkv_wkv_bwd.rwkv_wkv_bwd_cuda(*args, ckpt, need=need)
    for n, g, f in zip(need, part, full):
        assert (g is None) if not n else torch.equal(g, f)


@pytest.mark.parametrize("B,T,R", [(3, 37, 70), (3, 1, 70), (2, 300, 2560), (1, 4096, 33), (3, 1000, 2560),
                                   (2, 129, 96), (1, 2, 2560), (2, 17, 4), (3, 63, 2560), (3, 65, 2048), (2, 1000, 48),
                                   (3, 16, 40)])
def test_rglru_scan_bwd_kernel_matches_plain_on_card(cuda, B, T, R):
    """da, db and dh0 bit for bit (the same multiplies and adds, each
    rounded on its own, in the same order), at ragged T and R (R not a
    multiple of 4: the 4-byte copies; R not a multiple of the block's 32
    channels: TMA boxes past the row's end), and from run to run."""
    from repro_torch.kernels import rglru_scan_bwd

    a, b, h0 = (torch.from_numpy(x).to(cuda) for x in rglru_inputs(B, T, R, seed=T + R))
    h_seq, h_last = rglru_scan.rglru_scan_cuda(a, b, h0)
    rng = np.random.default_rng(T * R)
    dh_seq = torch.from_numpy(rng.standard_normal((B, T, R)).astype(np.float32)).to(cuda)
    dh_last = torch.from_numpy(rng.standard_normal((B, R)).astype(np.float32)).to(cuda)
    before = rglru_scan_bwd.launches
    got = rglru_scan_bwd.rglru_scan_bwd_cuda(a, h0, h_seq, dh_seq, dh_last)
    again = rglru_scan_bwd.rglru_scan_bwd_cuda(a, h0, h_seq, dh_seq, dh_last)
    assert rglru_scan_bwd.launches == before + 2
    want = rglru_scan_bwd.rglru_scan_bwd_plain(a, h0, h_seq, dh_seq, dh_last)
    torch.cuda.synchronize()
    for g, g2, w in zip(got, again, want):
        assert torch.equal(g, w) and torch.equal(g, g2)


@pytest.mark.parametrize("R", [2560, 70])
def test_rglru_scan_bwd_kernel_takes_unaligned_rows_on_card(cuda, R):
    """a, h0, h_seq and dh_seq views 4 bytes past a 16-byte boundary: the
    kernel's 4-byte copies, bit for bit; only what is asked is written."""
    from repro_torch.kernels import rglru_scan_bwd

    a, b, h0 = (torch.from_numpy(x).to(cuda) for x in rglru_inputs(2, 333, R, seed=R))
    h_seq, _ = rglru_scan.rglru_scan_cuda(a, b, h0)
    rng = np.random.default_rng(R)
    dh_seq = torch.from_numpy(rng.standard_normal((2, 333, R)).astype(np.float32)).to(cuda)
    dh_last = torch.from_numpy(rng.standard_normal((2, R)).astype(np.float32)).to(cuda)
    views = [_unaligned(x) for x in (a, h0, h_seq, dh_seq)]
    want = rglru_scan_bwd.rglru_scan_bwd_plain(a, h0, h_seq, dh_seq, dh_last)
    da, db, dh0 = rglru_scan_bwd.rglru_scan_bwd_cuda(*views, dh_last, need_h0=False)
    torch.cuda.synchronize()
    assert dh0 is None and torch.equal(da, want[0]) and torch.equal(db, want[1])


def test_wkv_checkpoints_leave_the_output_as_it_was_on_card(cuda):
    """The forward with its checkpoint output: o and S bit for bit those of
    the call without it; each checkpoint the kernel's own final state of
    the prefix up to it (bit for bit), and within 1e-4 of max |S| of the
    plain version's checkpoints; the last one S."""
    for B, T, H in ((2, 1, 3), (2, 64, 2), (2, 300, 3), (1, 1000, 40)):
        args = [torch.from_numpy(a).to(cuda) for a in wkv_inputs(B, T, H, seed=T + H)]
        o, S = rwkv_wkv.rwkv_wkv_cuda(*args)
        ckpt = torch.full(rwkv_wkv.checkpoint_shape(B, T, H), float("nan"), device=cuda)
        o2, S2 = rwkv_wkv.rwkv_wkv_cuda(*args, ckpt)
        torch.cuda.synchronize()
        assert torch.equal(o, o2) and torch.equal(S, S2)
        assert torch.equal(ckpt[:, :, -1], S)
        for c in range(ckpt.shape[2] - 1):
            _, Sc = rwkv_wkv.rwkv_wkv_cuda(*(a[:, :64 * (c + 1)].contiguous() for a in args[:4]), *args[4:])
            assert torch.equal(ckpt[:, :, c], Sc), (T, c)
        want = torch.empty_like(ckpt)
        rwkv_wkv.wkv_plain(*args, want)
        assert (ckpt - want).abs().max().item() <= WKV_TOL * want.abs().max().item()


def _kernel_launches(call, n: int = 4) -> dict[str, int]:
    """Device kernels that ``n`` calls of ``call()`` launch, by name, from
    the profiler's events (after 64 fills: the profiler drops a window's
    first device events)."""
    from torch.profiler import ProfilerActivity, profile

    pad = torch.empty(1, device="cuda")
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(64):
            pad.fill_(0.0)
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    return {e.key: e.count for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA
            and "FillFunctor" not in e.key}


def test_recurrent_bwd_kernels_launch_what_their_wrappers_say_on_card(cuda):
    """rwkv_wkv_bwd_cuda with the forward's checkpoints: three device
    launches (the state pass, the chunks, du's sum), two without du;
    rglru_scan_bwd_cuda one launch."""
    from repro_torch.kernels import rglru_scan_bwd, rwkv_wkv_bwd

    args = _wkv_bwd_args(2, 300, 3, seed=9, dev=cuda)
    ckpt = _wkv_ckpt(args)
    names = ("wkv_bwd_state_kernel", "wkv_bwd_chunk_kernel", "wkv_bwd_du_kernel")
    got = _kernel_launches(lambda: rwkv_wkv_bwd.rwkv_wkv_bwd_cuda(*args, ckpt=ckpt))
    assert sorted(got.values()) == [4, 4, 4] and all(any(n in k for k in got) for n in names), got
    got = _kernel_launches(lambda: rwkv_wkv_bwd.rwkv_wkv_bwd_cuda(*args, need=(True,) * 4 + (False, True), ckpt=ckpt))
    assert sorted(got.values()) == [4, 4] and not any("du_kernel" in k for k in got), got
    a, b, h0 = (torch.from_numpy(x).to(cuda) for x in rglru_inputs(2, 300, 2560, seed=9))
    h_seq, _ = rglru_scan.rglru_scan_cuda(a, b, h0)
    got = _kernel_launches(lambda: rglru_scan_bwd.rglru_scan_bwd_cuda(a, h0, h_seq, h_seq, h0))
    assert list(got.values()) == [4] and "rglru_bwd_kernel" in next(iter(got)), got


def test_recurrent_bwd_kernels_are_the_same_run_to_run_at_training_shapes_on_card(cuda):
    """rwkv6's (B 2, T 4,096, H 32) and recurrentgemma's (B 2, T 4,096, R
    2,560) training shapes: two runs of each backward bit for bit, the WKV's
    within 1e-4 of each output's max |plain| of the chunk form's plain
    version, the RG-LRU's the plain version's bit for bit."""
    from repro_torch.kernels import rglru_scan_bwd, rwkv_wkv_bwd

    g = torch.Generator(device=cuda).manual_seed(3)
    r, k, v, do = (torch.randn((2, 4096, 32, 64), generator=g, device=cuda) for _ in range(4))
    logw = torch.clamp(-torch.exp(torch.rand((2, 4096, 32, 64), generator=g, device=cuda) * 4.5 - 4.0), -1.2, -1e-6)
    u = torch.randn((32, 64), generator=g, device=cuda) * 0.1
    S0, dS = torch.zeros((2, 32, 64, 64), device=cuda), torch.randn((2, 32, 64, 64), generator=g, device=cuda)
    ckpt = torch.empty(rwkv_wkv.checkpoint_shape(2, 4096, 32), device=cuda)
    rwkv_wkv.rwkv_wkv_cuda(r, k, v, logw, u, S0, ckpt)
    got = rwkv_wkv_bwd.rwkv_wkv_bwd_cuda(r, k, v, logw, u, S0, do, dS, ckpt=ckpt)
    again = rwkv_wkv_bwd.rwkv_wkv_bwd_cuda(r, k, v, logw, u, S0, do, dS, ckpt=ckpt)
    want = rwkv_wkv_bwd.wkv_bwd_chunk_plain(r, k, v, logw, u, S0, do, dS, ckpt)
    torch.cuda.synchronize()
    for name, x, y, w in zip(("dr", "dk", "dv", "dlogw", "du", "dS0"), got, again, want):
        assert torch.equal(x, y), name
        assert (x - w).abs().max().item() <= WKV_TOL * w.abs().max().item(), name
    del r, k, v, do, logw, got, again, want, ckpt
    a, b, h0 = (torch.from_numpy(x).to(cuda) for x in rglru_inputs(2, 4096, 2560, seed=3))
    h_seq, _ = rglru_scan.rglru_scan_cuda(a, b, h0)
    dh_seq, dh_last = torch.randn(a.shape, generator=g, device=cuda), torch.randn(h0.shape, generator=g, device=cuda)
    got = rglru_scan_bwd.rglru_scan_bwd_cuda(a, h0, h_seq, dh_seq, dh_last)
    again = rglru_scan_bwd.rglru_scan_bwd_cuda(a, h0, h_seq, dh_seq, dh_last)
    want = rglru_scan_bwd.rglru_scan_bwd_plain(a, h0, h_seq, dh_seq, dh_last)
    for x, y, w in zip(got, again, want):
        assert torch.equal(x, y) and torch.equal(x, w)


def test_recurrent_gradients_are_the_kernels_on_card(cuda):
    """Autograd through ops.rwkv_wkv and ops.rglru_scan on the card: one
    forward and one backward launch each, the forward's outputs those of
    the kernel alone bit for bit, the gradients within 1e-4 of the plain
    versions' autograd (RG-LRU's bit for bit); no plain version is
    reached; under no_grad nothing is recorded."""
    from repro_torch.kernels import rglru_scan_bwd, rwkv_wkv_bwd

    args = _wkv_bwd_args(2, 100, 2, seed=5, dev=cuda)
    leaves = [t.clone().requires_grad_() for t in args[:6]]
    ops.reset_launch_counts()
    o, S = ops.rwkv_wkv(*leaves)
    grads = torch.autograd.grad((o, S), leaves, args[6:])
    counts = ops.launch_counts()
    assert counts["rwkv_wkv"] == 1 and counts["rwkv_wkv_bwd"] == 1
    alone = rwkv_wkv.rwkv_wkv_cuda(*args[:6])
    assert torch.equal(o.detach(), alone[0]) and torch.equal(S.detach(), alone[1])
    plain = [t.clone().requires_grad_() for t in args[:6]]
    want = torch.autograd.grad(rwkv_wkv.wkv_plain(*plain), plain, args[6:])
    for g, w in zip(grads, want):
        assert (g - w).abs().max().item() <= WKV_TOL * w.abs().max().item()

    a, b, h0 = (torch.from_numpy(x).to(cuda).requires_grad_() for x in rglru_inputs(2, 100, 96, seed=5))
    dh = torch.randn((2, 100, 96), device=cuda)
    h_seq, h_last = ops.rglru_scan(a, b, h0)
    grads = torch.autograd.grad(h_seq, (a, b, h0), dh)
    assert ops.launch_counts()["rglru_scan"] == 1 and ops.launch_counts()["rglru_scan_bwd"] == 1
    want = rglru_scan_bwd.rglru_scan_bwd_plain(a.detach(), h0.detach(), h_seq.detach(), dh, torch.zeros_like(h0))
    for g, w in zip(grads, want):
        assert torch.equal(g, w)
    with torch.no_grad():
        assert ops.rglru_scan(a, b, h0)[0].grad_fn is None and ops.rwkv_wkv(*leaves)[0].grad_fn is None
    assert rglru_scan_bwd.launches == 1 and rwkv_wkv_bwd.launches == 1


@pytest.mark.parametrize("name", ["rwkv6-1.6b", "recurrentgemma-2b"])
def test_launcher_serves_a_recurrent_model_on_card(cuda, name):
    from repro_torch.launch import serve as launch_serve

    ops.reset_launch_counts()
    res = launch_serve.main(["--arch", name, "--requests", "8"])
    assert res["done"] == 8 and all(o.is_cuda for o in res["outputs"])
    counts = ops.launch_counts()
    if name.startswith("rwkv"):
        assert counts["rwkv_wkv"] > 0 and counts["flash"] == 0
    else:
        assert counts["rglru_scan"] > 0 and counts["flash"] > 0


# ---------------------------------------------------------------------------
# the modality frontends and the trainer's host modules
# ---------------------------------------------------------------------------


def grid_positions(batch: int, n: int, rows: int, cols: int) -> np.ndarray:
    """Qwen2-VL's M-RoPE rows (3, batch, n) for a sequence whose first
    rows x cols tokens are an image: image token i at (t 0, h i // cols,
    w i % cols), text from max(rows, cols) on, the same on all three rows."""
    s = np.arange(n)
    P = rows * cols
    text = s - P + max(rows, cols)
    pos = np.stack([np.where(s < P, 0, text), np.where(s < P, s // cols, text), np.where(s < P, s % cols, text)])
    return np.ascontiguousarray(np.broadcast_to(pos[:, None], (3, batch, n)), dtype=np.int32)


@pytest.mark.parametrize("name,head_dim,sections", [("hubert-xlarge", 16, None), ("hubert-xlarge", 80, None),
                                                    ("qwen2-vl-72b", 16, (2, 3, 3)), ("qwen2-vl-72b", 128, None)])
def test_reduced_frontend_model_on_card_matches_cpu_run(cuda, name, head_dim, sections):
    """A reduced frontend model in float32 on the card (flash) against the
    same weights on the CPU (its plain version): hubert's encoder over
    audio frames; qwen2-vl's forward, prefill and decode with patch
    embeddings on the first 8 positions and grid M-RoPE rows, the caches'
    positions the sequence's."""
    import dataclasses

    from repro_torch.configs import get_config
    from repro_torch.models.model import decode_step, forward, init_params
    from repro_torch.serve.engine import make_decode_step, make_prefill_step

    changes = {"dtype": "float32", "head_dim": head_dim}
    if sections is not None:
        changes["mrope_sections"] = sections
    cfg = dataclasses.replace(get_config(name).reduced(), **changes)
    cpu = init_params(cfg, seed=3, device="cpu")
    card = init_params(cfg, seed=0, device=cuda)
    card.load_state_dict(cpu.state_dict())
    rng = np.random.default_rng(1)
    B, T = 2, 40
    if cfg.frontend == "audio_frames":
        inputs = {"features": torch.from_numpy(rng.normal(0, 1, (B, T, cfg.frontend_dim)).astype(np.float32))}
    else:
        inputs = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, T + 1)).astype(np.int32)),
                  "patch_embeds": torch.from_numpy(rng.normal(0, 1, (B, cfg.num_patches, cfg.d_model)).astype(np.float32)),
                  "mrope_positions": torch.from_numpy(grid_positions(B, T + 1, 2, 4))}
    on_card = {k: v.to(cuda) for k, v in inputs.items()}
    before = flash.launches
    full, _ = forward(card, **on_card)
    assert flash.launches - before == cfg.num_layers
    want_full, _ = forward(cpu, **inputs)
    scale = want_full.abs().max().item()
    assert (full.cpu() - want_full).abs().max().item() <= 1e-4 * scale
    if not cfg.has_decode:
        step, _ = make_prefill_step(cfg, T, device=cuda)(card, on_card)
        last, _ = forward(card, **on_card, last_only=True)
        assert torch.equal(step, last[:, 0])
        with pytest.raises(ValueError, match="encoder"):
            decode_step(card, [], torch.zeros((B, 1), dtype=torch.int32), torch.zeros((B,), dtype=torch.int32))
        return
    pre = {"tokens": inputs["tokens"][:, :T], "patch_embeds": inputs["patch_embeds"],
           "mrope_positions": inputs["mrope_positions"][:, :, :T]}
    nxt = {"tokens": inputs["tokens"][:, T:], "positions": torch.full((B,), T, dtype=torch.int32),
           "mrope_positions": inputs["mrope_positions"][:, :, T:]}
    logits, cache = make_prefill_step(cfg, T + 8, device=cuda)(card, {k: v.to(cuda) for k, v in pre.items()})
    dec, cache = make_decode_step(cfg, device=cuda)(card, cache, {k: v.to(cuda) for k, v in nxt.items()})
    want_logits, cpu_cache = make_prefill_step(cfg, T + 8, device="cpu")(cpu, pre)
    want_dec, cpu_cache = make_decode_step(cfg, device="cpu")(cpu, cpu_cache, nxt)
    assert (logits.cpu() - want_logits).abs().max().item() <= 1e-4 * scale
    assert (dec.cpu() - want_dec).abs().max().item() <= 1e-4 * scale
    assert (dec.cpu() - want_full[:, T]).abs().max().item() <= 2e-2 * scale  # the cache contract
    for c, w in zip(cache, cpu_cache):
        assert torch.equal(c["pos"].cpu(), w["pos"])
        assert torch.equal(c["pos"][:, : T + 1].cpu(), torch.arange(T + 1, dtype=torch.int32).expand(B, T + 1))


def test_checkpoint_of_cuda_tensors_round_trips_on_card(cuda, tmp_path):
    """A bf16 model's state_dict and int32 / float32 leaves on the card:
    saved (synchronously and by the AsyncCheckpointer), restored on the
    card bit for bit, and on the CPU when asked."""
    from repro_torch.checkpoint import AsyncCheckpointer, latest_step, restore, save
    from repro_torch.configs import get_config
    from repro_torch.data import DataConfig, SyntheticLMData, make_host_batch
    from repro_torch.models.model import init_params

    cfg = get_config("hubert-xlarge").reduced()
    model = init_params(cfg, seed=0, device=cuda)
    data = SyntheticLMData(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=2))
    tree = {"params": model.state_dict(), "batch": make_host_batch(data, 3),
            "opt": [torch.zeros(3, device=cuda), torch.tensor(7, dtype=torch.int32, device=cuda)]}
    assert all(t.is_cuda and t.dtype == torch.int32 for t in tree["batch"].values())
    save(str(tmp_path / "sync"), 3, tree)
    ck = AsyncCheckpointer(str(tmp_path / "async"), keep=1)
    ck.save(3, tree)
    ck.wait()
    for d in ("sync", "async"):
        assert latest_step(str(tmp_path / d)) == 3
        got = restore(str(tmp_path / d), 3, tree)
        back = restore(str(tmp_path / d), 3, tree, device="cpu")
        for k, t in tree["params"].items():
            assert got["params"][k].is_cuda and got["params"][k].dtype == t.dtype and torch.equal(got["params"][k], t)
            assert back["params"][k].device.type == "cpu" and torch.equal(back["params"][k], t.cpu())
        assert all(torch.equal(got["batch"][k], v) for k, v in tree["batch"].items())
        assert int(got["opt"][1]) == 7
