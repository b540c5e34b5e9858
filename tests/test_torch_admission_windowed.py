"""CPU rehearsal of the admission kernels' windowed algorithms.

``csrc/admission.cu`` and ``csrc/admission_epoch.cu`` bound each candidate's
work to its windows on the sorted probes: every per-probe predicate of the
plain versions is monotone along sorted probes, so one binary search of the
exact float64 predicate finds where it turns, and integer compares against
those split indices give the window bits, segment indices, switch counts
and event counts.  The mirrors below are numpy, written step for step as the
kernels compute (the pre-pass of binary searches, the fused test with a
speculative commit, the sorted Q with its merge rounds, the tie-group-final
carried events merged with it into one probe list, the suffix commit, the
merge ranks of the splice), and are held bit
for bit against ``admission_scan_plain`` and ``admission_epoch_plain`` on
the card tests' generators and on cases that put probes on the splits.
Then the preconditions the kernels rest on: sorted probes, nondecreasing
boundaries, and carried rows sorted with a +inf tail after every batch.
"""

import numpy as np
import pytest
import torch

from repro_torch.core.ksegments import KSegmentsConfig, KSegmentsModel
from repro_torch.core.timeline import shared_probe_set
from repro_torch.kernels.scan import xla_cumsum
from repro_torch.serve.admission import ShardedAdmissionController
from repro_torch.serve.stream import StreamConfig, run_stream
from repro_torch.sim.device_timeline import (
    _row_sum,
    _scatter_add_in_order,
    admission_epoch_plain,
    admission_scan_plain,
)
from test_torch_cuda import (
    ADMISSION_CASES,
    ADMISSION_SPLIT_CASES,
    EPOCH_CASES,
    EPOCH_SPLIT_CASES,
    _admission_inputs,
    _budget_admitting,
    _stress_admission,
    _stress_epoch,
    random_epoch,
)

INF = np.inf


def lead(n, x, pred) -> int:
    """The kernels' binary search: the length of the leading run of [0, n)
    on which pred(x(i)) holds (pred holds on a prefix)."""
    lo, hi = 0, n
    while lo < hi:
        mid = (lo + hi) >> 1
        if pred(x(mid)):
            lo = mid + 1
        else:
            hi = mid
    return lo


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a).view(np.int64) if a.dtype == np.float64 else a


# ---------------------------------------------------------------------------
# admission.cu
# ---------------------------------------------------------------------------


def runs_test(i, per, cuts, tested, value, sums, budget) -> bool:
    """The kernels' test of one candidate over its probes ``i`` (consecutive
    indices): in runs of ``per`` probes, as a thread owns them; a run with at
    most one cut (a split or range end past its first probe, from ``cuts``)
    is two sub-runs of one value each, and each is tested once, on its
    largest tested sum (fact 1); any other run probe by probe.  ``tested``,
    ``value`` and ``sums`` are per probe."""
    over = False
    for r0 in range(i[0] // per * per, i[-1] + 1, per):
        run = (i >= r0) & (i < r0 + per)
        inside = {x for x in cuts if r0 < x < r0 + per}
        if len(inside) <= 1:
            d = min(inside, default=r0 + per)
            for sub in (run & (i < d), run & (i >= d)):
                if (sub & tested).any():
                    over |= bool(np.max(sums[sub & tested]) + value[np.flatnonzero(sub)[0]] > budget)
        else:
            over |= bool((run & tested & (sums + value > budget)).any())
    return over


def admission_windowed(P, prof, starts, ends, rels, bnd, val, valext, sw, live, valid, budget, per=8):
    """``decide_kernel`` in numpy: the splits of each valid candidate, then
    one fused pass over [lo_c, max(hi, hr)) (``runs_test``) with the commit
    speculative."""
    Pp, (C, k) = len(P), bnd.shape
    x = P.__getitem__
    ext = np.zeros(Pp)
    admits = np.zeros(C, dtype=bool)
    for c in range(C):
        if not valid[c]:
            continue
        st, en, rl = starts[c], ends[c], rels[c]
        lo_c = lead(Pp, x, lambda p: not (p >= st))
        lo = lead(Pp, x, lambda p: not (p >= st and p > -INF))
        hi = lead(Pp, x, lambda p: p <= en and p < INF)
        hr = lead(Pp, x, lambda p: p < rl)
        seg = np.array([lead(Pp, x, lambda p, b=b: not (b < p - st)) for b in bnd[c]])
        swi = np.array([lead(Pp, x, lambda p, s=s: not (s <= p)) if lv else Pp for s, lv in zip(sw[c], live[c])])
        end = max(hi, hr)
        if end <= lo_c:  # no probe in either range
            admits[c] = True
            continue
        i = np.arange(lo_c, end)
        inw = (i >= lo) & (i < hi)
        idx = np.minimum((i[:, None] >= seg[None, :]).sum(axis=1), k - 1)
        over = runs_test(i, per, (lo_c, lo, hi, hr, end, *seg, *swi), inw, val[c, idx], prof[i] + ext[i], budget)
        spec = ext[i] + valext[c, (i[:, None] >= swi[None, :]).sum(axis=1)]
        if not over:
            admits[c] = True
            held = i < hr
            ext[i[held]] = spec[held]
    return admits


def _numpy_args(args):
    return [a.numpy() if isinstance(a, torch.Tensor) else a for a in args]


def _check_admission(args, budget):
    want = admission_scan_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), budget).numpy()
    got = admission_windowed(*args, budget)
    assert np.array_equal(got, want)
    return want


@pytest.mark.parametrize("Pp,C,k", [c for c in ADMISSION_CASES if c[0] <= 8193], ids=lambda v: str(v))
def test_admission_mirror_matches_plain(Pp, C, k):
    args, budget = _admission_inputs(Pp + C + k, Pp, C, k, "cpu", n_real=Pp - Pp // 7)
    want = _check_admission(_numpy_args(args), budget)
    if Pp >= 1024 and C >= 64:
        assert 0 < int(want.sum()) < int(args[-1].sum())  # the budget binds


@pytest.mark.parametrize("kind,Pp,C,k", ADMISSION_SPLIT_CASES, ids=lambda v: str(v))
def test_admission_mirror_on_the_splits(kind, Pp, C, k):
    args, budget = _stress_admission(7 + Pp + C, Pp, C, k, kind)
    if kind == "edges":  # probes really sit on the splits
        st, b = args[2], args[5]
        assert np.isin(st, args[0]).any() and np.isin((st[:, None] + b).ravel(), args[0]).any()
    want = _check_admission(args, budget)
    assert want.any()
    _check_admission(args, float(args[1].max()) + 2.0 * float(np.median(args[6][:, -1])))
    assert _check_admission(args, INF)[args[-1]].all()


def test_admission_mirror_at_the_budget():
    """A sum exactly at the budget fits (the test is strict)."""
    args, _ = _admission_inputs(3, 300, 24, 4, "cpu")
    args = _numpy_args(args)
    args[1][:] = 1000.0
    args[6][:] = 100.0
    args[7][:] = 100.0
    args[-1][:] = True
    args[-2][:] = False
    assert _check_admission(args, 1100.0)[0]
    assert not _check_admission(args, float(np.nextafter(1100.0, 0.0))).any()


@pytest.mark.parametrize("seed", range(6))
def test_monotone_rounding_lets_a_run_test_its_largest_sum(seed):
    """Fact 1: fl(x + v) never decreases as x grows, so some fl(fl(p_i +
    e_i) + v) exceeds b exactly when fl(max_i fl(p_i + e_i) + v) does; the
    kernels test a run of probes that shares v on its largest sum."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        n = int(rng.integers(1, 17))
        p = rng.uniform(0.0, 1e4, n) * 10.0 ** rng.integers(-3, 4)
        e = np.where(rng.random(n) < 0.3, 0.0, rng.uniform(0.0, 1e3, n))
        v = float(rng.uniform(0.0, 1e3))
        s = p + e
        b = float(np.nextafter(s[int(rng.integers(0, n))] + v, rng.choice([-INF, INF])))  # budgets at the edge
        for budget in (b, float(np.max(s) + v), float(np.nextafter(np.max(s) + v, -INF))):
            assert bool(((s + v) > budget).any()) == bool(np.max(s) + v > budget)


@pytest.mark.parametrize("seed", range(4))
def test_split_predicates_are_monotone_along_sorted_probes(seed):
    """Fact 2: along sorted probes (+-inf included) every predicate the
    kernels search turns at most once, also for infinite starts and
    boundaries, so one binary search finds where."""
    rng = np.random.default_rng(seed)
    P = np.sort(np.concatenate([rng.uniform(-50.0, 50.0, 64), [-INF, INF, INF, 0.0, 0.0]]))
    with np.errstate(invalid="ignore"):  # inf - inf: NaN, and every comparison with it False
        for st in (*rng.uniform(-60.0, 60.0, 6), -INF, INF, 0.0):
            for b in (*rng.uniform(0.0, 30.0, 4), 0.0, INF, -INF):
                for pred in (P >= st, P > st, P <= st + b, b < P - st, np.nextafter(st + b, INF) <= P):
                    steps = np.diff(pred.astype(np.int8))
                    assert np.all(steps >= 0) or np.all(steps <= 0)


# ---------------------------------------------------------------------------
# admission_epoch.cu
# ---------------------------------------------------------------------------


def merge_runs(keys: np.ndarray, ids: np.ndarray | None, run: int):
    """The kernel's merge rounds: ascending runs of ``run`` merged pairwise,
    each element placed by one binary search in its partner run (ties: the
    left run first)."""
    keys = keys.copy()
    ids = None if ids is None else ids.copy()
    n, w = len(keys), run
    while w < n:
        dst = np.empty_like(keys)
        idst = None if ids is None else np.empty_like(ids)
        for p in range(n):
            base = p // (2 * w) * (2 * w)
            mid, end = min(base + w, n), min(base + 2 * w, n)
            xv = keys[p]
            if p < mid:
                pos = p + lead(end - mid, lambda i: keys[mid + i], lambda y: y < xv)
            else:
                pos = base + (p - mid) + lead(mid - base, lambda i: keys[base + i], lambda y: y <= xv)
            dst[pos] = xv
            if ids is not None:
                idst[pos] = ids[p]
        keys, ids, w = dst, idst, 2 * w
    return keys, ids


def _plan_rows(st, en, rl, b, v):
    """A candidate's sorted events, their deltas' prefix sums from +0.0, and
    its probe instants sorted (the kernel's candidate table)."""
    k = len(b)
    lv = np.isfinite(b) & (st + b < rl)
    sw = np.nextafter(st + b, INF)
    t = np.concatenate([[st], np.where(lv, sw, INF), [rl]])
    steps = np.append(np.diff(v), 0.0)
    d = np.concatenate([[v[0]], np.where(lv, steps, 0.0), [-(v[lv.sum()] if lv.sum() < k else v[k - 1])]])
    o = np.argsort(t, kind="stable")
    t, d = t[o], d[o]
    cpre = np.zeros(k + 3)
    for j in range(k + 2):
        cpre[j + 1] = cpre[j] + d[j]
    q = np.sort(np.concatenate([[st], np.where(lv, sw, INF)]))
    return t, d, cpre, q


def _shard_windowed(base0, tl_t, tl_d, tl_c, slot_fold, rel_codes, starts, ends, rels, bnd, val, codes, valid, t0,
                    budget, Lp, per=2):
    """One block of ``epoch_kernel`` in numpy.  Steps 1-3 (releases, clock
    fold, fresh slots) run the plain version's sums; steps 4-5 are the
    kernel's probe list, windowed decisions and merge-ranked splice."""
    L, (Cb, k), Smax = len(tl_t), bnd.shape, len(slot_fold)
    K2, NQ, NE = k + 2, Cb * (k + 1), Cb * (k + 2)
    Lp = L if Lp is None else min(Lp, L)
    # 1. releases
    rv = rel_codes >= 0
    released = np.zeros(Smax + 1, dtype=bool)  # index Smax: an empty slot's -1, set by a padded row
    released[np.where(rv, rel_codes, Smax)] = True
    gone = released[np.where(tl_c >= 0, tl_c, Smax)]
    sf = torch.from_numpy(slot_fold)
    base = float(base0 - _row_sum(torch.from_numpy(np.where(rv, slot_fold[np.maximum(rel_codes, 0)], 0.0))))
    sf = sf.clone()
    sf[torch.from_numpy(rel_codes[rv].astype(np.int64))] = 0.0
    keep = ~gone
    wt = np.concatenate([tl_t[keep], np.full(gone.sum(), INF)])
    wd = np.concatenate([tl_d[keep], np.zeros(gone.sum())])
    wc = np.concatenate([tl_c[keep], np.full(gone.sum(), -1, np.int32)])
    # 2. the clock fold
    fold = wt <= t0
    folded = int(fold.sum())
    base = base + float(xla_cumsum(torch.from_numpy(np.where(fold, wd, 0.0)))[-1])
    sf = _scatter_add_in_order(sf, torch.from_numpy(np.where(fold & (wc >= 0), wc, Smax).astype(np.int64)),
                               torch.from_numpy(np.where(fold, wd, 0.0)))
    sh_t = np.concatenate([wt[folded:], np.full(folded, INF)])
    sh_d = np.concatenate([wd[folded:], np.zeros(folded)])
    sh_c = np.concatenate([wc[folded:], np.full(folded, -1, np.int32)])
    # 3. the candidates' fresh slots
    fresh = valid & (codes >= 0) & (codes < Smax)
    sf[torch.from_numpy(codes[fresh].astype(np.int64))] = 0.0
    # 4. the decision prefix and candidate tables; the probe list: the
    # tie-group-final carried events (read at cs, probed on (start, end])
    # and the sorted Q instants (read at cs0[#(pt <= Q)], probed on [start,
    # end]) merged into one ascending sequence
    pt, pd = sh_t[:Lp], sh_d[:Lp]
    cs = base + xla_cumsum(torch.from_numpy(pd)).numpy()
    rows = [_plan_rows(starts[c], ends[c], rels[c], bnd[c], val[c]) for c in range(Cb)]
    tn = np.stack([r[0] for r in rows])
    dn = np.stack([r[1] for r in rows])
    cpre = np.stack([r[2] for r in rows])
    tie = np.append(pt[:-1] != pt[1:], np.isfinite(pt[-1]))
    at, ar = pt[tie], cs[tie]
    qs, _ = merge_runs(np.concatenate([r[3] for r in rows]), None, k + 1)
    NA = len(at)
    NP = NA + NQ
    px, rd, kind = np.empty(NP), np.empty(NP), np.empty(NP, dtype=np.int64)
    for i in range(NA):
        pos = i + lead(NQ, qs.__getitem__, lambda y, xv=at[i]: y < xv)
        px[pos], rd[pos], kind[pos] = at[i], ar[i], 0
    for i in range(NQ):
        qv = qs[i]
        n = Lp if qv == INF else lead(Lp, pt.__getitem__, lambda y: y <= qv)
        pos = i + lead(NA, at.__getitem__, lambda y: y <= qv)
        px[pos], rd[pos], kind[pos] = qv, (base if n == 0 else cs[n - 1]), 1
    assert np.all(px[:-1] <= px[1:])
    x = px.__getitem__
    ex = np.zeros(NP)
    admits = np.zeros(Cb, dtype=bool)
    for c in range(Cb):
        if not valid[c]:
            continue
        st, en, cp = starts[c], ends[c], cpre[c]
        wge = lead(NP, x, lambda y: not (y >= st))
        wgt = lead(NP, x, lambda y: not (y > st))
        wh = lead(NP, x, lambda y: y <= en)
        seg = np.sort([lead(NP, x, lambda y, b=b: not (b < y - st)) for b in bnd[c]])
        evs = np.array([lead(NP, x, lambda y, e=e: not (e <= y)) for e in tn[c]])
        cl, ch = evs[0], (NP if cp[K2] != 0.0 else evs[K2 - 1])
        lo, end = min(wge, cl), max(wh, ch)
        if end <= lo:
            admits[c] = True
            continue
        i = np.arange(lo, end)
        inw = (i >= np.where(kind[i] == 1, wge, wgt)) & (i < wh)
        idx = np.minimum((i[:, None] >= seg[None, :]).sum(axis=1), k - 1)
        over = runs_test(i, per, (cl, ch, lo, end, *seg, *evs), inw, val[c, idx], rd[i] + ex[i], budget)
        held = (i >= cl) & (i < ch)
        spec = ex[i] + cp[(i[:, None] >= evs[None, :]).sum(axis=1)]
        if not over:
            admits[c] = True
            ex[i[held]] = spec[held]
    # 5. the splice: the new events merged in (time, index) order
    mkey = np.where(np.repeat(admits, K2), tn.ravel(), INF)
    snew, order = merge_runs(mkey, np.arange(NE), K2)
    rank = np.empty(NE, dtype=np.int64)
    rank[order] = np.arange(NE)
    out_t, out_d, out_c = np.full(L, np.nan), np.full(L, np.nan), np.full(L, -7, np.int32)
    fin_head = live = 0
    for i in range(Lp):
        place = i + lead(NE, snew.__getitem__, lambda y, xv=pt[i]: y < xv)
        fin_head += np.isfinite(pt[i])
        if place < L:
            out_t[place], out_d[place], out_c[place] = pt[i], pd[i], sh_c[i]
            live += np.isfinite(pt[i])
    for f in range(NE):
        c, xv = f // K2, mkey[f]
        place = (Lp if xv == INF else lead(Lp, pt.__getitem__, lambda y: y <= xv)) + rank[f]
        fin_head += np.isfinite(xv)
        if place < L:
            out_t[place] = xv
            out_d[place] = dn.ravel()[f] if admits[c] else 0.0
            out_c[place] = codes[c] if admits[c] else -1
            live += np.isfinite(xv)
    for j in range(Lp, L):
        if NE + j < L:
            out_t[NE + j], out_d[NE + j], out_c[NE + j] = sh_t[j], sh_d[j], sh_c[j]
            live += np.isfinite(sh_t[j])
    prefix_over = Lp < L and np.isfinite(sh_t[Lp])
    past = fin_head > L if L < Lp + NE else np.isfinite(sh_t[L - NE])
    return admits, bool(prefix_over or past), live, base, out_t, out_d, out_c, sf.numpy()


def epoch_windowed(args, t0, budget, Lp):
    shards = [_shard_windowed(*(np.asarray(a)[s] for a in args), t0, budget, Lp) for s in range(args[1].shape[0])]
    return [np.stack([np.asarray(x[j]) for x in shards]) for j in range(8)]


def _check_epoch(args, t0, budget, Lp):
    want = admission_epoch_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), t0, budget, Lp)
    got = epoch_windowed(args, t0, budget, Lp)
    for name, g, w in zip(("admits", "overflow", "n_live", "base0", "tl_t", "tl_d", "tl_c", "slot_fold"), got, want):
        w = w.numpy()
        assert np.array_equal(_bits(g.astype(w.dtype)), _bits(w)), name
    return [w.numpy() for w in want]


@pytest.mark.parametrize("case", EPOCH_CASES, ids=[f"seed{c[0]}-S{c[1]}-L{c[2]}-{c[7]}" for c in EPOCH_CASES])
def test_epoch_mirror_matches_plain(case):
    seed, S, L, k, Cb, Rb, n_plans, mode, frac = case
    args, t0, budget, Lp = random_epoch(seed, S, L, k, Cb, Rb, n_plans, mode, frac)
    want = _check_epoch(args, t0, budget, Lp)
    assert bool(want[1].any()) == (mode == "short" or seed == 7)


@pytest.mark.parametrize("kind,seed", EPOCH_SPLIT_CASES, ids=lambda v: str(v))
def test_epoch_mirror_on_the_splits(kind, seed):
    args, t0, Lp = _stress_epoch(seed, kind)
    n_valid = int(args[12].sum())
    assert int(_check_epoch(args, t0, 1e7, Lp)[0].sum()) == n_valid
    for frac in (0.3, 0.7):
        want = _check_epoch(args, t0, _budget_admitting(args, t0, Lp, frac), Lp)
        assert 0 < int(want[0].sum()) < n_valid


def test_epoch_mirror_with_the_whole_row_folded():
    args, t0, budget, _ = random_epoch(30, 4, 320, 4, 16, 8, 40, "none", 0.5, t0=400.0)
    _check_epoch(args, t0, budget, None)


def test_merge_rounds_sort_stably():
    """The merge rounds give a stable sort of any runs, ties by index."""
    rng = np.random.default_rng(3)
    for run, n in [(1, 17), (5, 40), (6, 240), (6, 6), (7, 50)]:
        keys = np.round(rng.uniform(0, 5, n), 0)
        keys[rng.random(n) < 0.2] = INF
        for r in range(0, n, run):
            keys[r:r + run] = np.sort(keys[r:r + run])
        got, ids = merge_runs(keys, np.arange(n), run)
        order = np.argsort(keys, kind="stable")
        assert np.array_equal(got, keys[order]) and np.array_equal(ids, order)


# ---------------------------------------------------------------------------
# the preconditions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_shared_probe_set_is_strictly_increasing(seed):
    rng = np.random.default_rng(seed)
    parts = [np.round(rng.uniform(0.0, 50.0, n), 1) for n in (200, 64, 256)]
    parts.append(np.concatenate([parts[0][:30], [INF, INF]]))  # duplicates across parts, +inf
    P = shared_probe_set(*parts)
    assert np.all(P[:-1] < P[1:])
    assert P[-1] == INF and len(P) < sum(len(p) for p in parts)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("k", [1, 4, 15])
def test_predict_batch_boundaries_are_nondecreasing(seed, k):
    rng = np.random.default_rng(seed)
    model = KSegmentsModel(KSegmentsConfig(k=k, interval_s=1.0, floor_mib=1.0))
    for _ in range(12):
        plen = int(rng.integers(100, 2000))
        model.observe(plen, (plen * 0.02 + rng.uniform(0.2, 1.0) * np.arange(int(20 + plen * 0.05))).astype(np.float32))
    bnd, _ = model.predict_batch(rng.uniform(50.0, 3000.0, 200))
    assert np.all(np.diff(bnd, axis=1) >= 0)


@pytest.mark.parametrize("arrival", ["poisson", "diurnal"])
def test_carried_rows_stay_sorted_with_an_inf_tail(arrival):
    """After every batch of a stream through the plain carried epoch, each
    shard's tl_t row is nondecreasing with a +inf tail."""
    kw = dict(poisson=dict(rate_per_s=8.0),
              diurnal=dict(rate_per_s=12.0, diurnal_amp=0.8, hbm_budget_mib=80_000.0))[arrival]
    cfg = StreamConfig(n_requests=120, arrival=arrival, seed=1, **kw)
    ctl = ShardedAdmissionController(cfg.hbm_budget_mib, k=cfg.k, interval_s=cfg.interval_s, n_shards=4, device="cpu")
    batches = []

    def checked(ids, *a, _orig=ctl.try_admit_many):
        out = _orig(ids, *a)
        tl_t = ctl._state[1].numpy()
        for s, row in enumerate(tl_t):
            n = int(ctl._n_live[s])
            assert np.all(row[:-1] <= row[1:]) and np.all(np.isfinite(row[:n])) and np.all(row[n:] == INF)
        batches.append(len(ids))
        return out

    ctl.try_admit_many = checked
    run_stream(cfg, "sharded", controller=ctl)
    assert len(batches) > 5 and max(batches) > 1
