"""The port's batched admission engine against the scalar oracles and the
reference's batched engine, on the CPU.

Twins of ``tests/test_serve_batch.py``: random admit/release/observe
interleavings drive the reference's scalar ``AdmissionController``, the
port's scalar controller and the port's ``BatchedAdmissionController``
(``device="cpu"``: the decision scan's plain version) in lockstep, on both
of the batched controller's paths (host below ``device_min_batch``, the
decision scan at or above it).  Decisions and plans must be equal exactly.
The reference's own batched engine runs its device program in float64
through ``jax.experimental.enable_x64``, which jax 0.9 no longer has; the
``x64`` fixture puts ``jax.enable_x64`` in its place for one test.  The
decision scan's plain version is held against the reference's
``admission_program`` on seeded padded inputs, admits equal."""

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.serve.admission import AdmissionController as RefAdmissionController
from repro.serve.admission import BatchedAdmissionController as RefBatchedAdmissionController
from repro.serve.stream import StreamConfig as RefStreamConfig
from repro.serve.stream import generate_arrivals as ref_generate_arrivals
from repro.serve.stream import run_stream as ref_run_stream
from repro.sim.device_timeline import admission_program as ref_admission_program
from repro_torch.core.timeline import Timeline, shared_probe_set
from repro_torch.kernels import ops
from repro_torch.serve.admission import AdmissionController, BatchedAdmissionController
from repro_torch.serve.stream import StreamConfig, generate_arrivals, run_stream
from repro_torch.sim.device_timeline import admission_scan_plain, pad_rows
from repro_torch.sim.traces import bucket_size


@pytest.fixture
def x64(monkeypatch):
    """The reference's float64 programs enter ``jax.experimental.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def _growth_series(plen, steps):
    return (plen * 0.08 + 8.0 * np.arange(steps)).astype(np.float32)


def _decided(plans):
    return [p is not None for p in plans]


def _same_plans(a, b):
    assert _decided(a) == _decided(b)
    for p, q in zip(a, b):
        if p is not None:
            assert (p.request_id, p.admitted_at) == (q.request_id, q.admitted_at)
            np.testing.assert_array_equal(p.alloc.boundaries, q.alloc.boundaries)
            np.testing.assert_array_equal(p.alloc.values, q.alloc.values)


def _trained(budget, rng, n_obs=50, ref_batched=False, **batched_kw):
    """(reference scalar, port scalar, port batched, and the reference's
    batched controller or None), trained alike."""
    ctls = (
        RefAdmissionController(budget, k=4, interval_s=1.0),
        AdmissionController(budget, k=4, interval_s=1.0),
        BatchedAdmissionController(budget, k=4, interval_s=1.0, device="cpu", **batched_kw),
        RefBatchedAdmissionController(budget, k=4, interval_s=1.0, **batched_kw) if ref_batched else None,
    )
    for _ in range(n_obs):
        plen = int(rng.integers(100, 2000))
        s = _growth_series(plen, int(60 + plen * 0.05 + rng.normal(0, 2)))
        for c in filter(None, ctls):
            c.observe(plen, s)
    return ctls


def _check_stream_parity(seed: int, device_min_batch: int, ref_batched: bool = False) -> None:
    """Random admit/release/observe interleavings: decisions and plans match
    call by call, and the active set and static reservation after.  The
    port's batched controller is held to the reference's scalar one, or to
    the reference's batched one when it runs too."""
    rng = np.random.default_rng(seed)
    ref, sc, bc, rb = _trained(12_000.0, rng, ref_batched=ref_batched, device_min_batch=device_min_batch)
    now = 0.0
    for step in range(60):
        op = rng.random()
        if op < 0.55:  # admission batch with per-candidate arrival times
            c = int(rng.integers(1, 9))
            ids = [f"s{step}c{j}" for j in range(c)]
            plens = [int(rng.integers(100, 2000)) for _ in range(c)]
            nows = now + np.sort(rng.uniform(0.0, 0.5, c))
            want = [ref.try_admit(r, p, float(t)) for r, p, t in zip(ids, plens, nows)]
            _same_plans(want, [sc.try_admit(r, p, float(t)) for r, p, t in zip(ids, plens, nows)])
            bat = bc.try_admit_many(ids, plens, nows)
            _same_plans(rb.try_admit_many(ids, plens, nows) if rb else want, bat)
            now = float(nows[-1])
        elif op < 0.85 and bc.active:  # release a finished request
            rid = str(rng.choice(sorted(bc.active)))
            for ctl in filter(None, (ref, sc, bc, rb)):
                ctl.release(rid)
        else:  # online learning changes later predictions for all
            plen = int(rng.integers(100, 2000))
            s = _growth_series(plen, int(60 + plen * 0.05))
            for ctl in filter(None, (ref, sc, bc, rb)):
                ctl.observe(plen, s)
        now += float(rng.exponential(1.0))
    assert set(ref.active) == set(sc.active)
    assert set(bc.active) == set((rb or ref).active)
    assert ref._static_reserved == sc._static_reserved
    assert np.isclose(bc._static_reserved, (rb or ref)._static_reserved)


@pytest.mark.parametrize("seed", [0, 1, 2, 5])
@pytest.mark.parametrize("device_min_batch", [1, 4, 1_000_000])
def test_admission_stream_parity(seed, device_min_batch):
    # 1 sends every batch of two or more through the decision scan,
    # 1_000_000 every batch through the host path, 4 splits them
    _check_stream_parity(seed, device_min_batch)


@settings(deadline=None, max_examples=15, database=None)
@given(st.integers(0, 2**31 - 1))
def test_property_admission_stream_parity(seed):
    """On random seeds the port's batched controller is held to the
    reference's batched one: both depart from the scalar oracle on ~0.3% of
    seeds (ROADMAP Queue 3; ``test_batched_departs_from_scalar_as_the_
    reference_does``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
        _check_stream_parity(seed, device_min_batch=4, ref_batched=True)


def test_batched_departs_from_scalar_as_the_reference_does(x64):
    """The scalar probe misses a candidate's step-up when ``p - start``
    rounds back to the boundary (ROADMAP Queue 3, ``demand_exceeds``); the
    batched engines' shared probe set holds other candidates' switch
    instants and can see the same peak later in the window.  Seed
    1764386484, step 36: the scalar controllers admit candidate 6, both
    batched controllers reject it (candidate 7 switches inside its window
    at 131.47 s, where the total is 126 MiB over) and admit candidate 7."""
    with pytest.raises(AssertionError):
        _check_stream_parity(1764386484, device_min_batch=4)
    _check_stream_parity(1764386484, device_min_batch=4, ref_batched=True)


def test_empty_model_default_parity():
    """Before any observation every controller admits against the same flat
    5%-of-budget placeholder, so 20 fit."""
    ref = RefAdmissionController(1000.0, k=4, interval_s=1.0)
    sc = AdmissionController(1000.0, k=4, interval_s=1.0)
    bc = BatchedAdmissionController(1000.0, k=4, interval_s=1.0, device_min_batch=1, device="cpu")
    ids = [f"r{i}" for i in range(25)]
    want = [ref.try_admit(r, 100, 0.0) for r in ids]
    _same_plans(want, [sc.try_admit(r, 100, 0.0) for r in ids])
    _same_plans(want, bc.try_admit_many(ids, [100] * 25, 0.0))
    assert sum(_decided(want)) == 20


def test_within_batch_sequencing():
    """A batch whose members fit one by one but not together admits the
    candidates the sequential oracle admits, not all of them."""
    rng = np.random.default_rng(4)
    ref, sc, bc, _ = _trained(10_000.0, rng, device_min_batch=1)
    ids = [f"q{i}" for i in range(32)]
    plens = [1000] * 32
    want = [ref.try_admit(r, p, 0.0) for r, p in zip(ids, plens)]
    _same_plans(want, [sc.try_admit(r, p, 0.0) for r, p in zip(ids, plens)])
    bat = bc.try_admit_many(ids, plens, 0.0)
    _same_plans(want, bat)
    assert 0 < sum(_decided(bat)) < 32  # the budget binds inside the batch


def test_try_admit_many_empty():
    bc = BatchedAdmissionController(1000.0, device="cpu")
    assert bc.try_admit_many([], [], 0.0) == []


def test_batched_decisions_go_through_the_decision_scan(monkeypatch):
    """At or above ``device_min_batch`` a batch is one ``ops.admission_scan``
    call; below it, none.  On CPU tensors that call is the plain version,
    which launches nothing."""
    calls = []
    real = ops.admission_scan
    monkeypatch.setattr(ops, "admission_scan", lambda *a: calls.append(a[0].shape) or real(*a))
    rng = np.random.default_rng(3)
    _, _, bc, _ = _trained(50_000.0, rng, device_min_batch=4)
    before = ops.launch_counts()
    bc.try_admit_many([f"a{i}" for i in range(3)], [500, 900, 1500], 0.0)
    assert calls == []
    got = bc.try_admit_many([f"b{i}" for i in range(5)], [500, 900, 1500, 300, 1999], 1.0)
    assert len(calls) == 1 and all(p is not None for p in got)
    assert ops.launch_counts() == before


@pytest.mark.parametrize("arrival", ["poisson", "bursty"])
def test_run_stream_engine_parity(arrival):
    """End to end: the port's stream simulator gives the reference scalar
    run's decisions, counts, wastage and makespan on the port's scalar and
    batched engines."""
    kw = dict(n_requests=160, n_warmup=32, arrival=arrival, rate_per_s=30.0 if arrival == "bursty" else 6.0, seed=11)
    want = ref_run_stream(RefStreamConfig(**kw), "scalar")
    for engine in ("scalar", "batched"):
        got = run_stream(StreamConfig(**kw), engine, device="cpu")
        assert got.decisions == want.decisions
        assert (got.admitted, got.rejected, got.evicted, got.finished) == (
            want.admitted, want.rejected, want.evicted, want.finished)
        for key in ("segmentwise_gib_s", "peak_reservation_gib_s"):
            np.testing.assert_allclose(got.wastage[key], want.wastage[key], rtol=1e-9)
        assert got.makespan_s == want.makespan_s
    assert want.rejected > 0  # the budget binds, so parity is not trivial


def test_run_stream_eviction_parity():
    """Served series 3x what the model learned force the OOM backstop; the
    port's engines evict as the reference's scalar run does."""
    kw = dict(n_requests=120, n_warmup=24, rate_per_s=8.0, hbm_budget_mib=20_000.0, growth_mib_per_step=8.0, seed=2)
    warm, arrivals = ref_generate_arrivals(RefStreamConfig(**kw))
    for a in arrivals:
        a.series = a.series * 3.0
    want = ref_run_stream(RefStreamConfig(**kw), "scalar", arrivals=(warm, arrivals))
    p_warm, p_arrivals = generate_arrivals(StreamConfig(**kw))
    for a in p_arrivals:
        a.series = a.series * 3.0
    for engine in ("scalar", "batched"):
        got = run_stream(StreamConfig(**kw), engine, arrivals=(p_warm, p_arrivals), device="cpu")
        assert got.decisions == want.decisions
        assert got.evicted == want.evicted > 0
        assert (got.admitted, got.finished) == (want.admitted, want.finished)


def test_batched_matches_reference_batched_engine(x64):
    """The port's batched controller against the reference's, call by call,
    on both paths (1: every batch of two or more through the decision scan;
    4: split by size)."""
    for device_min_batch in (1, 4):
        rng = np.random.default_rng(7)
        ref = RefBatchedAdmissionController(12_000.0, k=4, interval_s=1.0, device_min_batch=device_min_batch)
        bc = BatchedAdmissionController(12_000.0, k=4, interval_s=1.0, device_min_batch=device_min_batch,
                                        device="cpu")
        for _ in range(40):
            plen = int(rng.integers(100, 2000))
            s = _growth_series(plen, int(60 + plen * 0.05 + rng.normal(0, 2)))
            ref.observe(plen, s)
            bc.observe(plen, s)
        now, n_dec = 0.0, 0
        for step in range(30):
            if rng.random() < 0.7:
                c = int(rng.integers(1, 12))
                ids = [f"s{step}c{j}" for j in range(c)]
                plens = [int(rng.integers(100, 2000)) for _ in range(c)]
                nows = now + np.sort(rng.uniform(0.0, 0.5, c))
                _same_plans(ref.try_admit_many(ids, plens, nows), bc.try_admit_many(ids, plens, nows))
                now, n_dec = float(nows[-1]), n_dec + c
            elif ref.active:
                rid = str(rng.choice(sorted(ref.active)))
                ref.release(rid)
                bc.release(rid)
            now += float(rng.exponential(1.0))
        assert set(ref.active) == set(bc.active) and n_dec > 50


def test_batched_stream_matches_reference_batched_stream(x64):
    """bench_serve's bursty stream at a reduced length, through both
    packages' batched engines: the same decision sequence."""
    kw = dict(n_requests=120, arrival="bursty", rate_per_s=40.0, burst_factor=8.0, hbm_budget_mib=150_000.0,
              n_shards=4, seed=0)
    want = ref_run_stream(RefStreamConfig(**kw), "batched")
    got = run_stream(StreamConfig(**kw), "batched", device="cpu")
    assert got.decisions == want.decisions
    assert (got.admitted, got.rejected, got.evicted, got.finished) == (
        want.admitted, want.rejected, want.evicted, want.finished)
    assert got.makespan_s == want.makespan_s


# ---------------------------------------------------------------------------
# the decision scan against the reference's admission_program
# ---------------------------------------------------------------------------


def _scan_inputs(seed: int, n_active: int, C: int, k: int, budget_frac: float):
    """Padded decision-scan arguments built as ``_admit_device`` builds them:
    ``n_active`` resident plans in a Timeline, C candidates arriving in
    [0, 2) s; the budget a fraction of the profile's peak plus one
    candidate's peak, so some candidates fit and some do not."""
    rng = np.random.default_rng(seed)
    tl = Timeline()
    for i in range(n_active):
        b = np.sort(rng.uniform(1.0, 80.0, k))
        v = np.maximum.accumulate(rng.uniform(50.0, 900.0, k))
        s = float(rng.uniform(-20.0, 2.0))
        tl.add(f"r{i}", b, v, s, float(np.nextafter(s + b[-1], np.inf)))
    bnd = np.sort(rng.uniform(1.0, 80.0, (C, k)), axis=1)
    val = np.maximum.accumulate(rng.uniform(50.0, 900.0, (C, k)), axis=1)
    if C > 2:
        bnd[1] = bnd[0]  # duplicate plans: their instants dedupe in P
        val[1] = val[0]
    starts = np.sort(rng.uniform(0.0, 2.0, C))
    ends = starts + bnd[:, -1]
    rels = np.nextafter(ends, np.inf)
    sw = np.nextafter(starts[:, None] + bnd, np.inf)
    live = np.isfinite(bnd) & (starts[:, None] + bnd < rels[:, None])
    valext = np.concatenate([val, val[:, -1:]], axis=1)
    times, _ = tl.arrays()
    P = shared_probe_set(times, starts, sw.ravel())
    Pp, Cp = bucket_size(len(P)), bucket_size(C)
    prof = tl.demand_at(P)
    budget = budget_frac * (float(prof.max(initial=0.0)) + float(val[:, -1].max()))
    valid = np.ones(C, dtype=bool)
    valid[C // 3] = False  # an invalid candidate inside the batch
    args = (
        pad_rows(P, Pp, np.inf),
        pad_rows(prof, Pp, 0.0),
        pad_rows(starts, Cp, np.inf),
        pad_rows(ends, Cp, -np.inf),
        pad_rows(rels, Cp, -np.inf),
        pad_rows(bnd, Cp, np.inf),
        pad_rows(val, Cp, 0.0),
        pad_rows(valext, Cp, 0.0),
        pad_rows(sw, Cp, np.inf),
        pad_rows(live, Cp, False),
        pad_rows(valid, Cp, False),
    )
    return args, budget


@pytest.mark.parametrize("seed,n_active,C,k,budget_frac,expect", [
    (0, 0, 3, 1, 0.5, "binds"), (1, 5, 9, 4, 1.5, "binds"), (2, 40, 32, 4, 1.2, "binds"), (3, 120, 64, 3, 1.1, "binds"),
    (4, 60, 16, 8, 3.0, "all"), (5, 200, 40, 4, 1.05, "binds"), (6, 200, 40, 4, 0.5, "none"),
])
def test_plain_scan_matches_reference_admission_program(seed, n_active, C, k, budget_frac, expect):
    args, budget = _scan_inputs(seed, n_active, C, k, budget_frac)
    with jax.enable_x64(True):
        want = np.asarray(ref_admission_program()(*(jnp.asarray(a) for a in args), budget))
    got = admission_scan_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), budget)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    # C - 1 candidates are valid: all fit, none does, or the budget binds
    assert {"all": want.sum() == C - 1, "none": want.sum() == 0, "binds": 0 < want.sum() < C - 1}[expect]
    before = ops.launch_counts()
    again = ops.admission_scan(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), budget)
    assert torch.equal(again, got) and ops.launch_counts() == before  # CPU tensors: the plain version


def test_plain_scan_admits_a_sum_exactly_at_the_budget():
    """The test is strict: a probe whose sum equals the budget fits."""
    P = torch.tensor([0.0, 1.0, np.inf], dtype=torch.float64)
    prof = torch.tensor([100.0, 100.0, 0.0], dtype=torch.float64)
    one = lambda x: torch.tensor([x], dtype=torch.float64)  # noqa: E731
    args = (P, prof, one(0.0), one(1.0), one(np.nextafter(1.0, np.inf)), one(2.0)[:, None], one(50.0)[:, None],
            torch.tensor([[50.0, 50.0]], dtype=torch.float64), one(np.nextafter(2.0, np.inf))[:, None],
            torch.tensor([[False]]), torch.tensor([True]))
    assert admission_scan_plain(*args, 150.0).tolist() == [True]
    assert admission_scan_plain(*args, np.nextafter(150.0, 0.0)).tolist() == [False]
