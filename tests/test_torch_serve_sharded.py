"""The port's carried-timeline sharded admission controller against the
reference's, and against the port's per-shard scalar oracle, on the CPU.

``admission_epoch_plain`` (the plain version of the admission_epoch
kernel) is held against the reference's ``admission_epoch`` on random
carried states: admits, overflow, live counts and every field of the new
state bit for bit.  The port's ``ShardedAdmissionController``
(``device="cpu"``) is driven call for call beside the reference's, with the
carried state compared after every batch, through the interleavings of
the reference's own suite (``tests/test_serve_sharded.py``), and beside the
port's ``ShardedScalarController``.  The reference's carried programs run in
float64 through ``jax.experimental.enable_x64``, which jax 0.9 no longer
has; the ``x64`` fixture puts ``jax.enable_x64`` in its place for one test.
"""

import jax
import jax.experimental
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import repro.sim.device_timeline as ref_dt
from repro.serve.admission import AdmissionController as RefAdmissionController
from repro.serve.admission import ShardedAdmissionController as RefShardedAdmissionController
from repro.serve.admission import ShardedScalarController as RefShardedScalarController
from repro.serve.stream import StreamConfig as RefStreamConfig
from repro.serve.stream import generate_arrivals as ref_generate_arrivals
from repro.serve.stream import run_stream as ref_run_stream
from repro_torch.kernels import ops
from repro_torch.serve import ShardedAdmissionController, make_admission_controller
from repro_torch.serve.admission import AdmissionController, ShardedScalarController, shard_of
from repro_torch.serve.stream import StreamConfig, generate_arrivals, run_stream
from repro_torch.sim.device_timeline import admission_epoch_plain
from test_torch_cuda import EPOCH_CASES, random_epoch

OUTPUTS = ("admits", "overflow", "n_live", "base0", "tl_t", "tl_d", "tl_c", "slot_fold")


@pytest.fixture
def x64(monkeypatch):
    """The reference's float64 programs enter ``jax.experimental.enable_x64``."""
    monkeypatch.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)


def _bits_equal(name, got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, name
    if want.dtype == np.float64:
        np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64), err_msg=name)
    else:
        np.testing.assert_array_equal(got, want.astype(got.dtype), err_msg=name)


# ---------------------------------------------------------------------------
# the plain epoch against the reference's admission_epoch on random states
# ---------------------------------------------------------------------------


def _ref_epoch(args, t0, budget, Lp):
    with jax.enable_x64(True):
        out = ref_dt.admission_epoch(1, Lp)(*(jnp.asarray(a) for a in args), np.float64(t0), np.float64(budget))
        return [np.asarray(o) for o in out]




@pytest.mark.parametrize("case", EPOCH_CASES, ids=[f"seed{c[0]}-S{c[1]}-L{c[2]}-{c[7]}" for c in EPOCH_CASES])
def test_plain_epoch_matches_reference(case, x64):
    seed, S, L, k, Cb, Rb, n_plans, mode, frac = case
    args, t0, budget, Lp = random_epoch(seed, S, L, k, Cb, Rb, n_plans, mode, frac)
    want = _ref_epoch(args, t0, budget, Lp)
    got = admission_epoch_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), t0, budget, Lp)
    for name, g, w in zip(OUTPUTS, got, want):
        _bits_equal(name, g.numpy(), w)
    admits, overflow, n_valid = want[0], want[1], int(np.asarray(args[12]).sum())
    assert overflow.any() == (mode == "short" or seed == 7)
    if not overflow.any() and frac <= 1.0 and n_valid > 2:
        assert 0 < admits.sum() < n_valid  # the budget binds
    before = ops.launch_counts()
    res, *state = ops.admission_epoch(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), t0, budget, Lp)
    assert ops.launch_counts() == before  # CPU tensors: the plain version
    Cb = admits.shape[1]
    _bits_equal("admits", res[:, :Cb].numpy().astype(bool), admits)
    _bits_equal("overflow", res[:, Cb].numpy().astype(bool), overflow)
    _bits_equal("n_live", res[:, Cb + 1].numpy(), want[2])
    for name, g, w in zip(OUTPUTS[3:], state, want[3:]):
        _bits_equal(name, g.numpy(), w)


def test_plain_epoch_folds_the_whole_row_as_the_reference(x64):
    """A clock past every carried event folds the whole row."""
    args, t0, budget, Lp = random_epoch(30, 4, 320, 4, 16, 8, 40, "none", 0.5, t0=400.0)
    want = _ref_epoch(args, t0, budget, None)
    got = admission_epoch_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a in args), t0, budget, None)
    for name, g, w in zip(OUTPUTS, got, want):
        _bits_equal(name, g.numpy(), w)
    assert 0 < want[0].sum() < np.asarray(args[12]).sum()
    assert (want[2] <= 6 * want[0].sum(axis=1)).all()  # only the admitted plans' events are left


def test_row_sum_follows_the_reference_order(x64):
    """The released codes' folded sums leave base0 in the order of XLA's
    compiled ``jnp.sum``: in index order up to 16 terms, vectorised at 32,
    windows of 32 past it.  A sequential sum departs at 32 and past it."""
    from repro_torch.sim.device_timeline import _fold_sum, _row_sum

    rng = np.random.default_rng(11)
    with jax.enable_x64(True):
        ref = jax.jit(jax.vmap(lambda sf, rc: jnp.sum(jnp.where(rc >= 0, sf[jnp.clip(rc, 0)], 0.0))))
        for Rb in (8, 16, 32, 64, 128):
            sf = rng.uniform(-50.0, 400.0, (64, 900)) * rng.uniform(0.5, 3.0, (64, 900))
            rc = np.stack([rng.choice(900, Rb, replace=False) for _ in range(64)]).astype(np.int32)
            for r in range(64):
                rc[r, rng.integers(1, Rb + 1):] = -1
            want = np.asarray(ref(sf, rc))
            x = [torch.from_numpy(np.where(rc[r] >= 0, sf[r][np.clip(rc[r], 0, None)], 0.0)) for r in range(64)]
            _bits_equal(f"Rb {Rb}", np.asarray([float(_row_sum(v)) for v in x]), want)
            seq = np.asarray([float(_fold_sum(v)) for v in x])
            assert np.array_equal(seq, want) == (Rb <= 16)


# ---------------------------------------------------------------------------
# the controller against the reference's controller and the port's oracle
# ---------------------------------------------------------------------------


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


def _same_state(port, ref):
    """The carried state and the host bookkeeping, bit for bit."""
    for name, g, w in zip(OUTPUTS[3:], port._state, ref._state):
        _bits_equal(name, g.numpy(), np.asarray(w))
    assert (port._L, port._Smax, port.reseeds) == (ref._L, ref._Smax, ref.reseeds)
    np.testing.assert_array_equal(port._n_live, ref._n_live)
    assert port._free == ref._free and port._pending_rel == ref._pending_rel and port._code == ref._code
    assert port._clock == ref._clock


def _trained(budget, rng, n_shards, n_obs=40, ref=True):
    """(the port's carried controller, the port's per-shard oracle, and the
    reference's carried controller or None), trained alike."""
    ctls = (
        ShardedAdmissionController(budget, k=4, interval_s=1.0, n_shards=n_shards, device="cpu"),
        ShardedScalarController(budget, k=4, interval_s=1.0, n_shards=n_shards),
        RefShardedAdmissionController(budget, k=4, interval_s=1.0, n_shards=n_shards) if ref else None,
    )
    for _ in range(n_obs):
        plen = int(rng.integers(100, 2000))
        s = _growth_series(plen, int(60 + plen * 0.05))
        for c in filter(None, ctls):
            c.observe(plen, s)
    return ctls


def _check_parity(seed: int, n_shards: int, steps: int = 50, ref: bool = True, oracle: bool = True) -> int:
    """``_check_sharded_parity``'s interleavings (tests/test_serve_sharded.py):
    random admit/release/observe steps.  The port's carried controller is
    held call for call to the reference's carried one (and its state after
    every batch) and to the port's per-shard oracle.  Returns the number of
    decisions."""
    rng = np.random.default_rng(seed)
    dev, orc, rdev = _trained(12_000.0, rng, n_shards, ref=ref)
    now, n_dec = 0.0, 0
    for step in range(steps):
        op = rng.random()
        if op < 0.6:
            c = int(rng.integers(1, 9))
            ids = [f"s{step}c{j}" for j in range(c)]
            plens = [int(rng.integers(100, 2000)) for _ in range(c)]
            nows = now + np.sort(rng.uniform(0.0, 0.5, c))
            got = dev.try_admit_many(ids, plens, nows)
            if rdev is not None:
                _same_plans(rdev.try_admit_many(ids, plens, nows), got)
                _same_state(dev, rdev)
            want = orc.try_admit_many(ids, plens, nows)
            if oracle:
                _same_plans(want, got)
            now, n_dec = float(nows[-1]), n_dec + c
        elif op < 0.85 and dev.active:
            rid = str(rng.choice(sorted(dev.active)))
            for ctl in filter(None, (dev, orc, rdev)):
                ctl.release(rid)
        else:
            plen = int(rng.integers(100, 2000))
            s = _growth_series(plen, int(60 + plen * 0.05))
            for ctl in filter(None, (dev, orc, rdev)):
                ctl.observe(plen, s)
        now += float(rng.exponential(1.0))
    if oracle:
        assert set(orc.active) == set(dev.active)
        assert np.isclose(orc._static_reserved, dev._static_reserved)
    assert dev.reseeds == 0  # growth pre-empts every in-program overflow
    return n_dec


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_sharded_matches_reference_and_oracle(seed, n_shards, x64):
    assert _check_parity(seed, n_shards) > 50


@settings(deadline=None, max_examples=6, database=None)
@given(st.integers(0, 2**31 - 1), st.sampled_from([1, 2, 4]))
def test_property_sharded_matches_reference(seed, n_shards):
    """On random seeds the port's carried controller is held to the
    reference's carried one, decisions and state: both depart from the
    per-shard scalar oracle on ~1.3% of seeds (ROADMAP Queue 3;
    ``test_carried_departs_from_scalar_as_the_reference_does``)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.experimental, "enable_x64", jax.enable_x64, raising=False)
        _check_parity(seed, n_shards, steps=35, oracle=False)


def test_carried_departs_from_scalar_as_the_reference_does(x64):
    """The scalar probe misses a candidate's own step-up when ``p - start``
    rounds back to the boundary (ROADMAP Queue 3, ``demand_exceeds``); the
    carried engines probe every candidate's switch instants against the
    carried profile and see it.  Seed 528 at 2 shards, step 7: the
    per-shard scalar oracle admits candidate 1, whose shard's demand then
    reaches 6,054.23 MiB just past its third boundary (116.80 s) against
    the shard's 6,000 MiB; both carried controllers reject it and admit
    candidate 2."""
    with pytest.raises(AssertionError):
        _check_parity(528, 2)
    _check_parity(528, 2, oracle=False)


def test_single_shard_matches_plain_scalar(x64):
    """One shard holds the whole budget: the carried engine decides as the
    scalar controllers of both packages do (the reference suite's anchor)."""
    rng = np.random.default_rng(7)
    plain, ref_plain = AdmissionController(12_000.0, k=4, interval_s=1.0), RefAdmissionController(12_000.0, k=4,
                                                                                               interval_s=1.0)
    dev, _, rdev = _trained(12_000.0, np.random.default_rng(7), n_shards=1)
    for _ in range(40):
        plen = int(rng.integers(100, 2000))
        s = _growth_series(plen, int(60 + plen * 0.05))
        plain.observe(plen, s)
        ref_plain.observe(plen, s)
    now, n_dec = 0.0, 0
    for step in range(40):
        op = rng.random()
        if op < 0.6:
            c = int(rng.integers(1, 6))
            ids = [f"p{step}c{j}" for j in range(c)]
            plens = [int(rng.integers(100, 2000)) for _ in range(c)]
            nows = now + np.sort(rng.uniform(0.0, 0.5, c))
            want = [ref_plain.try_admit(r, p, float(t)) for r, p, t in zip(ids, plens, nows)]
            _same_plans(want, [plain.try_admit(r, p, float(t)) for r, p, t in zip(ids, plens, nows)])
            got = dev.try_admit_many(ids, plens, nows)
            _same_plans(want, got)
            _same_plans(rdev.try_admit_many(ids, plens, nows), got)
            _same_state(dev, rdev)
            now, n_dec = float(nows[-1]), n_dec + c
        elif op < 0.85 and plain.active:
            rid = str(rng.choice(sorted(plain.active)))
            for ctl in (plain, ref_plain, dev, rdev):
                ctl.release(rid)
        now += float(rng.exponential(1.0))
    assert n_dec > 40 and 0 < len(dev.active)


def test_placement_deterministic_and_balanced():
    """crc32 placement is a pure function of the id, the reference's, and
    spreads a realistic id population across shards."""
    from repro.serve.admission import shard_of as ref_shard_of

    ids = [f"r{i}" for i in range(4000)]
    a = [shard_of(r, 4) for r in ids]
    assert a == [ref_shard_of(r, 4) for r in ids]
    dev = ShardedAdmissionController(1000.0, n_shards=4, device="cpu")
    assert [dev.shard_of(r) for r in ids] == a
    counts = np.bincount(a, minlength=4)
    assert counts.min() > 0.7 * counts.mean()


def test_clock_regression_raises():
    dev = ShardedAdmissionController(1000.0, n_shards=2, device="cpu")
    dev.try_admit_many(["a"], [100], 5.0)
    with pytest.raises(ValueError, match="clock regressed"):
        dev.try_admit_many(["b"], [100], 4.0)
    assert dev.try_admit_many([], [], 6.0) == []


def test_capacity_growth_without_reseed(x64):
    """Many concurrent plans push the timeline axis L and the owner-code
    axis Smax past their seeds on both packages alike: growth is padding,
    the state stays the reference's bit for bit and nothing reseeds."""
    rng = np.random.default_rng(3)
    dev, orc, rdev = _trained(10_000_000.0, rng, n_shards=1)
    L0, S0 = dev._L, dev._Smax
    for step in range(10):
        ids = [f"g{step}c{j}" for j in range(8)]
        plens = [int(rng.integers(100, 2000)) for _ in range(8)]
        got = dev.try_admit_many(ids, plens, float(step))
        _same_plans(rdev.try_admit_many(ids, plens, float(step)), got)
        _same_plans(orc.try_admit_many(ids, plens, float(step)), got)
        assert _decided(got) == [True] * 8, step  # the budget is huge: everything fits
        _same_state(dev, rdev)
    assert len(dev.active) == 80
    assert dev._L > L0 and dev._Smax > S0
    assert dev.reseeds == 0


def test_forced_reseed_replays_as_the_reference_does(x64):
    """The overflow guard: a live count understated on both packages alike
    leaves the decision prefix and the axis short, the epoch flags the
    overflow, and the state is rebuilt from the active plans at the clock
    and the batch replayed over the full axis.  Decisions stay the
    oracle's, and the rebuilt state is the reference's bit for bit."""
    rng = np.random.default_rng(5)
    dev, orc, rdev = _trained(10_000_000.0, rng, n_shards=2)
    released = 0
    for step in range(12):
        if step == 9:
            for ctl in (dev, rdev):
                ctl._n_live[:] = 0
        ids = [f"f{step}c{j}" for j in range(10)]
        plens = [int(rng.integers(100, 2000)) for _ in range(10)]
        got = dev.try_admit_many(ids, plens, 0.5 * step)
        _same_plans(rdev.try_admit_many(ids, plens, 0.5 * step), got)
        _same_plans(orc.try_admit_many(ids, plens, 0.5 * step), got)
        _same_state(dev, rdev)
        for rid in sorted(dev.active)[:3]:  # releases queued across the reseed
            for ctl in (dev, orc, rdev):
                ctl.release(rid)
            released += 1
    assert dev.reseeds == rdev.reseeds == 1
    assert set(dev.active) == set(orc.active) and released == 36


def test_try_admit_many_empty_and_one():
    dev = ShardedAdmissionController(1000.0, n_shards=2, device="cpu")
    assert dev.try_admit_many([], [], 0.0) == []
    plan = dev.try_admit("a", 100, 0.0)
    assert plan is not None and plan.request_id == "a" and "a" in dev.active


def test_one_epoch_call_per_batch(monkeypatch):
    """Every non-empty batch is one ``ops.admission_epoch`` call; on CPU
    tensors that call is the plain version, which launches nothing."""
    calls = []
    real = ops.admission_epoch
    monkeypatch.setattr(ops, "admission_epoch", lambda *a, **kw: calls.append(a[1].shape) or real(*a, **kw))
    rng = np.random.default_rng(3)
    dev, _, _ = _trained(50_000.0, rng, n_shards=4, ref=False)
    before = ops.launch_counts()
    for step in range(5):
        dev.try_admit_many([f"b{step}c{j}" for j in range(7)], [500, 900, 1500, 300, 1999, 800, 700], float(step))
        dev.release(f"b{step}c0")
    dev.try_admit_many([], [], 9.0)
    assert len(calls) == 5 and all(shape[0] == 4 for shape in calls)
    assert ops.launch_counts() == before


def test_needs_a_card_unless_asked_for_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ShardedAdmissionController(1000.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_admission_controller("sharded", hbm_budget_mib=1000.0)
    ctl = make_admission_controller("sharded", hbm_budget_mib=1000.0, n_shards=2, device="cpu")
    assert isinstance(ctl, ShardedAdmissionController) and ctl.shard_budget == 500.0


# ---------------------------------------------------------------------------
# end to end through the stream simulator
# ---------------------------------------------------------------------------

# benchmarks/run.py:bench_serve's three streams (400 requests, seed 0, k 4, 4 shards)
BENCH_STREAMS = {
    "poisson": dict(rate_per_s=8.0),
    "bursty": dict(arrival="bursty", rate_per_s=40.0, burst_factor=8.0, hbm_budget_mib=150_000.0),
    "diurnal": dict(arrival="diurnal", rate_per_s=12.0, diurnal_amp=0.8, hbm_budget_mib=80_000.0),
}


def _same_run(got, want, wastage_rtol=1e-9):
    assert got.decisions == want.decisions
    assert (got.admitted, got.rejected, got.evicted, got.finished) == (
        want.admitted, want.rejected, want.evicted, want.finished)
    np.testing.assert_allclose(got.wastage["segmentwise_gib_s"], want.wastage["segmentwise_gib_s"],
                               rtol=wastage_rtol)
    assert got.makespan_s == want.makespan_s
    assert [r["decisions"] for r in got.shards] == [r["decisions"] for r in want.shards]


@pytest.mark.parametrize("arrival", list(BENCH_STREAMS))
def test_bench_serve_streams_match(arrival, x64):
    """bench_serve's uncut streams: the port's carried engine gives the
    reference's carried run and the port's per-shard oracle's run."""
    kw = dict(n_requests=400, seed=0, **BENCH_STREAMS[arrival])
    got = run_stream(StreamConfig(**kw), "sharded", device="cpu")
    _same_run(got, ref_run_stream(RefStreamConfig(**kw), "sharded"))
    _same_run(got, run_stream(StreamConfig(**kw), "sharded-scalar"))
    assert got.rejected > 0 and len(got.shards) == 4


@pytest.mark.parametrize("arrival", ["poisson", "bursty", "diurnal"])
def test_run_stream_sharded_engine_parity(arrival, x64):
    """The reference suite's stream parity (160 requests, seed 11): the same
    decisions, counts, wastage, makespan and per-shard rows."""
    kw = dict(n_requests=160, n_warmup=32, arrival=arrival, rate_per_s=30.0 if arrival == "bursty" else 6.0,
              n_shards=4, seed=11)
    got = run_stream(StreamConfig(**kw), "sharded", device="cpu")
    _same_run(got, run_stream(StreamConfig(**kw), "sharded-scalar"))
    _same_run(got, ref_run_stream(RefStreamConfig(**kw), "sharded"))
    assert got.rejected > 0
    assert got.imbalance["decisions_max_over_mean"] >= 1.0


def test_run_stream_sharded_eviction_parity(x64):
    """Series 3x what the model learned force the OOM backstop: evictions
    (releases driven by the host backstop) agree with the oracle's and the
    reference's carried run."""
    kw = dict(n_requests=120, n_warmup=24, rate_per_s=8.0, hbm_budget_mib=20_000.0, n_shards=2, seed=2)
    warm, arrivals = generate_arrivals(StreamConfig(**kw))
    for a in arrivals:
        a.series = a.series * 3.0
    r_warm, r_arrivals = ref_generate_arrivals(RefStreamConfig(**kw))
    for a in r_arrivals:
        a.series = a.series * 3.0
    got = run_stream(StreamConfig(**kw), "sharded", arrivals=(warm, arrivals), device="cpu")
    want = run_stream(StreamConfig(**kw), "sharded-scalar", arrivals=(warm, arrivals))
    _same_run(got, want)
    _same_run(got, ref_run_stream(RefStreamConfig(**kw), "sharded", arrivals=(r_warm, r_arrivals)))
    assert got.evicted > 0
    assert [r["evicted"] for r in got.shards] == [r["evicted"] for r in want.shards]
