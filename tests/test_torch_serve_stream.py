"""The port's arrival-stream simulator against the reference's, on the CPU.

``generate_arrivals`` must give the reference's workloads bit for bit, and
``run_stream`` on the host engines (``"scalar"``, ``"sharded-scalar"``)
the reference's decisions, counts, makespan, wastage (rtol 1e-12: the same
float64 sums) and per-shard rows, on Poisson, bursty and diurnal streams
and under an eviction storm.  Latencies are wall-clock readings and are
only checked for their form.  The rest are twins of
``tests/test_serve_stream.py`` on the port's ``"batched"`` engine with
``device="cpu"``."""

import numpy as np
import pytest

from repro.serve.stream import StreamConfig as RefStreamConfig
from repro.serve.stream import generate_arrivals as ref_generate_arrivals
from repro.serve.stream import run_stream as ref_run_stream
from repro_torch.serve.admission import ShardedAdmissionController, shard_of
from repro_torch.serve.stream import StreamConfig, _actual_usage, generate_arrivals, make_controller, run_stream

# bench_serve's three streams (benchmarks/run.py: 400 requests, seed 0)
STREAMS = {
    "poisson": dict(n_requests=400, rate_per_s=8.0, seed=0),
    "bursty": dict(n_requests=400, arrival="bursty", rate_per_s=40.0, burst_factor=8.0, hbm_budget_mib=150_000.0,
                   seed=0),
    "diurnal": dict(n_requests=400, arrival="diurnal", rate_per_s=12.0, diurnal_amp=0.8, hbm_budget_mib=80_000.0,
                    seed=0),
}
SHARD_COUNTS = ("decisions", "admitted", "rejected", "evicted")


def _bursty_kw(**kw):
    base = dict(n_requests=120, n_warmup=24, rate_per_s=8.0, arrival="bursty", burst_factor=8.0,
                hbm_budget_mib=20_000.0, growth_mib_per_step=8.0, seed=2)
    base.update(kw)
    return base


def _bursty_cfg(**kw):
    return StreamConfig(**_bursty_kw(**kw))


def _scaled(pair, factor):
    warm, arrivals = pair
    for a in arrivals:
        a.series = a.series * factor
    return warm, arrivals


def _underpredicted(cfg):
    """Serve series 3x the learned footprint: forces the OOM backstop."""
    return _scaled(generate_arrivals(cfg), 3.0)


def _same_arrivals(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert (a.t, a.request_id, a.prompt_len) == (b.t, b.request_id, b.prompt_len)
        assert a.series.dtype == b.series.dtype
        np.testing.assert_array_equal(a.series, b.series)


def _same_result(got, want):
    assert got.engine == want.engine
    assert got.decisions == want.decisions
    assert (got.admitted, got.rejected, got.evicted, got.finished) == (
        want.admitted, want.rejected, want.evicted, want.finished)
    assert got.makespan_s == want.makespan_s
    for key in ("segmentwise_gib_s", "peak_reservation_gib_s"):
        np.testing.assert_allclose(got.wastage[key], want.wastage[key], rtol=1e-12)
    assert got.slo["target_s"] == want.slo["target_s"]
    assert (got.shards is None) == (want.shards is None)
    if want.shards is not None:
        assert [{k: r[k] for k in ("shard",) + SHARD_COUNTS} for r in got.shards] == [
            {k: r[k] for k in ("shard",) + SHARD_COUNTS} for r in want.shards]
        assert got.imbalance == want.imbalance  # ratios of the counts


@pytest.mark.parametrize("name", sorted(STREAMS))
@pytest.mark.parametrize("n_warmup", [0, 48])
def test_generate_arrivals_match_reference(name, n_warmup):
    kw = dict(STREAMS[name], n_warmup=n_warmup, seed=3)
    warm, arrivals = generate_arrivals(StreamConfig(**kw))
    ref_warm, ref_arrivals = ref_generate_arrivals(RefStreamConfig(**kw))
    _same_arrivals(warm, ref_warm)
    _same_arrivals(arrivals, ref_arrivals)


def test_stream_config_matches_reference_defaults():
    import dataclasses

    assert dataclasses.asdict(StreamConfig()) == dataclasses.asdict(RefStreamConfig())


@pytest.mark.parametrize("engine", ["scalar", "sharded-scalar"])
@pytest.mark.parametrize("name", sorted(STREAMS))
def test_run_stream_matches_reference(name, engine):
    got = run_stream(StreamConfig(**STREAMS[name]), engine)
    want = ref_run_stream(RefStreamConfig(**STREAMS[name]), engine)
    _same_result(got, want)
    assert want.rejected > 0  # the budget binds, so the comparison is not trivial


@pytest.mark.parametrize("engine", ["scalar", "sharded-scalar"])
def test_high_eviction_stream_matches_reference(engine):
    """Tiny budget, 5x underprediction: the same decisions and kills as the
    reference's run, shard by shard."""
    kw = _bursty_kw(hbm_budget_mib=12_000.0)
    got = run_stream(StreamConfig(**kw), engine, arrivals=_scaled(generate_arrivals(StreamConfig(**kw)), 5.0))
    want = ref_run_stream(RefStreamConfig(**kw), engine,
                          arrivals=_scaled(ref_generate_arrivals(RefStreamConfig(**kw)), 5.0))
    _same_result(got, want)
    assert want.evicted > 10


def test_sharded_scalar_reports_shard_rows():
    cfg = StreamConfig(**STREAMS["bursty"])
    res = run_stream(cfg, "sharded-scalar")
    assert len(res.shards) == cfg.n_shards
    assert sum(r["decisions"] for r in res.shards) == len(res.decisions)
    placed = np.bincount([shard_of(rid, cfg.n_shards) for rid, _ in res.decisions], minlength=cfg.n_shards)
    assert [r["decisions"] for r in res.shards] == placed.tolist()
    for r in res.shards:
        assert r["admitted"] + r["rejected"] == r["decisions"]
        assert np.isfinite(r["p50_latency_s"]) and 0.0 <= r["slo_violation_frac"] <= 1.0
    assert res.imbalance["decisions_max_over_mean"] >= 1.0


def test_sharded_engine_raises_naming_the_roadmap_item():
    """``"sharded"`` builds the port's carried controller, and
    ``run_stream`` runs it as it runs the per-shard oracle."""
    ctl = make_controller(StreamConfig(), "sharded", device="cpu")
    assert isinstance(ctl, ShardedAdmissionController) and ctl.n_shards == StreamConfig().n_shards
    cfg = StreamConfig(n_requests=24, n_warmup=8)
    got = run_stream(cfg, "sharded", device="cpu")
    want = run_stream(cfg, "sharded-scalar")
    assert got.decisions == want.decisions and len(got.decisions) == 24
    assert len(got.shards) == cfg.n_shards


# ---------------------------------------------------------------------------
# twins of tests/test_serve_stream.py on the batched engine
# ---------------------------------------------------------------------------


def test_bursty_stream_ends_with_empty_bookkeeping():
    """Long bursty stream with evictions: live/info/plans/evicted_ids all
    drain to empty."""
    cfg = _bursty_cfg()
    state: dict = {}
    res = run_stream(cfg, "batched", arrivals=_underpredicted(cfg), debug_state=state, device="cpu")
    assert res.evicted > 0
    assert res.finished > 0
    assert state["live"] == {}
    assert state["info"] == {}
    assert state["plans"] == {}
    assert state["evicted_ids"] == set()


def test_clean_stream_ends_with_empty_bookkeeping():
    cfg = _bursty_cfg(hbm_budget_mib=200_000.0)
    state: dict = {}
    res = run_stream(cfg, "scalar", debug_state=state)
    assert res.evicted == 0 and res.finished > 0
    assert state["live"] == {} and state["info"] == {} and state["plans"] == {}
    assert state["evicted_ids"] == set()


def test_stale_finish_advances_makespan_and_rechecks_eviction():
    """Makespan covers every popped event time, evicted or not."""
    cfg = _bursty_cfg()
    pair = _underpredicted(cfg)
    res = run_stream(cfg, "batched", arrivals=pair, device="cpu")
    warm, arrivals = pair
    admitted = {rid for rid, ok in res.decisions if ok}
    latest = max(a.t + len(a.series) * cfg.interval_s for a in arrivals if a.request_id in admitted)
    assert res.makespan_s >= latest - 1e-9


def test_serving_stream_independent_of_warmup_count():
    """Changing n_warmup resizes the warmup set only."""
    streams = {}
    for nw in (0, 16, 48):
        warm, arrivals = generate_arrivals(StreamConfig(n_warmup=nw, seed=5))
        assert len(warm) == nw
        streams[nw] = arrivals
    ref = streams[48]
    for nw in (0, 16):
        got = streams[nw]
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            assert a.t == b.t and a.prompt_len == b.prompt_len
            np.testing.assert_array_equal(a.series, b.series)


def test_warmup_deterministic_prefix():
    small, _ = generate_arrivals(StreamConfig(n_warmup=8, seed=5))
    large, _ = generate_arrivals(StreamConfig(n_warmup=24, seed=5))
    for a, b in zip(small, large[:8]):
        assert a.prompt_len == b.prompt_len
        np.testing.assert_array_equal(a.series, b.series)


def _brute_force_kills(live, t, interval_s, budget):
    """Recompute the O(live) total on every kill (O(live^2))."""
    live = dict(live)
    kills = []
    while live and _actual_usage(live, t, interval_s) > budget:
        rid = max(live, key=lambda r: (live[r][0], r))
        live.pop(rid)
        kills.append(rid)
    return kills


def _vectorized_kills(live, t, interval_s, budget):
    """The backstop's algorithm: gather usage once, re-total per pop."""
    usage = {
        rid: float(series[min(max(int((t - start) / interval_s), 0), len(series) - 1)])
        for rid, (start, series) in live.items()
    }
    total = float(np.asarray(list(usage.values())).sum())
    kills = []
    for rid in sorted(live, key=lambda r: (live[r][0], r), reverse=True):
        if total <= budget:
            break
        total -= usage[rid]
        kills.append(rid)
    return kills


def test_evictor_matches_brute_force():
    """Over random live sets the single-pass evictor kills exactly what the
    quadratic backstop on the port's ``_actual_usage`` kills, in order."""
    rng = np.random.default_rng(9)
    for trial in range(40):
        n = int(rng.integers(1, 30))
        live = {
            f"r{i}": (
                float(rng.uniform(0.0, 50.0)),
                (rng.uniform(100.0, 4000.0) + 8.0 * np.arange(int(rng.integers(4, 120)))).astype(np.float32),
            )
            for i in range(n)
        }
        t = float(rng.uniform(0.0, 80.0))
        total = _actual_usage(live, t, 1.0)
        for budget in (total * 1.1, total * 0.6, total * 0.2, 0.0):
            assert _brute_force_kills(live, t, 1.0, budget) == _vectorized_kills(live, t, 1.0, budget), (
                trial, budget)


def test_high_eviction_stream_decision_parity():
    """Under an eviction storm the batched engine agrees with the scalar one
    decision for decision and kill for kill."""
    cfg = _bursty_cfg(hbm_budget_mib=12_000.0)
    pair = _scaled(generate_arrivals(cfg), 5.0)
    rs = run_stream(cfg, "scalar", arrivals=pair)
    rb = run_stream(cfg, "batched", arrivals=pair, device="cpu")
    assert rs.decisions == rb.decisions
    assert rs.evicted == rb.evicted
    assert rs.evicted > 10
    assert rs.finished == rb.finished


def test_empty_stream_reports_nan_latency():
    res = run_stream(StreamConfig(n_requests=0, n_warmup=4), "batched", device="cpu")
    assert np.isnan(res.p50_latency_s) and np.isnan(res.p99_latency_s)
    assert res.decisions_per_s == 0.0
    assert np.isnan(res.slo["violation_frac"]) and res.slo["violations"] == 0


def test_nonempty_stream_reports_finite_latency_and_slo():
    res = run_stream(StreamConfig(n_requests=40, n_warmup=8), "batched", device="cpu")
    assert np.isfinite(res.p50_latency_s) and np.isfinite(res.p99_latency_s)
    assert res.decisions_per_s > 0
    assert 0.0 <= res.slo["violation_frac"] <= 1.0
    assert res.shards is None  # single-host engines report no shard rows


def test_diurnal_arrivals_deterministic_and_modulated():
    cfg = StreamConfig(arrival="diurnal", n_requests=600, rate_per_s=4.0, diurnal_amp=0.9, seed=3)
    _, a1 = generate_arrivals(cfg)
    _, a2 = generate_arrivals(cfg)
    assert [x.t for x in a1] == [x.t for x in a2]
    ts = np.asarray([x.t for x in a1])
    gaps = np.diff(ts)
    phase = (ts[:-1] % cfg.diurnal_period_s) / cfg.diurnal_period_s
    peak = gaps[(phase > 0.15) & (phase < 0.35)]
    trough = gaps[(phase > 0.65) & (phase < 0.85)]
    assert peak.mean() < 0.5 * trough.mean()


def test_diurnal_amp_validated():
    with pytest.raises(ValueError):
        generate_arrivals(StreamConfig(arrival="diurnal", diurnal_amp=1.0, n_requests=1))
    with pytest.raises(ValueError, match="unknown arrival process"):
        generate_arrivals(StreamConfig(arrival="weekly", n_requests=1))
