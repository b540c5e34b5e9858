"""Arrival-stream serving simulator: admission control under live traffic.

Port of ``repro.serve.stream``.  Replays a synthetic decode-request workload
(Poisson, bursty or diurnal arrivals, prompt-length-correlated HBM
footprints) through an admission controller (the scalar
``AdmissionController`` oracle, the batched ``BatchedAdmissionController``,
or the per-shard ``ShardedScalarController``), with online learning from
finished requests, and measures:

* admitted / rejected / evicted / finished counts,
* reservation wastage in GiB*s (segment-wise vs peak-at-admission, the
  paper's Fig. 7a metric applied to serving),
* admission-decision latency (p50/p99) and decisions/second,
* for sharded engines: per-shard decision/latency rows, admission-latency
  SLO accounting against ``slo_admit_latency_s``, and shard-imbalance
  ratios (max-over-mean decisions/admissions across shards).

The event loop does not depend on the engine and is deterministic:
arrivals are grouped into admission batches only between finish events (a
request finishing mid-stream frees budget, so batching across it would
change decisions), and every engine sees the same batch boundaries, so
their decision sequences can be compared one for one.  Eviction models the
OOM backstop: when *actual* usage (the replayed series, not the
reservation) exceeds the budget, the youngest requests are killed until it
fits again.

``make_controller`` and ``run_stream`` take the port's ``device`` (the
batched engine's; ``None`` is the CUDA card).
"""

from __future__ import annotations

import dataclasses
import heapq
import time

import numpy as np

from repro_torch.serve.engine import make_admission_controller


@dataclasses.dataclass
class StreamConfig:
    """One serving workload: budget, model, and arrival process."""

    hbm_budget_mib: float = 50_000.0
    k: int = 4
    interval_s: float = 1.0  # decode-step monitoring interval (seconds)
    n_requests: int = 400  # scheduled arrivals (after warmup)
    n_warmup: int = 48  # finished requests observed before serving starts
    rate_per_s: float = 4.0  # mean arrival rate
    arrival: str = "poisson"  # "poisson" | "bursty" | "diurnal"
    burst_factor: float = 8.0  # bursty: on-phase rate multiplier
    burst_period_s: float = 40.0  # bursty: on/off cycle length (half each)
    diurnal_period_s: float = 60.0  # diurnal: one day-night cycle (seconds)
    diurnal_amp: float = 0.8  # diurnal: rate swing fraction, in [0, 1)
    prompt_len_lo: int = 100
    prompt_len_hi: int = 2000
    decode_base: float = 60.0  # decode steps ~ base + per_prompt * prompt_len
    decode_per_prompt: float = 0.05
    prefill_mib_per_tok: float = 0.08  # footprint: prefill jump per prompt token
    growth_mib_per_step: float = 8.0  # KV growth per decode step
    batch_window_s: float = 0.25  # arrivals this close admit as one batch
    n_shards: int = 4  # sharded engines: shard count for the active set
    slo_admit_latency_s: float = 0.002  # per-decision admission-latency SLO
    seed: int = 0


@dataclasses.dataclass
class Arrival:
    t: float
    request_id: str
    prompt_len: int
    series: np.ndarray  # actual HBM MiB per decode step (ground truth replay)


@dataclasses.dataclass
class StreamResult:
    engine: str
    admitted: int
    rejected: int
    evicted: int
    finished: int
    decisions: list[tuple[str, bool]]  # (request_id, admitted) in decision order
    wastage: dict  # segmentwise_gib_s / peak_reservation_gib_s over finished requests
    makespan_s: float
    wall_s: float  # wall time spent inside admission decisions
    decisions_per_s: float
    p50_latency_s: float  # nan when the stream produced no decisions
    p99_latency_s: float
    slo: dict | None = None  # admission-latency SLO accounting (all engines)
    shards: list[dict] | None = None  # per-shard rows (sharded engines only)
    imbalance: dict | None = None  # max-over-mean ratios across shards


def _series(cfg: StreamConfig, prompt_len: int, rng: np.random.Generator) -> np.ndarray:
    """Growth-dominated footprint: prefill jump then linear KV accumulation —
    the regime where segment-wise reservations have headroom over peak."""
    steps = max(int(cfg.decode_base + prompt_len * cfg.decode_per_prompt + rng.normal(0, 2)), 4)
    return (prompt_len * cfg.prefill_mib_per_tok + cfg.growth_mib_per_step * np.arange(steps)).astype(
        np.float32
    )


def generate_arrivals(cfg: StreamConfig) -> tuple[list[Arrival], list[Arrival]]:
    """(warmup requests, serving arrivals), deterministic in the seed.

    Poisson: exponential inter-arrival gaps at ``rate_per_s``.  Bursty: an
    on/off modulated Poisson process — ``burst_factor`` x the base rate for
    the first half of every ``burst_period_s`` cycle, the base rate for the
    second — which stresses admission exactly when the budget is tightest.
    Diurnal: a sinusoidally modulated rate,
    ``rate_per_s * (1 + diurnal_amp * sin(2*pi*t / diurnal_period_s))`` —
    the day/night traffic shape that exercises sharded engines through both
    sustained pressure and long troughs where carried timelines drain.

    Warmup and serving draw from independent seeded child generators, so the
    serving stream is a function of the seed alone: changing ``n_warmup``
    resizes the warmup set without perturbing a single serving arrival."""
    rng_warm = np.random.default_rng([cfg.seed, 0])
    rng = np.random.default_rng([cfg.seed, 1])
    warm = []
    for i in range(cfg.n_warmup):
        plen = int(rng_warm.integers(cfg.prompt_len_lo, cfg.prompt_len_hi))
        warm.append(Arrival(0.0, f"warm{i}", plen, _series(cfg, plen, rng_warm)))
    arrivals = []
    t = 0.0
    for i in range(cfg.n_requests):
        if cfg.arrival == "poisson":
            rate = cfg.rate_per_s
        elif cfg.arrival == "bursty":
            phase = (t % cfg.burst_period_s) / cfg.burst_period_s
            rate = cfg.rate_per_s * (cfg.burst_factor if phase < 0.5 else 1.0)
        elif cfg.arrival == "diurnal":
            if not 0.0 <= cfg.diurnal_amp < 1.0:
                raise ValueError(f"diurnal_amp must be in [0, 1), got {cfg.diurnal_amp}")
            phase = (t % cfg.diurnal_period_s) / cfg.diurnal_period_s
            rate = cfg.rate_per_s * (1.0 + cfg.diurnal_amp * np.sin(2.0 * np.pi * phase))
        else:
            raise ValueError(f"unknown arrival process {cfg.arrival!r}")
        t += float(rng.exponential(1.0 / rate))
        plen = int(rng.integers(cfg.prompt_len_lo, cfg.prompt_len_hi))
        arrivals.append(Arrival(t, f"r{i}", plen, _series(cfg, plen, rng)))
    return warm, arrivals


def make_controller(cfg: StreamConfig, engine: str, device=None):
    return make_admission_controller(
        engine,
        hbm_budget_mib=cfg.hbm_budget_mib,
        k=cfg.k,
        interval_s=cfg.interval_s,
        n_shards=cfg.n_shards,
        device=device,
    )


def _actual_usage(live: dict, t: float, interval_s: float) -> float:
    """Ground-truth HBM in use at ``t``: each live request's replayed series
    sample at its elapsed time."""
    tot = 0.0
    for start, series in live.values():
        idx = min(int((t - start) / interval_s), len(series) - 1)
        tot += float(series[max(idx, 0)])
    return tot


def run_stream(
    cfg: StreamConfig, engine: str = "batched", controller=None, arrivals=None, debug_state=None, device=None
) -> StreamResult:
    """Replay one workload through one admission engine.

    The loop interleaves three event kinds in time order: request finishes
    (release + observe — online learning), admission batches (consecutive
    arrivals within ``batch_window_s`` and not straddling a finish), and the
    eviction backstop after every state change.  All policy decisions are
    identical across engines by construction; only the admission call is
    engine-specific.

    ``arrivals`` overrides the generated workload with a pre-built
    ``(warmup, serving arrivals)`` pair — e.g. to replay distorted series
    (the eviction-parity tests) or recorded traces.

    ``debug_state``, when a dict, receives the final bookkeeping maps
    (``live``, ``info``, ``plans``, ``evicted_ids``) after the loop drains —
    all empty on a clean run; the leak-regression tests assert exactly that."""
    warm, arrivals = arrivals if arrivals is not None else generate_arrivals(cfg)
    ctl = controller if controller is not None else make_controller(cfg, engine, device)
    for a in warm:
        ctl.observe(a.prompt_len, a.series)

    sharded = hasattr(ctl, "shard_of")
    n_sh = ctl.n_shards if sharded else 1
    many = hasattr(ctl, "try_admit_many") and engine != "scalar" and engine != "sharded-scalar"

    finishes: list[tuple[float, str]] = []  # (finish time, request id) heap
    live: dict[str, tuple[float, np.ndarray]] = {}  # rid -> (admitted_at, series)
    info: dict[str, Arrival] = {}
    plans: dict[str, object] = {}
    decisions: list[tuple[str, bool]] = []
    latencies: list[float] = []
    finished_plans = []
    admitted = rejected = evicted = finished = 0
    evicted_ids: set[str] = set()
    makespan = 0.0
    wall = 0.0
    # per-shard bookkeeping: [decisions, admitted, rejected, evicted]
    sh_counts = np.zeros((n_sh, 4), dtype=np.int64)
    sh_lat: list[list[float]] = [[] for _ in range(n_sh)]

    def _shard(rid: str) -> int:
        return ctl.shard_of(rid) if sharded else 0

    def evict_until_fits(t: float) -> None:
        nonlocal evicted
        if not live:
            return
        # one pass over the live set (the old backstop recomputed the O(live)
        # total on every kill iteration — O(live^2) under eviction storms):
        # gather per-request usage once, then re-total incrementally per pop
        usage = {
            rid: float(series[min(max(int((t - start) / cfg.interval_s), 0), len(series) - 1)])
            for rid, (start, series) in live.items()
        }
        total = float(np.asarray(list(usage.values())).sum())
        # youngest-first kill: the newest admissions are the cheapest to
        # redo and the likeliest mispredictions under a fresh model
        for rid in sorted(live, key=lambda r: (live[r][0], r), reverse=True):
            if total <= cfg.hbm_budget_mib:
                break
            total -= usage[rid]
            live.pop(rid)
            plans.pop(rid, None)
            info.pop(rid, None)  # the eviction ends this request's lifecycle
            ctl.release(rid)
            # tombstone for the finish event still sitting in the heap; the
            # stale-event pop below removes it again, so a drained loop ends
            # with every bookkeeping map empty
            evicted_ids.add(rid)
            evicted += 1
            sh_counts[_shard(rid), 3] += 1

    i = 0
    n = len(arrivals)
    while i < n or finishes:
        next_fin = finishes[0][0] if finishes else np.inf
        next_arr = arrivals[i].t if i < n else np.inf
        if next_fin <= next_arr:
            t, rid = heapq.heappop(finishes)
            if rid in evicted_ids:
                # the request was killed before its finish fired: consume the
                # stale event and its tombstone, and still advance the clock —
                # survivors matured since the last check, so the backstop must
                # recheck here too, not only at real finishes
                evicted_ids.discard(rid)
                makespan = max(makespan, t)
                evict_until_fits(t)
                continue
            start, series = live.pop(rid)
            a = info.pop(rid)
            ctl.release(rid)
            ctl.observe(a.prompt_len, series)
            finished_plans.append((plans.pop(rid), series, cfg.interval_s))
            finished += 1
            makespan = max(makespan, t)
            # surviving requests matured since the last check: the backstop
            # fires at finishes too, not only at admission commits
            evict_until_fits(t)
            continue
        # admission batch: consecutive arrivals inside the window, never
        # straddling a finish (releasing budget mid-batch would change
        # decisions, so the batch boundary is part of the policy)
        j = i
        t0 = arrivals[i].t
        while j < n and arrivals[j].t <= t0 + cfg.batch_window_s and arrivals[j].t < next_fin:
            j += 1
        batch = arrivals[i:j]
        if many:
            t_w = time.perf_counter()
            got = ctl.try_admit_many(
                [a.request_id for a in batch],
                [a.prompt_len for a in batch],
                np.asarray([a.t for a in batch]),
            )
            dt = time.perf_counter() - t_w
            wall += dt
            per = dt / len(batch)
            latencies.extend([per] * len(batch))
            for a in batch:
                sh_lat[_shard(a.request_id)].append(per)
        else:
            got = []
            for a in batch:
                t_w = time.perf_counter()
                got.append(ctl.try_admit(a.request_id, a.prompt_len, a.t))
                dt = time.perf_counter() - t_w
                wall += dt
                latencies.append(dt)
                sh_lat[_shard(a.request_id)].append(dt)
        for a, plan in zip(batch, got):
            decisions.append((a.request_id, plan is not None))
            s = _shard(a.request_id)
            sh_counts[s, 0] += 1
            if plan is None:
                rejected += 1
                sh_counts[s, 2] += 1
                continue
            admitted += 1
            sh_counts[s, 1] += 1
            live[a.request_id] = (a.t, a.series)
            info[a.request_id] = a
            plans[a.request_id] = plan
            heapq.heappush(finishes, (a.t + len(a.series) * cfg.interval_s, a.request_id))
        evict_until_fits(batch[-1].t)
        i = j

    if debug_state is not None:
        debug_state.update(live=live, info=info, plans=plans, evicted_ids=evicted_ids)
    wastage = ctl.reservation_wastage(finished_plans)
    # no decisions -> no measurement: report nan percentiles (and zero
    # throughput), never a fabricated 0.0-latency sample
    if latencies:
        lat = np.asarray(latencies)
        p50, p99 = float(np.percentile(lat, 50)), float(np.percentile(lat, 99))
        dps = float(len(decisions) / max(wall, 1e-12))
        slo = {
            "target_s": cfg.slo_admit_latency_s,
            "violations": int(np.sum(lat > cfg.slo_admit_latency_s)),
            "violation_frac": float(np.mean(lat > cfg.slo_admit_latency_s)),
        }
    else:
        p50 = p99 = float("nan")
        dps = 0.0
        slo = {"target_s": cfg.slo_admit_latency_s, "violations": 0, "violation_frac": float("nan")}
    shard_rows = imbalance = None
    if sharded:
        shard_rows = []
        for s in range(n_sh):
            ls = np.asarray(sh_lat[s]) if sh_lat[s] else None
            shard_rows.append(
                {
                    "shard": s,
                    "decisions": int(sh_counts[s, 0]),
                    "admitted": int(sh_counts[s, 1]),
                    "rejected": int(sh_counts[s, 2]),
                    "evicted": int(sh_counts[s, 3]),
                    "p50_latency_s": float(np.percentile(ls, 50)) if ls is not None else float("nan"),
                    "p99_latency_s": float(np.percentile(ls, 99)) if ls is not None else float("nan"),
                    "slo_violation_frac": (
                        float(np.mean(ls > cfg.slo_admit_latency_s))
                        if ls is not None
                        else float("nan")
                    ),
                }
            )
        dec = sh_counts[:, 0].astype(np.float64)
        adm = sh_counts[:, 1].astype(np.float64)
        imbalance = {
            "decisions_max_over_mean": float(dec.max() / dec.mean()) if dec.mean() > 0 else float("nan"),
            "admitted_max_over_mean": float(adm.max() / adm.mean()) if adm.mean() > 0 else float("nan"),
        }
    return StreamResult(
        engine=engine,
        admitted=admitted,
        rejected=rejected,
        evicted=evicted,
        finished=finished,
        decisions=decisions,
        wastage=wastage,
        makespan_s=float(makespan),
        wall_s=float(wall),
        decisions_per_s=dps,
        p50_latency_s=p50,
        p99_latency_s=p99,
        slo=slo,
        shards=shard_rows,
        imbalance=imbalance,
    )
