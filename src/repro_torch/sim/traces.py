"""Synthetic nf-core-like monitoring traces.

The paper evaluates on traces of two nf-core workflows whose raw data is not
available offline, so we generate synthetic traces *calibrated to the
statistics the paper publishes* (Sec. IV-B):

* **sarek**  — 29 task types, mean runtimes 2 s .. 1 h, mean peak memory
  10 MB .. 23 GB, up to 1512 executions of one task type.
* **eager**  — 18 task types, mean runtimes 8 s .. 4 h, peaks 19 MB .. 14 GB,
  up to 136 executions of one task type.
* 33 of the 47 task types have enough executions to be evaluated (we follow
  the paper and evaluate task types with >= 20 executions; the generator is
  calibrated so exactly 33 qualify).

Each task type draws a memory-over-time *shape family* modeled on the curves
the paper shows (Fig. 1: rise-then-decline; Fig. 4: staged adapter-removal;
Fig. 8a: Qualimap's zigzag) plus the standard plateau/ramp/spike shapes of
bioinformatics tools.  Runtime and peak memory correlate linearly with the
total input size (the core modeling assumption of the paper and of Witt et
al.), with heteroscedastic noise; a fraction of task types is deliberately
input-size-UNcorrelated, which the paper observes degrades the LR baselines.

Everything is deterministic in the seed.  Units: MiB / seconds.

This module is the port's own copy of the reference generator
(``repro.sim.traces``): numpy only, the same draws in the same order, so one
seed gives byte-equal arrays in both packages.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np

MIB = 1.0
GIB = 1024.0
_INTERVAL_S = 2.0  # paper's monitoring interval

FAMILIES = ("plateau", "ramp", "spike", "staged", "sawtooth", "decline")


@dataclasses.dataclass
class Execution:
    input_size: float  # bytes (total input file size — the model's x)
    series: np.ndarray  # (j,) float32 memory usage in MiB, one sample / interval


@dataclasses.dataclass
class TaskTrace:
    name: str
    workflow: str
    family: str
    default_mib: float  # workflow developers' static allocation
    interval_s: float
    executions: list[Execution]

    @property
    def n_executions(self) -> int:
        return len(self.executions)

    def max_samples(self) -> int:
        return max(len(e.series) for e in self.executions)

    def padded(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(inputs (B,), series (B, T) zero-padded, lengths (B,)) for the
        batched engine."""
        B, T = self.n_executions, self.max_samples()
        y = np.zeros((B, T), dtype=np.float32)
        lengths = np.zeros(B, dtype=np.int32)
        x = np.zeros(B, dtype=np.float64)
        for b, e in enumerate(self.executions):
            y[b, : len(e.series)] = e.series
            lengths[b] = len(e.series)
            x[b] = e.input_size
        return x, y, lengths


def _next_pow2(n: int) -> int:
    return 1 << max(int(n) - 1, 0).bit_length()


def bucket_size(n: int, floor: int = 8) -> int:
    """Smallest power of two >= max(n, floor): the static-shape bucket that
    bounds the number of distinct shapes for data-dependent batch sizes —
    the same rounding ``pack_traces`` applies to series lengths."""
    return _next_pow2(max(int(n), floor))


def fine_bucket(n: int, floor: int = 8, step: int = 8) -> int:
    """Like ``bucket_size`` but with eighth-of-a-power-of-two granularity
    (... 128, 160, 192, 224, 256 ...).  Axes whose runtime cost is linear in
    the padded size (row scans, probe sets, timeline seeds) waste at most
    12.5% on dead padding instead of up to 50%, at the price of a few more
    compiled variants per axis.  Returned sizes stay multiples of ``step``
    (vector-lane alignment, or a scan's fold cadence)."""
    p = bucket_size(n, floor=floor)
    for eighths in (4, 5, 6, 7):
        c = p * eighths // 8
        if floor <= c and n <= c and c % step == 0:
            return c
    return p


@dataclasses.dataclass
class PaddedTaskBatch:
    """A bucket of task types padded to one (B, T) shape for the batched engine.

    Lanes are tasks; executions keep their original order so lane b's first
    ``n_execs[b]`` rows are the real executions and the zero tail is inert
    padding (the batch engine's online updates at padded rows can only feed
    other padded rows).
    """

    tasks: list[TaskTrace]
    x: np.ndarray  # (L, B) float64 input sizes
    y: np.ndarray  # (L, B, T) float32 padded series
    lengths: np.ndarray  # (L, B) int32 valid sample counts
    n_execs: np.ndarray  # (L,) int32 valid execution counts
    default_mib: np.ndarray  # (L,) float64 static directives

    @property
    def shape(self) -> tuple[int, int, int]:
        return self.y.shape


def pack_traces(tasks: list[TaskTrace]) -> list[PaddedTaskBatch]:
    """Pack task types into bucket-padded batches.

    Tasks are grouped by ``next_pow2(max_samples)`` — series length dominates
    the memory of a padded batch — and each bucket pads executions to the
    next multiple of 64 above its largest member (the scan walks the
    execution axis, so padding it costs wall-clock, not just memory).  The
    number of distinct shapes stays logarithmic in the corpus
    extremes; lanes sharing a bucket ride the same batched pass, whose
    wall-clock the longest lane sets anyway.  Within a group the sample
    axis pads only to ``fine_bucket`` of the longest member: per-execution
    work is linear in the padded series, and the pow-of-two tail was up to
    half the ladder pass's wall on real corpora.
    """
    buckets: dict[int, list[TaskTrace]] = {}
    for t in tasks:
        buckets.setdefault(_next_pow2(t.max_samples()), []).append(t)
    batches = []
    for _, group in sorted(buckets.items()):
        T = fine_bucket(max(t.max_samples() for t in group), floor=2, step=2)
        L = len(group)
        B = -(-max(t.n_executions for t in group) // 64) * 64
        x = np.zeros((L, B), dtype=np.float64)
        y = np.zeros((L, B, T), dtype=np.float32)
        lengths = np.zeros((L, B), dtype=np.int32)
        n_execs = np.zeros(L, dtype=np.int32)
        defaults = np.zeros(L, dtype=np.float64)
        for li, t in enumerate(group):
            xb, yb, lb = t.padded()
            n = t.n_executions
            x[li, :n] = xb
            y[li, :n, : yb.shape[1]] = yb
            lengths[li, :n] = lb
            n_execs[li] = n
            defaults[li] = t.default_mib
        batches.append(PaddedTaskBatch(group, x, y, lengths, n_execs, defaults))
    return batches


@dataclasses.dataclass
class WorkflowTrace:
    name: str
    tasks: list[TaskTrace]

    def eligible_tasks(self, min_executions: int = 20) -> list[TaskTrace]:
        return [t for t in self.tasks if t.n_executions >= min_executions]

    def to_padded_batch(self, min_executions: int = 20) -> list[PaddedTaskBatch]:
        """Bucket-padded batches of this workflow's eligible tasks (the batch
        engine packs whole corpora with ``pack_traces`` directly)."""
        return pack_traces(self.eligible_tasks(min_executions))


# ---------------------------------------------------------------------------
# Shape families: curve(t_norm in [0,1]) -> [0, 1] relative memory level.
# Per-execution jitter keeps phase positions from being perfectly learnable.
# ---------------------------------------------------------------------------


def _curve(family: str, t: np.ndarray, rng: np.random.Generator, p: dict) -> np.ndarray:
    if family == "plateau":
        rise = p["rise"] * rng.uniform(0.8, 1.2)
        return np.minimum(t / max(rise, 1e-3), 1.0)
    if family == "ramp":
        return t ** p["gamma"]
    if family == "spike":
        c = np.clip(p["center"] + rng.normal(0, 0.04), 0.05, 0.95)
        w = p["width"]
        spike = np.exp(-0.5 * ((t - c) / w) ** 2)
        return p["base"] + (1.0 - p["base"]) * spike
    if family == "staged":
        c = np.clip(p["center"] + rng.normal(0, 0.03), 0.1, 0.9)
        lo, width = p["base"], 0.02
        s = 1.0 / (1.0 + np.exp(-(t - c) / width))
        ramp_in = np.minimum(t / 0.05, 1.0)
        return np.clip(ramp_in * (lo + (1.0 - lo) * s + 0.05 * t), 0.0, 1.0)
    if family == "sawtooth":
        period = p["period"] * rng.uniform(0.9, 1.1)
        phase = rng.uniform(0, period)
        saw = ((t + phase) % period) / period
        return p["base"] + (1.0 - p["base"]) * saw
    if family == "decline":
        c = np.clip(p["center"] + rng.normal(0, 0.03), 0.15, 0.7)
        up = np.minimum(t / c, 1.0)
        down = 1.0 - (1.0 - p["floor"]) * np.maximum((t - c) / max(1.0 - c, 1e-3), 0.0)
        return np.where(t <= c, up, down)
    raise ValueError(f"unknown family {family!r}")


@dataclasses.dataclass
class _TaskSpec:
    name: str
    family: str
    n_exec: int
    mean_runtime_s: float
    mean_peak_mib: float
    input_mu: float  # lognormal(mu, sigma) over bytes
    input_sigma: float
    rt_correlated: bool
    mem_correlated: bool
    rt_noise: float  # multiplicative (truncated-normal) sigma
    mem_noise: float
    mem_saturation: float  # memory-vs-input-size relation saturates here
    params: dict


def _make_specs(workflow: str, rng: np.random.Generator, scale: float) -> list[_TaskSpec]:
    if workflow == "sarek":
        n_tasks, max_exec = 29, 1512
        rt_lo, rt_hi = 2.0, 3600.0
        pk_lo, pk_hi = 10 * MIB, 23 * GIB
        n_eligible = 21  # + 12 from eager = 33 evaluated tasks (paper)
    elif workflow == "eager":
        n_tasks, max_exec = 18, 136
        rt_lo, rt_hi = 8.0, 4 * 3600.0
        pk_lo, pk_hi = 19 * MIB, 14 * GIB
        n_eligible = 12
    else:
        raise ValueError(workflow)

    # Mean runtimes / peaks log-spaced across the published ranges (shuffled
    # so family/size pairings vary); execution counts heavy-tailed with the
    # published maximum, exactly n_eligible of them >= 20.
    runtimes = np.exp(rng.permutation(np.linspace(np.log(rt_lo), np.log(rt_hi), n_tasks)))
    peaks = np.exp(rng.permutation(np.linspace(np.log(pk_lo), np.log(pk_hi), n_tasks)))
    counts = np.full(n_tasks, 0, dtype=int)
    elig = rng.permutation(n_tasks)[:n_eligible]
    # heavy tail: one task at the published max, rest log-spaced 20..max/2
    tail = np.exp(np.linspace(np.log(20), np.log(max_exec / 2), n_eligible - 1))
    counts[elig] = np.concatenate([[max_exec], np.maximum(np.round(tail), 20).astype(int)])
    small = counts == 0
    counts[small] = rng.integers(3, 19, size=small.sum())

    specs = []
    for i in range(n_tasks):
        family = FAMILIES[i % len(FAMILIES)]
        params = {
            "rise": rng.uniform(0.03, 0.15),
            "gamma": rng.uniform(0.5, 2.0),
            "center": rng.uniform(0.3, 0.8),
            "width": rng.uniform(0.02, 0.08),
            "base": rng.uniform(0.25, 0.5),
            "period": rng.uniform(0.08, 0.25),
            "floor": rng.uniform(0.3, 0.6),
        }
        specs.append(
            _TaskSpec(
                name=f"{workflow}:task{i:02d}_{family}",
                family=family,
                n_exec=max(int(counts[i] * scale), 3),
                mean_runtime_s=float(runtimes[i] * scale if runtimes[i] > 600 else runtimes[i]),
                mean_peak_mib=float(peaks[i]),
                input_mu=float(np.log(rng.uniform(50e6, 20e9))),
                input_sigma=float(rng.uniform(0.2, 0.7)),
                rt_correlated=bool(rng.random() < 0.85),
                mem_correlated=bool(rng.random() < 0.5),
                rt_noise=float(rng.uniform(0.02, 0.08)),
                mem_noise=float(rng.uniform(0.02, 0.08)),
                mem_saturation=float(rng.uniform(1.8, 3.0)),
                params=params,
            )
        )
    return specs


def _round_default(mib: float) -> float:
    """nf-core-style memory directives: 1/2/4/6/8/12/16/24/32/48/64/96/128 GB."""
    ladder = np.array([0.25, 0.5, 1, 2, 4, 6, 8, 12, 16, 24, 32, 48, 64, 96, 128]) * GIB
    idx = np.searchsorted(ladder, mib, side="left")
    return float(ladder[min(idx, len(ladder) - 1)])


def _generate_task(spec: _TaskSpec, rng: np.random.Generator, interval_s: float) -> TaskTrace:
    execs = []
    x_mean = np.exp(spec.input_mu + spec.input_sigma**2 / 2)
    for _ in range(spec.n_exec):
        x = float(rng.lognormal(spec.input_mu, spec.input_sigma))
        rel = x / x_mean
        # Bounded multiplicative noise: real tools' peaks cluster — an
        # unbounded tail would make every method fail on record peaks forever,
        # which the paper's traces clearly don't (PPM's node-max retries are
        # rare enough for it to beat the defaults).
        rt = spec.mean_runtime_s * (0.35 + 0.65 * rel if spec.rt_correlated else 1.0)
        rt *= 1.0 + float(np.clip(rng.normal(0.0, spec.rt_noise), -2.5 * spec.rt_noise, 2.5 * spec.rt_noise))
        j = max(int(round(rt / interval_s)), 2)
        # Memory saturates for large inputs (streaming tools cap their
        # buffers) — a mildly *non*-linear relation, as in real traces, which
        # a straight LR can only approximate.
        mem_rel = min(rel, spec.mem_saturation)
        peak = spec.mean_peak_mib * (0.4 + 0.6 * mem_rel if spec.mem_correlated else 1.0)
        # Heteroscedastic: bigger inputs are noisier.
        sigma = spec.mem_noise * (0.6 + 0.4 * min(rel, 2.0))
        peak *= 1.0 + float(np.clip(rng.normal(0.0, sigma), -2.5 * sigma, 2.5 * sigma))
        peak = float(np.clip(peak, 8.0, 100 * GIB))
        t = (np.arange(j) + 0.5) / j
        curve = _curve(spec.family, t, rng, spec.params)
        base = 0.02 * peak + 8.0  # resident baseline (interpreter + libs)
        y = base + (peak - base) * np.clip(curve, 0.0, 1.0)
        y *= 1.0 + rng.normal(0.0, 0.015, size=j)  # measurement jitter
        y = np.clip(y, 1.0, 100 * GIB).astype(np.float32)
        execs.append(Execution(input_size=x, series=y))

    max_peak = max(float(e.series.max()) for e in execs)
    default = _round_default(max_peak * rng.uniform(1.15, 2.2))
    return TaskTrace(
        name=spec.name,
        workflow=spec.name.split(":")[0],
        family=spec.family,
        default_mib=default,
        interval_s=interval_s,
        executions=execs,
    )


def generate_workflow(name: str, seed: int = 0, scale: float = 1.0, interval_s: float = _INTERVAL_S) -> WorkflowTrace:
    """Generate one workflow's traces.  ``scale`` < 1 shrinks execution counts
    and long runtimes proportionally (for tests/CI)."""
    rng = np.random.default_rng(np.random.SeedSequence([zlib.crc32(name.encode()) & 0xFFFF, seed]))
    specs = _make_specs(name, rng, scale)
    return WorkflowTrace(name=name, tasks=[_generate_task(s, rng, interval_s) for s in specs])


def generate_sarek(seed: int = 0, scale: float = 1.0) -> WorkflowTrace:
    return generate_workflow("sarek", seed, scale)


def generate_eager(seed: int = 0, scale: float = 1.0) -> WorkflowTrace:
    return generate_workflow("eager", seed, scale)


def generate_suite(seed: int = 0, scale: float = 1.0) -> list[WorkflowTrace]:
    """The paper's full experimental corpus: sarek + eager."""
    return [generate_sarek(seed, scale), generate_eager(seed, scale)]
