"""The cluster scheduler with time-varying memory reservations (Sec. IV-E).

Port of ``repro.sim.cluster``.  The paper's Sec. IV-E
limitation: a resource manager takes one memory figure per job, so
k-Segments' step-function predictions pay off only once the manager accepts
*dynamic* reservations.  This is that manager, simulated: nodes track
reserved memory as a step function over time, the scheduler places tasks
first-fit against the *future* reservation profile, and OOM kills trigger
the method's retry strategy.  Per policy it reports makespan, wastage
(reserved-minus-used GiB*s) and retries.

``run_cluster`` is the sequential oracle: one ``predict`` / score /
``observe`` chain per task through the host predictors
(``core.predictor.make_method``, float64 numpy), placed first-fit by the
scalar ``_find_slot`` loop against each node's ``Timeline``
(``NodeState``).  ``run_cluster_batched`` is the device path:

1. every queued execution's predictions and full retry ladder, for all
   policies at once, from the two-phase engine
   (``batch_engine.compute_cluster_ladders``);
2. each policy's ladders flattened into attempt rows in queue order
   (``_policy_rows``);
3. placement on the device (``sim.device_timeline``): the per-policy
   windows loop (``_place_rows_batched``: fixed-clock windows while rows
   keep placing, scheduling epochs with in-program waits once a row
   blocks), or one sweep over all policies as lanes (``sweep_schedule``),
   picked by a per-row cost model (``_auto_sweep``).  Both engines give
   identical placements.

Predictions see exactly the executions the sequential protocol observes
(completed earlier executions of the same task type), so the two give the
same placements with ``KSegmentsConfig(error_mode="progressive")``.
``run_cluster_sweep`` runs a whole (corpus x policy x node count) design
space as lanes of one sweep; ``pareto_frontier`` reduces its results.
"""

from __future__ import annotations

import dataclasses
import heapq
import time

import numpy as np
import torch

from repro_torch.core.allocation import StepAllocation, score_attempt_np
from repro_torch.core.ksegments import KSegmentsConfig
from repro_torch.core.predictor import AllocationMethod, make_method
from repro_torch.core.timeline import Timeline
from repro_torch.device import resolve_device
from repro_torch.sim.batch_engine import compute_cluster_ladders
from repro_torch.sim.device_timeline import first_fit_window, schedule_epoch, sweep_axis_hint, sweep_schedule
from repro_torch.sim.traces import TaskTrace, WorkflowTrace


@dataclasses.dataclass
class NodeState:
    """One node of the sequential oracle: its capacity and its active
    reservations ``(end, alloc, start)``, with their summed demand kept
    incrementally in a ``Timeline``.  A caller that mutates ``active``
    directly is detected by the rows' identities, and the timeline is
    rebuilt on the next read."""

    capacity_mib: float
    active: list[tuple[float, StepAllocation, float]] = dataclasses.field(default_factory=list)
    _prof: Timeline = dataclasses.field(default_factory=Timeline, init=False, repr=False, compare=False)
    _synced: tuple = dataclasses.field(default=(), init=False, repr=False, compare=False)
    _seq: int = dataclasses.field(default=0, init=False, repr=False, compare=False)

    def _key(self) -> tuple[int, ...]:
        return tuple(map(id, self.active))

    def _sync(self) -> Timeline:
        key = self._key()
        if key != self._synced:
            prof = Timeline()
            for end, alloc, start in self.active:
                prof.add(self._seq, alloc.boundaries, alloc.values, start, end)
                self._seq += 1
            self._prof = prof
            self._synced = key
        return self._prof

    def reserved_at(self, t: float) -> float:
        """Total reserved MiB at time ``t``."""
        return float(self._sync().demand_at(t))

    def add(self, end: float, alloc: StepAllocation, start: float) -> None:
        """Reserve ``alloc`` over [start, end)."""
        prof = self._sync()
        prof.add(self._seq, alloc.boundaries, alloc.values, start, end)
        self._seq += 1
        self.active.append((end, alloc, start))
        self._synced = self._key()

    def expire(self, t: float) -> None:
        """Drop reservations that ended at or before ``t``."""
        if not self.active:
            return
        keep = [e > t for e, _, _ in self.active]
        if all(keep):
            return
        prof = self._sync()
        prof.expire(t)
        self.active = [row for row, k_ in zip(self.active, keep) if k_]
        self._synced = self._key()

    def fits(self, alloc: StepAllocation, start: float, duration: float) -> bool:
        """Whether ``alloc`` placed over [start, start + duration) keeps the
        node's summed demand within its capacity."""
        return not self._sync().demand_exceeds(alloc, start, start + duration, self.capacity_mib + 1e-6)


@dataclasses.dataclass
class TaskRecord:
    """One queued execution's fate: every attempt's placement plus totals.
    Tasks are identified by (workflow, task): names can collide across
    workflows."""

    workflow: str
    task: str
    exec_index: int
    attempts: int  # retries + 1
    placements: list[tuple[int, float, float]]  # (node, start, end) per attempt
    wastage_gib_s: float

    @property
    def finish_s(self) -> float:
        """Completion time of the successful (final) attempt."""
        return self.placements[-1][2]


@dataclasses.dataclass
class ClusterResult:
    policy: str
    makespan_s: float
    wastage_gib_s: float
    retries: int
    tasks_run: int
    records: list[TaskRecord] = dataclasses.field(default_factory=list)


def _eligible_queue(
    workflows: list[WorkflowTrace],
    train_frac: float,
    max_tasks_per_type: int,
    min_executions: int,
) -> tuple[list[tuple[TaskTrace, int]], list[tuple[TaskTrace, int]]]:
    """Arrival-ordered (trace, execution index) rows + per-trace train split."""
    queue: list[tuple[TaskTrace, int]] = []
    traces: list[tuple[TaskTrace, int]] = []
    for wf in workflows:
        for trace in wf.eligible_tasks(min_executions):
            n_train = int(trace.n_executions * train_frac)
            traces.append((trace, n_train))
            for i in range(n_train, min(trace.n_executions, n_train + max_tasks_per_type)):
                queue.append((trace, i))
    return queue, traces


def _gc(nodes: list[NodeState], t: float) -> None:
    for nd in nodes:
        nd.expire(t)


def _find_slot(
    nodes: list[NodeState],
    events: list[tuple[float, int]],
    now: float,
    alloc: StepAllocation,
    duration: float,
) -> tuple[int, float]:
    """First-fit placement against the nodes' future reservation profiles;
    waits on the completion heap when no node fits.  Returns (node, time)."""
    while True:
        _gc(nodes, now)
        for ni, nd in enumerate(nodes):
            if nd.fits(alloc, now, duration):
                return ni, now
        if events:
            now = max(now, heapq.heappop(events)[0])  # wait for a slot
        else:
            now += 1.0


def run_cluster(
    workflows: list[WorkflowTrace],
    policy: str,
    n_nodes: int = 4,
    node_mib: float = 128 * 1024.0,
    train_frac: float = 0.5,
    max_tasks_per_type: int = 40,
    min_executions: int = 10,
    ksegments_config: KSegmentsConfig | None = None,
) -> ClusterResult:
    """Replay workflow executions through an ``n_nodes`` cluster under one
    policy ("ksegments-selective", "ppm-improved", "default", ...), on the
    host.

    Tasks arrive in trace order; each waits until some node fits its
    reservation, and the method learns online as tasks finish.  The
    sequential oracle of ``run_cluster_batched``: with
    ``ksegments_config=KSegmentsConfig(error_mode="progressive")`` the two
    place every attempt alike.
    """
    queue, traces = _eligible_queue(workflows, train_frac, max_tasks_per_type, min_executions)
    methods: dict[tuple[str, str], AllocationMethod] = {}
    for trace, n_train in traces:
        m = make_method(policy, trace.default_mib, node_mib, ksegments_config)
        for e in trace.executions[:n_train]:
            m.observe(e.input_size, e.series)
        methods[(trace.workflow, trace.name)] = m

    nodes = [NodeState(node_mib) for _ in range(n_nodes)]
    events: list[tuple[float, int]] = []  # (end, node) of every placed attempt
    now = 0.0
    total_waste = 0.0
    total_retries = 0
    # The wait loop consumes the completion heap and _gc drops expired
    # reservations, so the makespan is the running max of attempt ends.
    makespan = 0.0
    records: list[TaskRecord] = []

    for trace, i in queue:
        e = trace.executions[i]
        method = methods[(trace.workflow, trace.name)]
        series = e.series
        duration = len(series) * trace.interval_s
        alloc = method.predict(e.input_size)
        attempts = 0
        task_waste = 0.0
        placements: list[tuple[int, float, float]] = []
        while True:  # each attempt is a fresh placement
            attempts += 1
            alloc = StepAllocation(alloc.boundaries, np.minimum(alloc.values, node_mib))
            placed, now = _find_slot(nodes, events, now, alloc, duration)
            out = score_attempt_np(series, trace.interval_s, alloc)
            run_time = (out.failure_index + 1) * trace.interval_s if out.failed else duration
            end = now + run_time
            nodes[placed].add(end, alloc, now)
            heapq.heappush(events, (end, placed))
            placements.append((placed, now, end))
            makespan = max(makespan, end)
            total_waste += out.wastage_gib_s
            task_waste += out.wastage_gib_s
            if not out.failed:
                break
            total_retries += 1
            if attempts > 64:
                raise RuntimeError("unschedulable task")
            seg = alloc.segment_of((out.failure_index + 0.5) * trace.interval_s)
            alloc = method.on_failure(alloc, seg, node_mib)
        method.observe(e.input_size, e.series)
        records.append(TaskRecord(trace.workflow, trace.name, i, attempts, placements, task_waste))

    return ClusterResult(
        policy=policy,
        makespan_s=float(makespan),
        wastage_gib_s=float(total_waste),
        retries=int(total_retries),
        tasks_run=len(queue),
        records=records,
    )


def _policy_rows(ladders, queue, policy: str):
    """Flatten one policy's retry ladders into placement rows (queue x
    attempt order): (boundaries (R, k), values (R, k), run times (R,),
    probe durations (R,), attempts per task (Q,), wastage per task (Q,)).

    Run times are each attempt's node occupancy (up to and including the
    kill sample on failure); probe durations the execution's full duration,
    the window the scheduler fit-checks, since it cannot know an attempt will
    die early.  A ladder that did not converge raises (``TaskLadders.row``)."""
    bnds, vals, runs, probes, counts_all, waste = [], [], [], [], [], []
    Q = len(queue)
    i0 = 0
    while i0 < Q:
        trace = queue[i0][0]
        i1 = i0
        while i1 < Q and queue[i1][0] is trace:
            i1 += 1
        execs = np.asarray([i for _, i in queue[i0:i1]])
        tl = ladders[(trace.workflow, trace.name)]
        mi = tl.methods.index(policy)
        counts = tl.n_attempts[mi, execs]  # (q,)
        fi = tl.failure_index[mi, execs]  # (q, A)
        final_fi = np.take_along_axis(fi, (counts - 1)[:, None], axis=1)[:, 0]
        if np.any(final_fi >= 0):
            tl.row(policy, int(execs[np.argmax(final_fi >= 0)]))  # raises
        durations = np.asarray([len(trace.executions[i].series) for i in execs]) * trace.interval_s
        mask = np.arange(fi.shape[1])[None, :] < counts[:, None]
        runs.append(np.where(fi < 0, durations[:, None], (fi + 1) * trace.interval_s)[mask])
        probes.append(np.broadcast_to(durations[:, None], mask.shape)[mask])
        vals.append(tl.values[mi, execs][mask])
        k = tl.boundaries.shape[-1]
        bnds.append(np.broadcast_to(tl.boundaries[mi, execs][:, None, :], (*mask.shape, k))[mask])
        counts_all.append(counts)
        waste.append(np.sum(tl.wastage_gib_s[mi, execs] * mask, axis=1))
        i0 = i1
    return (
        np.concatenate(bnds),
        np.concatenate(vals),
        np.concatenate(runs).astype(np.float64),
        np.concatenate(probes).astype(np.float64),
        np.concatenate(counts_all),
        np.concatenate(waste),
    )


def _place_rows_batched(
    bnd_rows: np.ndarray,
    val_rows: np.ndarray,
    run_rows: np.ndarray,
    probe_rows: np.ndarray,
    n_nodes: int,
    node_mib: float,
    window: int,
    stats: dict | None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Place all of one policy's attempt rows with the device programs (the
    windows engine).  Returns per-row (node, start, end).

    * streaming: while rows keep placing at the current clock,
      ``first_fit_window`` decides a whole window per call;
    * congested: from the first blocked row, ``schedule_epoch`` places up
      to 8 rows per call with the waits resolved in the program, and hands
      back to streaming once an epoch places without waiting.

    Between calls the host mirrors the commits into the per-node
    ``Timeline``s (one ``add_many`` splice per node, the same event order)
    and drops the consumed completions.  The only host placement left is
    the sequential oracle's +1.0 clock walk when the completion heap drains
    with a row unplaced (unreachable for node-capped allocations; counted in
    ``waits_host``)."""
    dev = resolve_device(device)
    R = len(run_rows)
    profs = [Timeline() for _ in range(n_nodes)]
    pending: list[float] = []  # completion instants not yet consumed by a wait
    budget = node_mib + 1e-6  # the fits budget
    row_node = np.empty(R, dtype=np.int64)
    row_start = np.empty(R, dtype=np.float64)
    row_end = np.empty(R, dtype=np.float64)
    owner = 0
    now = 0.0
    r = 0
    congested = False

    def _commit(npl, nidx, starts, t0):
        """Mirror one call's placements into the host timelines/outputs."""
        nonlocal owner, r
        if stats is not None:
            stats["program_calls"] += 1
            stats["program_wall_s"] += time.perf_counter() - t0
        ends = starts[:npl] + run_rows[r : r + npl]
        # committing per node in row order splices time-tied events in
        # exactly the order one-at-a-time adds would
        for n in np.unique(nidx[:npl]):
            m = np.flatnonzero(nidx[:npl] == n)
            profs[n].add_many(range(owner, owner + len(m)), bnd_rows[r + m], val_rows[r + m], starts[m], ends[m])
            owner += len(m)
        row_node[r : r + npl] = nidx[:npl]
        row_start[r : r + npl] = starts[:npl]
        row_end[r : r + npl] = ends
        r += npl
        return [float(e) for e in ends]

    expired_at = -np.inf
    while r < R:
        if now > expired_at:
            for prof in profs:
                prof.expire(now)
            expired_at = now
        w = min(window, R - r)
        if not congested:
            t0 = time.perf_counter()
            placed, nidx = first_fit_window(
                now, bnd_rows[r : r + w], val_rows[r : r + w], run_rows[r : r + w], probe_rows[r : r + w],
                [prof.arrays() for prof in profs], budget, device=dev,
            )
            npl = w if placed.all() else int(np.argmin(placed))
            pending += _commit(npl, nidx, np.full(npl, now), t0)
            if r < R and npl < w:
                congested = True  # row r must wait: the epoch program takes over
            continue
        # small wait windows: every row of the epoch program pays for its
        # clock/heap machinery, so congested calls place a handful of rows
        w = min(w, 8)
        t0 = time.perf_counter()
        placed, nidx, starts, now, n_pops, n_waited, dead = schedule_epoch(
            now, bnd_rows[r : r + w], val_rows[r : r + w], run_rows[r : r + w], [prof.events() for prof in profs],
            np.asarray(pending), budget, min(window, 8), probe_times=probe_rows[r : r + w], device=dev,
        )
        if stats is not None:
            stats["waits_program"] += n_waited
        npl = w if placed.all() else int(np.argmin(placed))
        ends = _commit(npl, nidx, starts, t0)
        # the program consumed the n_pops earliest completions of the merged heap
        pending = sorted(pending + ends)[n_pops:]
        congested = n_waited > 0  # stream again once a window stops waiting
        if r < R and npl < w and not dead:
            # a full per-node commit buffer aborted the epoch; nothing of row
            # r was consumed: re-dispatch from fresh timelines
            congested = True
            continue
        if r < R and npl < w:
            # heap drained with row r unplaced: the oracle's +1.0 clock walk
            if stats is not None:
                stats["waits_host"] += 1
            alloc = StepAllocation(bnd_rows[r], val_rows[r])
            pdur = float(probe_rows[r])  # fit-check the full duration ...
            ni = None
            while ni is None:
                now += 1.0
                for prof in profs:
                    prof.expire(now)
                for i, prof in enumerate(profs):
                    if not prof.demand_exceeds(alloc, now, now + pdur, budget):
                        ni = i
                        break
            end = now + float(run_rows[r])  # ... but occupy the real run
            profs[ni].add(owner, bnd_rows[r], val_rows[r], now, end)
            owner += 1
            pending = sorted(pending + [end])
            row_node[r], row_start[r], row_end[r] = ni, now, end
            r += 1
    return row_node, row_start, row_end


def _policy_result(
    policy: str,
    queue: list[tuple[TaskTrace, int]],
    counts: np.ndarray,
    waste: np.ndarray,
    row_node: np.ndarray,
    row_start: np.ndarray,
    row_end: np.ndarray,
) -> ClusterResult:
    """One policy's ``ClusterResult`` from its placed attempt rows."""
    offsets = np.concatenate([[0], np.cumsum(counts)])
    records = [
        TaskRecord(
            trace.workflow,
            trace.name,
            i,
            int(counts[q]),
            [(int(row_node[j]), float(row_start[j]), float(row_end[j])) for j in range(offsets[q], offsets[q + 1])],
            float(waste[q]),
        )
        for q, (trace, i) in enumerate(queue)
    ]
    return ClusterResult(
        policy=policy,
        makespan_s=float(row_end.max()) if len(row_end) else 0.0,
        wastage_gib_s=float(waste.sum()),
        retries=int((counts - 1).sum()),
        tasks_run=len(queue),
        records=records,
    )


# The "auto" router's cost model: predicted placement wall of each engine.
# * windows: _WIN_DISPATCH_S per program call (the call and the host loop's
#   bookkeeping after it) + _WIN_ROW_S per attempt row;
# * sweep: one row step per attempt row of the deepest lane, each costing
#   per lane _SWEEP_STEP_S fixed + _SWEEP_CELL_S per carried timeline cell
#   (nodes x the compacted axis L-hat).
# Measured on an NVIDIA H100 80GB HBM3 at 700 W by chip_smoke.py's cluster
# phase at the standard configuration (PERF.md): a least-squares fit over the
# warm windows run's 330 program calls, and two warm sweeps at L and 4L.
# The router only picks the engine: both give identical placements.
_WIN_DISPATCH_S = 4.9e-2
_WIN_ROW_S = 2.7e-4
_SWEEP_STEP_S = 1.7e-3
_SWEEP_CELL_S = 2.4e-8


def _auto_sweep(rows: dict, policies: tuple, n_nodes: int, window: int) -> bool:
    """The ``placement="auto"`` router: True when the cost model predicts
    the single sweep beats the per-policy windows loop.

    On the card the model does not pick the faster engine: at the standard
    configuration it routes to windows, yet the warm sweep was faster in
    every measured run (PERF.md).  One cost per windows call cannot express
    the congested epochs, which cost far more per row than streaming
    windows.  Results do not depend on the route."""
    if len(policies) < 2:
        return False  # nothing to amortize: one lane costs a whole sweep
    lane_rows = [len(rows[p][2]) for p in policies]
    rmax, kmax = max(lane_rows), max(rows[p][0].shape[1] for p in policies)
    L_hat = sweep_axis_hint(len(policies), rmax, kmax, n_nodes)
    est_sweep = rmax * len(policies) * (_SWEEP_STEP_S + _SWEEP_CELL_S * n_nodes * L_hat)
    est_windows = sum(-(-r // window) * _WIN_DISPATCH_S + r * _WIN_ROW_S for r in lane_rows)
    return est_sweep <= est_windows


def _merge_stats(acc: dict, stats: dict) -> None:
    """Fold one run's placement stats into the caller's accumulator:
    counters add, per-lane lists replace, the timeline axis keeps its max."""
    for k, v in stats.items():
        if isinstance(v, list):
            acc[k] = v
        elif k == "timeline_axis":
            acc[k] = max(acc.get(k, 0), v)
        else:
            acc[k] = acc.get(k, 0) + v


def _check_kcfg(kcfg: KSegmentsConfig | None, entry: str) -> KSegmentsConfig:
    kcfg = kcfg or KSegmentsConfig(error_mode="progressive")
    if kcfg.error_mode == "insample" and kcfg.insample_window is None:
        raise ValueError(
            f"{entry} supports progressive or bounded-history insample "
            "offsets; set KSegmentsConfig(insample_window=W) for insample"
        )
    return kcfg


def _ladder_rows(workflows, policies, node_mib, train_frac, max_tasks_per_type, min_executions, kcfg,
                 max_attempts, ladder_x64, dev):
    """The queue and every policy's attempt rows of one corpus.  The ladder
    engine is forward-only, so executions past the last one the queue can
    reach are cut before it runs."""
    queue, traces = _eligible_queue(workflows, train_frac, max_tasks_per_type, min_executions)
    trunc = [dataclasses.replace(t, executions=t.executions[: n_train + max_tasks_per_type]) for t, n_train in traces]
    with torch.profiler.record_function("cluster.ladders"):  # names the phase in a profiler trace
        ladders = compute_cluster_ladders(trunc, policies, node_mib, kcfg, max_attempts, x64=ladder_x64, device=dev)
    return queue, {p: _policy_rows(ladders, queue, p) for p in policies}


def _new_stats() -> dict:
    return {"program_calls": 0, "program_wall_s": 0.0, "waits_program": 0, "waits_host": 0, "rows": 0}


def run_cluster_batched(
    workflows: list[WorkflowTrace],
    policies: tuple[str, ...],
    n_nodes: int = 4,
    node_mib: float = 128 * 1024.0,
    train_frac: float = 0.5,
    max_tasks_per_type: int = 40,
    min_executions: int = 10,
    ksegments_config: KSegmentsConfig | None = None,
    max_attempts: int = 32,
    placement_window: int = 128,
    placement_stats: dict | None = None,
    ladder_x64: bool = False,
    placement: str = "auto",
    device=None,
) -> dict[str, ClusterResult]:
    """Every policy through an ``n_nodes`` cluster; returns {policy:
    ClusterResult} with one ``TaskRecord`` per queued execution.

    ``placement`` picks the engine: ``"windows"`` (the per-policy windows
    loop), ``"sweep"`` (all policies as lanes of one sweep; a lane that
    overflows the sweep's timeline axis at its cap replays through the
    windows loop) or ``"auto"`` (``_auto_sweep``).  ``ladder_x64`` computes
    the ladders in float64.  ``placement_stats`` accumulates
    ``program_calls``, ``program_wall_s``, ``waits_program`` (rows whose
    wait the device program resolved), ``waits_host`` (host clock walks, 0
    in practice) and ``rows``, plus the sweep's ``carried_hw`` and
    ``timeline_axis``.  k-Segments policies use progressive error offsets
    unless ``ksegments_config`` asks for bounded insample ones.  Runs on the
    card unless ``device="cpu"``."""
    if placement not in ("auto", "sweep", "windows"):
        raise ValueError(f"unknown placement engine: {placement!r}")
    dev = resolve_device(device)
    kcfg = _check_kcfg(ksegments_config, "run_cluster_batched")
    policies = tuple(policies)
    queue, rows = _ladder_rows(workflows, policies, node_mib, train_frac, max_tasks_per_type, min_executions, kcfg,
                               max_attempts, ladder_x64, dev)
    stats = _new_stats()
    placed: dict[str, tuple[np.ndarray, np.ndarray, np.ndarray]] = {}
    with torch.profiler.record_function("cluster.placement"):
        if placement == "sweep" or (placement == "auto" and _auto_sweep(rows, policies, n_nodes, placement_window)):
            node_s, start_s, _, _, dead = sweep_schedule(
                [rows[p][:4] for p in policies], [n_nodes] * len(policies), [node_mib + 1e-6] * len(policies),
                stats=stats, device=dev,
            )
            for s, p in enumerate(policies):
                if not dead[s]:
                    r = len(rows[p][2])
                    placed[p] = (node_s[s, :r], start_s[s, :r], start_s[s, :r] + rows[p][2])
        for p in policies:  # the windows engine, or sweep lanes that overflowed
            if p not in placed:
                placed[p] = _place_rows_batched(*rows[p][:4], n_nodes, node_mib, placement_window, stats,
                                                device=dev)
    results: dict[str, ClusterResult] = {}
    for p in policies:
        stats["rows"] += len(rows[p][2])
        results[p] = _policy_result(p, queue, rows[p][4], rows[p][5], *placed[p])
    if placement_stats is not None:
        _merge_stats(placement_stats, stats)
    return results


def run_cluster_sweep(
    corpora: dict[str, list[WorkflowTrace]] | list[WorkflowTrace],
    policies: tuple[str, ...],
    node_counts: tuple[int, ...] = (4,),
    node_mib: float = 128 * 1024.0,
    train_frac: float = 0.5,
    max_tasks_per_type: int = 40,
    min_executions: int = 10,
    ksegments_config: KSegmentsConfig | None = None,
    max_attempts: int = 32,
    placement_window: int = 128,
    placement_stats: dict | None = None,
    ladder_x64: bool = False,
    device=None,
) -> dict[tuple[str, str, int], ClusterResult]:
    """Capacity planning: the whole (corpus x policy x node count) design
    space as lanes of one sweep.  Ladders are computed once per corpus (they
    depend on ``node_mib``, not on the node count).  A lane that overflows
    the sweep's timeline axis replays through the windows loop.  ``corpora``
    maps names to workflow lists (a bare list is the corpus ``""``).
    Returns ``{(corpus, policy, n_nodes): ClusterResult}``."""
    dev = resolve_device(device)
    if not isinstance(corpora, dict):
        corpora = {"": corpora}
    kcfg = _check_kcfg(ksegments_config, "run_cluster_sweep")
    policies = tuple(policies)
    stats = _new_stats()
    lane_rows, lane_nodes, lane_keys = [], [], []
    meta: dict[str, tuple[list, dict]] = {}
    for cname, wfs in corpora.items():
        queue, rows = _ladder_rows(wfs, policies, node_mib, train_frac, max_tasks_per_type, min_executions, kcfg,
                                   max_attempts, ladder_x64, dev)
        meta[cname] = (queue, rows)
        for p in policies:
            for nn in node_counts:
                lane_rows.append(rows[p][:4])
                lane_nodes.append(int(nn))
                lane_keys.append((cname, p, int(nn)))
    node_s, start_s, _, _, dead = sweep_schedule(
        lane_rows, lane_nodes, [node_mib + 1e-6] * len(lane_rows), stats=stats, device=dev
    )
    results: dict[tuple[str, str, int], ClusterResult] = {}
    for s, (cname, p, nn) in enumerate(lane_keys):
        queue, rows = meta[cname]
        bnd_rows, val_rows, run_rows, probe_rows, counts, waste = rows[p]
        stats["rows"] += len(run_rows)
        if dead[s]:
            node, start, end = _place_rows_batched(
                bnd_rows, val_rows, run_rows, probe_rows, nn, node_mib, placement_window, stats, device=dev
            )
        else:
            r = len(run_rows)
            node, start = node_s[s, :r], start_s[s, :r]
            end = start + run_rows
        results[(cname, p, nn)] = _policy_result(p, queue, counts, waste, node, start, end)
    if placement_stats is not None:
        _merge_stats(placement_stats, stats)
    return results


def pareto_frontier(points) -> np.ndarray:
    """Boolean mask of the non-dominated rows of ``points`` (minimize every
    column): row i is kept unless some row is <= it everywhere and < it
    somewhere.  Ties keep both rows."""
    pts = np.asarray(points, dtype=float)
    if pts.ndim != 2:
        raise ValueError(f"points must be 2-D, got shape {pts.shape}")
    keep = np.ones(len(pts), dtype=bool)
    for i in range(len(pts)):
        dom = (pts <= pts[i]).all(axis=1) & (pts < pts[i]).any(axis=1)
        keep[i] = not dom.any()
    return keep
