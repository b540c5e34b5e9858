"""Beyond-paper application of k-Segments: HBM admission control for decoding.

A decode request's device-memory footprint grows monotonically with its KV
cache: the shape the paper's monotone step function (Eq. 1) models.
Treating "serve one request" as a workflow task whose input size is the
prompt length, the k-Segments predictor learns (runtime, per-segment peak
HBM) online from finished requests, and the admission controller packs
requests against the HBM budget *segment-wise*: a new request is admitted if
the *sum of concurrent step functions* stays under budget at every future
boundary, instead of reserving every request's worst-case peak at admission
(the static baseline).  Wastage here = reserved-but-unused HBM x seconds,
the paper's metric applied to serving.

Port of ``repro.serve.admission``, on the port's host model
(``core.ksegments.KSegmentsModel``) and timeline (``core.timeline``); every
controller decides exactly as its reference twin:

* ``AdmissionController``, the sequential oracle: one ``demand_exceeds``
  probe per candidate against a profile rebuilt from the active set
  whenever it changes (float64 numpy).
* ``BatchedAdmissionController``: the active plans live in an incremental
  event ``Timeline``, and a batch of at least ``device_min_batch``
  candidates is decided in one call of ``kernels.ops.admission_scan``
  (one launch of the admission kernel on the card) against the profile
  read at a shared deduped probe set; smaller batches take the oracle's
  probe against the same timeline.  Within a batch an admitted candidate's
  demand is visible to every later one, in the scalar controller's order.
  The shared probe set also holds the other candidates' switch instants,
  which can see a step-up the scalar probe misses (ROADMAP Queue 3), so
  on rare streams the two depart, exactly as the reference's do.
* ``ShardedScalarController``: ``n_shards`` scalar controllers, each with
  ``budget / n_shards``, requests placed by ``shard_of`` (crc32 of the id),
  one model shared by all.
* ``ShardedAdmissionController``: the same shards and placement, each
  shard's demand timeline carried on the device across batches; a batch
  is one call of ``kernels.ops.admission_epoch`` (one launch of the
  admission_epoch kernel on the card, a block per shard) that applies the
  queued releases, folds the clock forward, decides the batch and splices
  the admitted plans in.  Its oracle is ``ShardedScalarController``.
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.core.allocation import StepAllocation, pack_step_allocations
from repro_torch.core.ksegments import KSegmentsConfig, KSegmentsModel
from repro_torch.core.timeline import (
    Timeline,
    demand_exceeds,
    plan_profile_events,
    shared_probe_set,
    step_demand_profile,
)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.sim.traces import bucket_size, fine_bucket

# The reference's second name for the timeline, kept for callers of the
# controllers' internals.
IncrementalDemandProfile = Timeline


@dataclasses.dataclass
class RequestPlan:
    request_id: str
    admitted_at: float
    alloc: StepAllocation  # MiB over seconds since admission


def cache_bytes_per_token(cfg) -> int:
    """KV-cache bytes per decoded token (attention layers only).

    Counts every attention-bearing layer kind (dense / local / global / moe;
    the tests hold it against the bytes of ``models.init_cache``); recurrent
    kinds (rwkv / rglru) carry O(1) state and contribute nothing per token."""
    dt = 2 if cfg.dtype == "bfloat16" else 4
    n_attn = sum(1 for k in cfg.layer_kinds if k in ("dense", "local", "global", "moe"))
    return n_attn * 2 * cfg.num_kv_heads * cfg.head_dim * dt


class _AdmissionBase:
    """State and accounting shared by the admission controllers."""

    def __init__(self, hbm_budget_mib: float, k: int = 4, interval_s: float = 0.5):
        self.budget = float(hbm_budget_mib)
        self.model = KSegmentsModel(KSegmentsConfig(k=k, interval_s=interval_s, floor_mib=1.0))
        self.active: dict[str, RequestPlan] = {}
        self._static_reserved = 0.0  # what peak-reservation would hold (baseline)

    # -- learning ----------------------------------------------------------

    def observe(self, prompt_len: int, hbm_series_mib: np.ndarray) -> None:
        """Fold a finished request's memory-over-time into the model."""
        self.model.observe(float(prompt_len), np.asarray(hbm_series_mib))

    # -- accounting ---------------------------------------------------------

    def reservation_wastage(self, plans: list[tuple[RequestPlan, np.ndarray, float]]) -> dict:
        """Compare segment-wise vs peak-at-admission reservation wastage.

        plans: (plan, actual hbm series MiB, interval) per finished request.
        Returns GiB*s wasted under both policies (the Fig. 7a metric applied
        to serving)."""
        seg, peak = 0.0, 0.0
        for plan, series, interval in plans:
            t = (np.arange(len(series)) + 0.5) * interval
            a = plan.alloc.at(t)
            seg += float(np.sum(np.maximum(a - series, 0.0)) * interval) / 1024.0
            peak += float(np.sum(np.maximum(plan.alloc.values[-1] - series, 0.0)) * interval) / 1024.0
        return {"segmentwise_gib_s": seg, "peak_reservation_gib_s": peak}

    def _default_alloc(self) -> StepAllocation:
        """Before any observation the model has no fit: admit against a flat
        5%-of-budget placeholder reservation."""
        return StepAllocation(np.asarray([1.0]), np.asarray([self.budget * 0.05]))


class AdmissionController(_AdmissionBase):
    """Online segment-wise HBM packing for a decode engine (scalar oracle)."""

    def __init__(self, hbm_budget_mib: float, k: int = 4, interval_s: float = 0.5):
        super().__init__(hbm_budget_mib, k, interval_s)
        self._prof: tuple | None = None  # cached demand profile; dropped on admit/release

    # -- admission ----------------------------------------------------------

    def _profile(self) -> tuple[np.ndarray, np.ndarray]:
        """Active plans' total demand as a cumulative step profile (event
        times, running sum) — ``core.allocation.step_demand_profile``, shared
        with the cluster simulator's ``NodeState``, so admission stays
        O(P k log) per request instead of re-summing every plan at every
        probe.  A plan holds through its final boundary inclusive (the
        paper's Eq. 1 domain [0, r_e]) and releases just after, hence the
        ``nextafter`` release times."""
        if self._prof is None:
            plans = list(self.active.values())
            bnd, val = pack_step_allocations([p.alloc for p in plans])
            starts = np.asarray([p.admitted_at for p in plans])
            releases = np.asarray(
                [np.nextafter(p.admitted_at + float(p.alloc.boundaries[-1]), np.inf) for p in plans]
            )
            self._prof = step_demand_profile(bnd, val, starts, releases)
        return self._prof

    def _combined_demand(self, horizon: tuple[float, ...]) -> np.ndarray:
        """Total predicted MiB demand of active requests at absolute times.

        A request's reservation covers its predicted lifetime [0, r_e] (the
        paper's Eq. 1 domain): past its final boundary it is expected to have
        released — that expiry is what lets staggered admissions overlap a
        newcomer's cheap early segments with a leader's remaining window.
        (Requests that outlive r_e are the retry/preemption path.)"""
        times, cum = self._profile()
        return cum[np.searchsorted(times, np.asarray(horizon), side="right")]

    def try_admit(self, request_id: str, prompt_len: int, now: float) -> RequestPlan | None:
        """Admit if the segment-wise demand fits the budget at every point
        where it can rise during the newcomer's reservation window.

        The probe horizon is the union of the newcomer's boundaries and every
        *active* plan's future switch points (as ``NodeState.fits`` checks in
        the cluster simulator): an active request stepping up between two of
        the newcomer's boundaries would otherwise push combined demand over
        budget undetected.  Steps are right-open (Eq. 1), so switch points are
        probed just after the boundary, where the higher value applies."""
        if self.model.n_observations == 0:
            alloc = self._default_alloc()
        else:
            alloc = self.model.predict(float(prompt_len))
        times, cum = self._profile()
        end = now + float(alloc.boundaries[-1])
        # inclusive end: a plan holds through its final boundary (Eq. 1
        # domain [0, r_e]), unlike a cluster reservation's right-open window.
        if demand_exceeds(times, cum, alloc, now, end, self.budget, inclusive_end=True):
            return None
        plan = RequestPlan(request_id, now, alloc)
        self.active[request_id] = plan
        self._static_reserved += float(alloc.values[-1])
        self._prof = None
        return plan

    def release(self, request_id: str) -> None:
        plan = self.active.pop(request_id, None)
        if plan is not None:
            self._static_reserved -= float(plan.alloc.values[-1])
            self._prof = None


# ---------------------------------------------------------------------------
# Batched admission engine
# ---------------------------------------------------------------------------


class BatchedAdmissionController(_AdmissionBase):
    """Batched twin of ``AdmissionController``: the same decisions, with the
    active plans in an incremental ``Timeline`` and a whole batch of
    candidates decided in one device call (``try_admit_many``), sequential
    inside the batch.  ``try_admit`` is the batch of one, so the two
    controllers are interchangeable.  ``device=None`` is the CUDA card."""

    def __init__(
        self,
        hbm_budget_mib: float,
        k: int = 4,
        interval_s: float = 0.5,
        device_min_batch: int = 32,
        device=None,
    ):
        super().__init__(hbm_budget_mib, k, interval_s)
        self.device = resolve_device(device)
        self._prof = IncrementalDemandProfile()
        # Below this batch size the device call costs more than the probes it
        # batches; the host path runs the oracle's ``demand_exceeds`` against
        # the same timeline, with the same decisions.
        self.device_min_batch = int(device_min_batch)

    # -- admission ----------------------------------------------------------

    def try_admit(self, request_id: str, prompt_len: int, now: float) -> RequestPlan | None:
        """One candidate: the oracle's probe against the incremental
        timeline, with no rebuild and no device call."""
        if self.model.n_observations == 0:
            alloc = self._default_alloc()
        else:
            alloc = self.model.predict(float(prompt_len))
        self._prof.expire(float(now))
        times, cum = self._prof.arrays()
        end = now + float(alloc.boundaries[-1])
        if demand_exceeds(times, cum, alloc, now, end, self.budget, inclusive_end=True):
            return None
        return self._commit(request_id, alloc, float(now), float(np.nextafter(end, np.inf)))

    def try_admit_many(self, request_ids: list[str], prompt_lens, now) -> list[RequestPlan | None]:
        """Decide a batch of candidates in arrival order.

        ``now`` is a scalar (all candidates share the clock) or a
        non-decreasing (C,) array of arrival times.  Candidate i is probed
        against the active profile plus every candidate j < i admitted in
        this call."""
        C = len(request_ids)
        if C == 0:
            return []
        if C == 1:
            t = now if np.ndim(now) == 0 else float(np.asarray(now)[0])
            return [self.try_admit(request_ids[0], prompt_lens[0], t)]
        if self.model.n_observations == 0:
            d = self._default_alloc()
            bnd = np.tile(d.boundaries, (C, 1))
            val = np.tile(d.values, (C, 1))
        else:
            bnd, val = self.model.predict_batch(np.asarray(prompt_lens, dtype=np.float64))
        starts = np.broadcast_to(np.asarray(now, dtype=np.float64), (C,)).astype(np.float64)
        ends = starts + bnd[:, -1]
        rels = np.nextafter(ends, np.inf)  # a plan holds through r_e inclusive
        self._prof.expire(float(starts[0]))
        if C < self.device_min_batch:
            return self._admit_host(request_ids, bnd, val, starts, ends, rels)
        return self._admit_device(request_ids, bnd, val, starts, ends, rels)

    def _admit_host(self, request_ids, bnd, val, starts, ends, rels):
        """Small batches: the oracle's probe against the timeline, committing
        each admitted plan before the next candidate is probed."""
        plans: list[RequestPlan | None] = []
        for i, rid in enumerate(request_ids):
            alloc = StepAllocation(bnd[i], val[i])
            times, cum = self._prof.arrays()
            if demand_exceeds(
                times, cum, alloc, float(starts[i]), float(ends[i]), self.budget, inclusive_end=True
            ):
                plans.append(None)
                continue
            plans.append(self._commit(rid, alloc, float(starts[i]), float(rels[i])))
        return plans

    def _commit(self, rid: str, alloc: StepAllocation, start: float, release: float) -> RequestPlan:
        # the timeline first: add() checks the owner before it changes
        # anything, so re-admitting a live id raises with the state clean
        self._prof.add(rid, alloc.boundaries, alloc.values, start, release)
        plan = RequestPlan(rid, start, alloc)
        self.active[rid] = plan
        self._static_reserved += float(alloc.values[-1])
        return plan

    def _admit_device(self, request_ids, bnd, val, starts, ends, rels):
        """One device call for the batch.  The host builds the shared probe
        set (the profile's events and every candidate's start and switch
        instants, deduped) and reads the profile at it; the arrays go up in
        two copies (float64, bool), the decision scan runs once, and the
        admits come back.  The kernel takes any probe and candidate count,
        so nothing is padded (the reference pads to bound its compiled
        shapes)."""
        C = len(request_ids)
        sw = np.nextafter(starts[:, None] + bnd, np.inf)  # switch instants (right-open steps)
        live = np.isfinite(bnd) & (starts[:, None] + bnd < rels[:, None])
        valext = np.concatenate([val, val[:, -1:]], axis=1)  # hold-last (C, k + 1)
        times, _ = self._prof.arrays()
        P = shared_probe_set(times, starts, sw.ravel())
        Pp, k = len(P), bnd.shape[1]
        pieces = (
            (P, (Pp,)),
            (self._prof.demand_at(P), (Pp,)),
            (starts, (C,)),
            (ends, (C,)),
            (rels, (C,)),
            (bnd, (C, k)),
            (val, (C, k)),
            (valext, (C, k + 1)),
            (sw, (C, k)),
        )
        f64 = torch.from_numpy(np.concatenate([np.ravel(a) for a, _ in pieces])).to(self.device)
        f64 = [t.view(shape) for t, (_, shape) in zip(torch.split(f64, [a.size for a, _ in pieces]), pieces)]
        flags = np.concatenate([live.ravel(), np.ones(C, dtype=bool)])
        live_t, valid_t = torch.split(torch.from_numpy(flags).to(self.device), [C * k, C])
        admits = ops.admission_scan(*f64, live_t.view(C, k), valid_t, self.budget)
        admits = admits.cpu().numpy()

        adm = np.flatnonzero(admits)
        if len(adm):
            # the timeline first: add_many checks owners before it changes
            # anything, so a duplicate id aborts with the state clean
            self._prof.add_many([request_ids[i] for i in adm], bnd[adm], val[adm], starts[adm], rels[adm])
        plans: list[RequestPlan | None] = []
        for i, rid in enumerate(request_ids):
            if admits[i]:
                plan = RequestPlan(rid, float(starts[i]), StepAllocation(bnd[i], val[i]))
                self.active[rid] = plan
                self._static_reserved += float(val[i, -1])
                plans.append(plan)
            else:
                plans.append(None)
        return plans

    def release(self, request_id: str) -> None:
        plan = self.active.pop(request_id, None)
        if plan is not None:
            self._static_reserved -= float(plan.alloc.values[-1])
            self._prof.remove(request_id)


# ---------------------------------------------------------------------------
# Sharded admission: the per-shard oracle
# ---------------------------------------------------------------------------


def shard_of(request_id: str, n_shards: int) -> int:
    """Deterministic request -> shard placement: crc32 of the id (Python's
    ``hash`` is salted per process), so every per-shard decision sequence
    is a function of the request ids."""
    return zlib.crc32(str(request_id).encode()) % int(n_shards)


class ShardedScalarController(_AdmissionBase):
    """``n_shards`` independent scalar controllers, each owning ``budget /
    n_shards``; requests route by ``shard_of`` and all shards share ONE
    k-Segments model (predictions are global, only admission state is
    sharded)."""

    def __init__(self, hbm_budget_mib: float, k: int = 4, interval_s: float = 0.5, n_shards: int = 4):
        super().__init__(hbm_budget_mib, k, interval_s)
        self.n_shards = int(n_shards)
        self.shard_budget = self.budget / self.n_shards
        self._shards = [AdmissionController(self.shard_budget, k, interval_s) for _ in range(self.n_shards)]
        for c in self._shards:
            c.model = self.model  # one shared predictor across shards

    def shard_of(self, request_id: str) -> int:
        return shard_of(request_id, self.n_shards)

    def try_admit(self, request_id: str, prompt_len: int, now: float) -> RequestPlan | None:
        plan = self._shards[self.shard_of(request_id)].try_admit(request_id, prompt_len, now)
        if plan is not None:
            self.active[request_id] = plan
            self._static_reserved += float(plan.alloc.values[-1])
        return plan

    def try_admit_many(self, request_ids, prompt_lens, now) -> list[RequestPlan | None]:
        ts = np.broadcast_to(np.asarray(now, dtype=np.float64), (len(request_ids),))
        return [self.try_admit(r, p, float(t)) for r, p, t in zip(request_ids, prompt_lens, ts)]

    def release(self, request_id: str) -> None:
        plan = self.active.pop(request_id, None)
        if plan is not None:
            self._static_reserved -= float(plan.alloc.values[-1])
            self._shards[self.shard_of(request_id)].release(request_id)


# ---------------------------------------------------------------------------
# Sharded admission on carried timelines
# ---------------------------------------------------------------------------


class ShardedAdmissionController(_AdmissionBase):
    """Sharded admission on carried device timelines: the serving control
    plane that lives across thousands of decision batches.

    The placement and per-shard policy of ``ShardedScalarController``, with
    the same decisions, but nothing is rebuilt per batch: each shard's
    demand timeline (sorted event times, deltas and owner codes), its
    clock-folded base and its per-owner fold sums persist as tensors on the
    controller's device between calls, and one ``ops.admission_epoch`` call
    (one launch of the admission_epoch kernel on the card, a block per
    shard) applies the queued releases, folds the clock forward, decides
    the whole batch and splices the admitted plans in, for every shard at
    once.  The new state goes into a second set of buffers, and the two
    sets swap after the call.

    Host bookkeeping is O(batch): a free list of per-shard owner codes
    (recycled only after a release is applied on the device), the pending
    releases, and capacity: the timeline axis L grows by padding (+inf
    keeps it sorted) from the device-reported live-event count before a
    batch could overflow, so the program's overflow flag is a guard that
    should never fire; when it does, the state is rebuilt from the active
    plans at the clock and the batch replayed (counted in ``reseeds``).

    The batch clock must not decrease across calls (folded events never
    come back); a regressing clock raises.  ``device=None`` is the CUDA
    card.  The reference's ``use_shard_map`` (shards spread over devices)
    has no counterpart: the port runs on one card, the shards as the
    kernel's grid."""

    def __init__(self, hbm_budget_mib: float, k: int = 4, interval_s: float = 0.5, n_shards: int = 4,
                 device=None):
        super().__init__(hbm_budget_mib, k, interval_s)
        self.device = resolve_device(device)
        self.n_shards = int(n_shards)
        self.shard_budget = self.budget / self.n_shards
        self._state = None  # (base0, tl_t, tl_d, tl_c, slot_fold) on the device
        self._spare = None  # the buffers the next epoch writes its state into
        self._L = 64  # per-shard timeline axis (grows by padding)
        self._Smax = 64  # per-shard owner-code capacity (grows by padding)
        self._free: list[list[int]] = [[] for _ in range(self.n_shards)]
        self._next_slot = [0] * self.n_shards
        self._pending_rel: list[list[int]] = [[] for _ in range(self.n_shards)]
        self._code: dict[str, tuple[int, int]] = {}  # rid -> (shard, code)
        self._evtimes: dict[str, np.ndarray] = {}  # rid -> event-time row (nan padded)
        # event-time rows of queued releases: counted at the next batch,
        # against the clock they were released under
        self._pend_times: list[list[np.ndarray]] = [[] for _ in range(self.n_shards)]
        self._n_live = np.zeros(self.n_shards, dtype=np.int64)
        self._clock = -np.inf
        self.reseeds = 0  # overflow-recovery reseeds (0 on healthy streams)

    # -- policy -------------------------------------------------------------

    def shard_of(self, request_id: str) -> int:
        return shard_of(request_id, self.n_shards)

    def _default_alloc(self) -> StepAllocation:
        # the placeholder scales with the shard's budget: each shard's oracle
        # is a scalar controller over budget / n_shards
        return StepAllocation(np.asarray([1.0]), np.asarray([self.shard_budget * 0.05]))

    # -- device state ---------------------------------------------------------

    def _ensure_state(self):
        if self._state is None:
            S, L, Smax, dev = self.n_shards, self._L, self._Smax, self.device
            self._state = (
                torch.zeros(S, dtype=torch.float64, device=dev),
                torch.full((S, L), np.inf, dtype=torch.float64, device=dev),
                torch.zeros((S, L), dtype=torch.float64, device=dev),
                torch.full((S, L), -1, dtype=torch.int32, device=dev),
                torch.zeros((S, Smax), dtype=torch.float64, device=dev),
            )
            self._spare = tuple(torch.empty_like(t) for t in self._state)

    def _grow_L(self, new_L: int):
        pad = new_L - self._L

        def grown(state):
            base0, tl_t, tl_d, tl_c, slot_fold = state
            S = tl_t.shape[0]
            return (
                base0,
                torch.cat([tl_t, tl_t.new_full((S, pad), np.inf)], dim=1),
                torch.cat([tl_d, tl_d.new_zeros((S, pad))], dim=1),
                torch.cat([tl_c, tl_c.new_full((S, pad), -1)], dim=1),
                slot_fold,
            )

        self._state, self._spare = grown(self._state), grown(self._spare)
        self._L = new_L

    def _grow_smax(self, new_smax: int):
        pad = new_smax - self._Smax

        def grown(state):
            *rest, slot_fold = state
            return (*rest, torch.cat([slot_fold, slot_fold.new_zeros((slot_fold.shape[0], pad))], dim=1))

        self._state, self._spare = grown(self._state), grown(self._spare)
        self._Smax = new_smax

    def _alloc_code(self, s: int) -> int:
        if self._free[s]:
            return self._free[s].pop()
        if self._next_slot[s] >= self._Smax:
            self._ensure_state()
            self._grow_smax(fine_bucket(self._Smax + 1, floor=64))
        code = self._next_slot[s]
        self._next_slot[s] += 1
        return code

    def _reseed(self, t0: float):
        """Rebuild the carried state from the host plan set at ``t0``: the
        recovery path for an in-program overflow."""
        S, L, Smax = self.n_shards, self._L, self._Smax
        base0 = np.zeros(S)
        tl_t = np.full((S, L), np.inf)
        tl_d = np.zeros((S, L))
        tl_c = np.full((S, L), -1, np.int32)
        slot_fold = np.zeros((S, Smax))
        counts = np.zeros(S, dtype=np.int64)
        per: list[list] = [[] for _ in range(S)]
        for rid, plan in self.active.items():
            s, code = self._code[rid]
            rel = float(np.nextafter(plan.admitted_at + float(plan.alloc.boundaries[-1]), np.inf))
            t, d = plan_profile_events(plan.alloc.boundaries, plan.alloc.values, plan.admitted_at, rel)
            per[s].append((t, d, np.full(len(t), code, dtype=np.int32)))
        for s in range(S):
            if not per[s]:
                continue
            t = np.concatenate([e[0] for e in per[s]])
            d = np.concatenate([e[1] for e in per[s]])
            c = np.concatenate([e[2] for e in per[s]])
            order = np.argsort(t, kind="stable")
            t, d, c = t[order], d[order], c[order]
            cut = int(np.searchsorted(t, t0, side="right"))
            if cut:
                base0[s] = np.cumsum(d[:cut])[-1]
                np.add.at(slot_fold[s], c[:cut], d[:cut])
            nf = len(t) - cut
            if nf > L:
                raise RuntimeError(f"reseed: {nf} live events for an axis of {L}")
            tl_t[s, :nf], tl_d[s, :nf], tl_c[s, :nf] = t[cut:], d[cut:], c[cut:]
            counts[s] = nf
        self._state = tuple(torch.from_numpy(a).to(self.device) for a in (base0, tl_t, tl_d, tl_c, slot_fold))
        self._spare = tuple(torch.empty_like(t) for t in self._state)
        self._n_live = counts
        # pending releases are already reflected (released ids left
        # ``active`` before this rebuild): their codes free at once
        for s in range(S):
            self._free[s].extend(self._pending_rel[s])
            self._pending_rel[s] = []
        self._pend_times = [[] for _ in range(S)]
        self.reseeds += 1

    def _upload(self, rel_p, st_p, en_p, rl_p, bnd_p, val_p, code_p, valid_p) -> tuple:
        """The batch on the device in two copies: the float64 arrays, and the
        int32 code arrays with the valid flags behind them as bytes."""
        floats = (st_p, en_p, rl_p, bnd_p, val_p)
        f64 = torch.from_numpy(np.concatenate([a.ravel() for a in floats])).to(self.device)
        at = np.cumsum([0] + [a.size for a in floats])
        st, en, rl, bnd, val = (f64[o:o + a.size].view(a.shape) for o, a in zip(at, floats))
        raw = torch.from_numpy(np.concatenate([rel_p.ravel().view(np.uint8), code_p.ravel().view(np.uint8),
                                               valid_p.ravel().view(np.uint8)])).to(self.device)
        n_rel, n_code = rel_p.nbytes, code_p.nbytes
        rel = raw[:n_rel].view(torch.int32).view(rel_p.shape)
        codes = raw[n_rel:n_rel + n_code].view(torch.int32).view(code_p.shape)
        valid = raw[n_rel + n_code:].view(torch.bool).view(valid_p.shape)
        return rel, st, en, rl, bnd, val, codes, valid

    def _epoch(self, rel, batch, t0: float, Lp: int | None):
        """One ``ops.admission_epoch`` call into the spare buffers; returns
        (admits (S, Cb) bool, overflow (S,), n_live (S,), new state) read
        back in one copy."""
        res, *state = ops.admission_epoch(*self._state, rel, *batch, t0, self.shard_budget, Lp, out=self._spare)
        res = res.cpu().numpy()
        Cb = res.shape[1] - 2
        return res[:, :Cb].astype(bool), res[:, Cb].astype(bool), res[:, Cb + 1], tuple(state)

    # -- admission ----------------------------------------------------------

    def try_admit(self, request_id: str, prompt_len: int, now: float) -> RequestPlan | None:
        return self.try_admit_many([request_id], [prompt_len], now)[0]

    def try_admit_many(self, request_ids, prompt_lens, now) -> list[RequestPlan | None]:
        """Decide a batch in arrival order: ``now`` a scalar or a
        non-decreasing (C,) array; the batch clock is its first element."""
        C = len(request_ids)
        if C == 0:
            return []
        if self.model.n_observations == 0:
            d = self._default_alloc()
            bnd = np.tile(d.boundaries, (C, 1))
            val = np.tile(d.values, (C, 1))
        else:
            bnd, val = self.model.predict_batch(np.asarray(prompt_lens, dtype=np.float64))
        starts = np.broadcast_to(np.asarray(now, dtype=np.float64), (C,)).astype(np.float64)
        t0 = float(starts[0])
        if t0 < self._clock:
            raise ValueError(f"batch clock regressed: {t0} < {self._clock} (folded events never return)")
        ends = starts + bnd[:, -1]
        rels = np.nextafter(ends, np.inf)  # a plan holds through r_e inclusive
        # the finite events a plan splices in (start, live switches, release),
        # nan where a switch never fires: at release, the entries still above
        # the clock tighten the decision prefix of the following batches
        sw_all = np.nextafter(starts[:, None] + bnd, np.inf)
        live_all = np.isfinite(bnd) & (starts[:, None] + bnd < rels[:, None])
        times_all = np.concatenate([starts[:, None], np.where(live_all, sw_all, np.nan), rels[:, None]], axis=1)
        S, k = self.n_shards, bnd.shape[1]
        shards = [self.shard_of(r) for r in request_ids]
        per: list[list[int]] = [[] for _ in range(S)]
        for i, s in enumerate(shards):
            per[s].append(i)
        self._ensure_state()
        codes = [self._alloc_code(s) for s in shards]
        # capacity: the worst case ignores the batch's own releases and folds,
        # so growth runs strictly ahead of any in-program overflow
        need = max(int(self._n_live[s]) + (k + 2) * len(per[s]) for s in range(S))
        if need > self._L:
            self._grow_L(fine_bucket(need, floor=64))
        # the decision prefix: the queued releases (whose events still above
        # the clock are counted exactly) and the fold only shrink the live
        # prefix below the last batch's n_live; nan pads compare False
        pend_ev = [int((np.stack(rows) > self._clock).sum()) if rows else 0 for rows in self._pend_times]
        Lp_need = max(int(self._n_live[s]) - pend_ev[s] for s in range(S))
        Lp = min(self._L, fine_bucket(max(Lp_need, 1), floor=64))
        Cb = fine_bucket(max(len(p) for p in per), floor=8)
        Rb = bucket_size(max(max(len(q) for q in self._pending_rel), 1), floor=8)
        st_p = np.full((S, Cb), np.inf)
        en_p = np.full((S, Cb), -np.inf)
        rl_p = np.full((S, Cb), -np.inf)
        bnd_p = np.full((S, Cb, k), np.inf)
        val_p = np.zeros((S, Cb, k))
        code_p = np.full((S, Cb), -1, dtype=np.int32)
        valid_p = np.zeros((S, Cb), dtype=bool)
        codes_np = np.asarray(codes, dtype=np.int32)
        for s in range(S):
            iv = per[s]
            n = len(iv)
            st_p[s, :n], en_p[s, :n], rl_p[s, :n] = starts[iv], ends[iv], rels[iv]
            bnd_p[s, :n], val_p[s, :n] = bnd[iv], val[iv]
            code_p[s, :n], valid_p[s, :n] = codes_np[iv], True
        rel_p = np.full((S, Rb), -1, dtype=np.int32)
        rel_lists, self._pending_rel = self._pending_rel, [[] for _ in range(S)]
        self._pend_times = [[] for _ in range(S)]
        for s in range(S):
            rel_p[s, : len(rel_lists[s])] = rel_lists[s]
        rel, *batch = self._upload(rel_p, st_p, en_p, rl_p, bnd_p, val_p, code_p, valid_p)
        admits, overflow, n_live, state = self._epoch(rel, batch, t0, Lp)
        if overflow.any():
            # the guard fired: rebuild from the host plan set (the queued
            # releases are already reflected there) and replay this batch
            # against the fresh state over the full axis
            self._grow_L(fine_bucket(2 * self._L + (k + 2) * C, floor=64))
            self._reseed(t0)
            rel_lists = [[] for _ in range(S)]
            admits, overflow, n_live, state = self._epoch(torch.full_like(rel, -1), batch, t0, None)
            if overflow.any():
                raise RuntimeError("admission epoch overflowed after a reseed")
        self._state, self._spare = state, self._state
        self._n_live = n_live.astype(np.int64)
        self._clock = t0
        for s in range(S):  # releases applied on the device: codes recycle now
            self._free[s].extend(rel_lists[s])
        plans: list[RequestPlan | None] = []
        pos = [0] * S
        for i, rid in enumerate(request_ids):
            s = shards[i]
            j = pos[s]
            pos[s] += 1
            if admits[s, j]:
                plan = RequestPlan(rid, float(starts[i]), StepAllocation(bnd[i], val[i]))
                self.active[rid] = plan
                self._static_reserved += float(val[i, -1])
                self._code[rid] = (s, codes[i])
                self._evtimes[rid] = times_all[i]
                plans.append(plan)
            else:
                self._free[s].append(codes[i])  # rejected: the code never went live
                plans.append(None)
        return plans

    def release(self, request_id: str) -> None:
        plan = self.active.pop(request_id, None)
        if plan is None:
            return
        self._static_reserved -= float(plan.alloc.values[-1])
        s, code = self._code.pop(request_id)
        # the code stays reserved until the release is applied on the device:
        # recycling it earlier would let a newcomer's events alias a plan
        # still spliced into the carried timeline
        self._pending_rel[s].append(code)
        # this plan's events still in the carried timeline are those above
        # the clock (the rest were folded at an earlier batch and are in
        # slot_fold); they are counted at the next batch, under this clock
        times = self._evtimes.pop(request_id, None)
        if times is not None:
            self._pend_times[s].append(times)
