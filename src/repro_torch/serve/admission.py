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
  one model shared by all.  The carried-timeline
  ``ShardedAdmissionController`` it is the oracle of is ROADMAP Queue 1
  item 6(c).
"""

from __future__ import annotations

import dataclasses
import zlib

import numpy as np
import torch

from repro_torch.core.allocation import StepAllocation, pack_step_allocations
from repro_torch.core.ksegments import KSegmentsConfig, KSegmentsModel
from repro_torch.core.timeline import Timeline, demand_exceeds, shared_probe_set, step_demand_profile
from repro_torch.device import resolve_device
from repro_torch.kernels import ops

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
