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

Port of the scalar oracle of ``repro.serve.admission``
(``AdmissionController``: one ``demand_exceeds`` probe per candidate against
a profile rebuilt from the active set whenever it changes), on the port's
host model (``core.ksegments.KSegmentsModel``) and timeline
(``core.timeline``), float64 numpy throughout: its decisions are the
reference's, exactly.  The batched and sharded controllers wait for a later
slice (ROADMAP Queue 1 item 6).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.allocation import StepAllocation, pack_step_allocations
from repro_torch.core.ksegments import KSegmentsConfig, KSegmentsModel
from repro_torch.core.timeline import demand_exceeds, step_demand_profile


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
    """State and accounting of the admission controllers."""

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
