"""Dispatch of the kernels by the tensors' device.

A CUDA tensor goes to the hand-written kernel (or the call raises); a CPU
tensor goes to the plain PyTorch version.  segmax and wastage serve the
evaluation engine (wastage runs whole retry ladders), rangemax (with the
running sums before it) and compaction (with the sweep's fold around it)
the cluster's placement programs, fitstats the kernels API's regression
bank (``kernels.api``), flash the language model's attention, scan the
engine's predict phase (every running sum of it, in the reference's
order), admission the batched admission controller's decision scan,
admission_epoch the sharded controller's whole carried epoch,
moe_dispatch and moe_combine the routed experts of an MoE layer,
rwkv_wkv the WKV recurrence of an rwkv layer's time mix and rglru_scan the
affine recurrence of an rglru layer.  Rows of
segmax and wastage index series: row r reads ``y[series[r]]``, so rows
that share a series (the methods of one execution, the k values of a
sweep) never copy it on the card.
"""

from __future__ import annotations

import torch

from repro_torch.core.allocation import attempt_outcomes_batch
from repro_torch.core.segmentation import segment_peaks_dynamic
from repro_torch.kernels import admission, compaction, fitstats, flash, rangemax, scan, segmax, wastage
from repro_torch.kernels import admission_epoch as epoch
from repro_torch.kernels import moe_combine as combine
from repro_torch.kernels import moe_dispatch as dispatch
from repro_torch.kernels import rglru_scan as lru
from repro_torch.kernels import rwkv_wkv as wkv


def _route(y: torch.Tensor) -> bool:
    """True for the kernel, False for the plain version."""
    if y.device.type == "cuda":
        return True
    if y.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {y.device}")


def segment_peaks(
    y: torch.Tensor, lengths: torch.Tensor, series: torch.Tensor, k_eff: torch.Tensor, k_max: int
) -> torch.Tensor:
    """Segment peaks of rows ``y[series]`` with per-row ``k_eff`` -> (R, k_max)."""
    if _route(y):
        return segmax.segmax_cuda(y, lengths, series, k_eff, k_max)
    return segment_peaks_dynamic(y[series], lengths[series], k_eff, k_max)


def attempt_wastage(
    y: torch.Tensor,
    lengths: torch.Tensor,
    series: torch.Tensor,
    bounds: torch.Tensor,
    values: torch.Tensor,
    interval_s: float,
    acc_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Score attempt rows on ``y[series]`` -> (waste GiB*s (R,) summed in
    ``acc_dtype``, fail index (R,), -1 on success)."""
    if _route(y):
        return wastage.wastage_cuda(y, lengths, series, bounds, values, interval_s, acc_dtype)
    return attempt_outcomes_batch(y[series], lengths[series], interval_s, bounds, values, acc_dtype)


def replay_ladder(y, lengths, series, bounds, values, k_eff, selective, cap_jump, *, interval_s, factor, cap_mib,
                  max_attempts=None, acc_dtype=None):
    """Every (lane, execution, method) row's whole retry ladder: one launch
    on the card, rounds of ``attempt_outcomes_batch`` on the CPU (arguments
    and results as ``wastage.replay_ladder_plain``)."""
    replay = wastage.replay_ladder_cuda if _route(y) else wastage.replay_ladder_plain
    return replay(y, lengths, series, bounds, values, k_eff, selective, cap_jump, interval_s=interval_s,
                  factor=factor, cap_mib=cap_mib, max_attempts=max_attempts, acc_dtype=acc_dtype)


def prefix_sum(a: torch.Tensor, dim: int = -1, block: int = scan.XLA_SCAN_BLOCK) -> torch.Tensor:
    """Inclusive prefix sum of ``a`` along ``dim`` in ``scan.cumsum``'s order
    (``block >= n``: one sequential fold; 16: XLA's CPU order): one launch
    on the card."""
    if _route(a):
        return scan.scan_cuda(a, dim, block)
    return scan.prefix_sum_plain(a, dim, block)


def range_max_table(x: torch.Tensor) -> torch.Tensor:
    """(B, L) rows -> (B, P, L) doubling range-max levels,
    ``out[:, p, i] = max(x[:, i : i + 2**p])`` (-inf past the row end)."""
    if _route(x):
        return rangemax.rangemax_cuda(x)
    return rangemax.table_levels(x)


def fit_tables(tl_t: torch.Tensor, tl_d: torch.Tensor, base0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(N, L) sorted event times and deltas, (N,) base demands -> (csm (N,
    L) the running demand masked to -inf off tie-group-final events, tbl
    (N, P, L) its doubling range-max levels): one launch on the card."""
    if _route(tl_d):
        return rangemax.fit_tables_cuda(tl_t, tl_d, base0)
    return rangemax.fit_tables_plain(tl_t, tl_d, base0)


def compact_events(t: torch.Tensor, d: torch.Tensor, keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(B, L) sorted event rows and a bool keep mask -> the kept entries
    moved to the front in order, ``(+inf, 0)`` behind."""
    if _route(t):
        return compaction.compaction_cuda(t, d, keep)
    return compaction.compact_events_plain(t, d, keep)


def fold_compact(t: torch.Tensor, d: torch.Tensor, base: torch.Tensor, now: torch.Tensor, n_nodes: int):
    """The sweep's chunk-boundary fold of (R, L) node event rows, node
    ``r % n_nodes`` of lane ``r // n_nodes`` at clock ``now`` (R / n_nodes,)
    -> (base, t, d, csm, kept) as ``compaction.fold_compact_plain``: one
    launch on the card."""
    if _route(t):
        return compaction.fold_compact_cuda(t, d, base, now, n_nodes)
    return compaction.fold_compact_plain(t, d, base, now, n_nodes)


def fit_stats(x: torch.Tensor, peaks: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """x (B,), peaks (B, k), valid (B,) weights, float32 -> the (k, 5) bank
    ``(n, Σx, Σx², Σy, Σxy)``, every row weighted by ``valid``."""
    if _route(peaks):
        return fitstats.fitstats_cuda(x, peaks, valid)
    return fitstats.fit_stats_plain(x, peaks, valid)


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    *,
    causal: bool,
    window: int | None,
    softcap: float | None,
) -> torch.Tensor:
    """Attention of q (B, T, H, hd) over k, v (B, S, KV, hd) by position:
    q_pos (B, T), k_pos (B, S) int32, -1 marks empty slots."""
    if _route(q):
        return flash.flash_attention_cuda(q, k, v, q_pos, k_pos, causal=causal, window=window, softcap=softcap)
    return flash.flash_attention_plain(q, k, v, q_pos, k_pos, causal=causal, window=window, softcap=softcap)


def admission_scan(P, prof, starts, ends, rels, bnd, val, valext, sw, live, valid, budget: float) -> torch.Tensor:
    """Decide C admission candidates in order against the profile read
    ``prof`` at the probes ``P`` and the budget -> admits (C,) bool
    (arguments as ``sim.device_timeline.admission_scan_plain``): one launch
    on the card."""
    if _route(P):
        return admission.admission_cuda(P, prof, starts, ends, rels, bnd, val, valext, sw, live, valid, budget)
    # imported here: device_timeline imports this module
    from repro_torch.sim.device_timeline import admission_scan_plain

    return admission_scan_plain(P, prof, starts, ends, rels, bnd, val, valext, sw, live, valid, budget)


def admission_epoch(base0, tl_t, tl_d, tl_c, slot_fold, rel_codes, starts, ends, rels, bnd, val, codes, valid,
                    t0: float, budget: float, Lp: int | None = None, out=None):
    """One batch of the sharded controller's carried epoch for every shard
    (releases, clock fold, decisions, splice; arguments as
    ``sim.device_timeline.admission_epoch_plain``) -> ``(res, base0, tl_t,
    tl_d, tl_c, slot_fold)``, res (S, Cb + 2) int32 each shard's admits,
    overflow flag and live count: one launch on the card, into the state
    buffers ``out`` (the CPU route returns new tensors)."""
    if _route(tl_t):
        return epoch.admission_epoch_cuda(base0, tl_t, tl_d, tl_c, slot_fold, rel_codes, starts, ends, rels, bnd,
                                          val, codes, valid, t0, budget, Lp, out)
    from repro_torch.sim.device_timeline import admission_epoch_plain

    admits, overflow, n_live, *state = admission_epoch_plain(base0, tl_t, tl_d, tl_c, slot_fold, rel_codes, starts,
                                                             ends, rels, bnd, val, codes, valid, t0, budget, Lp)
    res = torch.cat([admits.to(torch.int32), overflow[:, None].to(torch.int32), n_live[:, None].to(torch.int32)], 1)
    return (res, *state)


def moe_dispatch(xf: torch.Tensor, ids: torch.Tensor, E: int, C: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Rows xf (N, D) into the expert buffer by ids (N, k) int32 -> (buf (E,
    C, D), pos (N, k) int32), as ``moe_dispatch.moe_dispatch_plain``: one
    launch on the card."""
    if _route(xf):
        return dispatch.moe_dispatch_cuda(xf, ids, E, C)
    return dispatch.moe_dispatch_plain(xf, ids, E, C)


def moe_combine(out_buf: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """The experts' rows out_buf (E, C, D) weighted back into their tokens
    -> (N, D), as ``moe_combine.moe_combine_plain``: one launch on the
    card."""
    if _route(out_buf):
        return combine.moe_combine_cuda(out_buf, ids, pos, weights)
    return combine.moe_combine_plain(out_buf, ids, pos, weights)


def rwkv_wkv(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor, u: torch.Tensor,
             S0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The WKV recurrence of RWKV-6 heads: r, k, v, logw (B, T, H, 64) f32,
    u (H, 64), S0 (B, H, 64, 64) f32 -> (o (B, T, H, 64), S), as
    ``rwkv_wkv.wkv_plain``: one launch on the card, any T."""
    if _route(r):
        return wkv.rwkv_wkv_cuda(r, k, v, logw, u, S0)
    return wkv.wkv_plain(r, k, v, logw, u, S0)


def rglru_scan(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``h_t = a_t h_{t-1} + b_t`` over a, b (B, T, R) f32 from h0 (B, R) ->
    (h_seq (B, T, R), h_last (B, R)), as ``rglru_scan.rglru_scan_plain``:
    one launch on the card, bit for bit."""
    if _route(a):
        return lru.rglru_scan_cuda(a, b, h0)
    return lru.rglru_scan_plain(a, b, h0)


_KERNELS = {
    "segmax": segmax,
    "wastage": wastage,
    "rangemax": rangemax,
    "compaction": compaction,
    "fitstats": fitstats,
    "flash": flash,
    "scan": scan,
    "admission": admission,
    "admission_epoch": epoch,
    "moe_dispatch": dispatch,
    "moe_combine": combine,
    "rwkv_wkv": wkv,
    "rglru_scan": lru,
}


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel."""
    return {name: mod.launches for name, mod in _KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in _KERNELS.values():
        mod.launches = 0
