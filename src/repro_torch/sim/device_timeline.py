"""The packing programs over the event timeline: the batched admission
controller's decision scan and the cluster scheduler's placement programs.

Port of ``repro.sim.device_timeline``.  ``admission_scan_plain`` decides
a batch of admission candidates in order, each against the profile plus the
demand of the candidates admitted before it (the reference's
``admission_program``); on the card that scan is one launch of the
**admission** kernel (``kernels.ops.admission_scan``).
``admission_epoch_plain`` is the sharded controller's carried epoch (the
reference's ``admission_epoch`` over ``_admission_shard``): releases, clock
fold, decisions and splice of one batch for every shard, on the card one
launch of the **admission_epoch** kernel (``kernels.ops.admission_epoch``).  The per-node demand timelines (sorted
event instants and deltas, ``core.timeline``) live on the device in
float64, as in the reference (``nextafter`` switch instants sit below
float32 resolution at cluster timestamps).  Three programs place rows:

* ``first_fit_window`` -- a window of rows at one fixed clock (nobody
  waits), over one probe set shared by all nodes (the reference's per-node
  variant decides the same and, run eagerly, launches ~k*N more ops per
  row, so it is not kept);
* ``schedule_epoch`` -- a few rows with the event clock and the release
  heap in the program's state: a row that fits no node pops pending
  completions, advances the clock and probes again.  Each row builds the
  range-max table of every node's demand (the **rangemax** kernel) and
  probes it with O(k log L) lookups;
* ``sweep_schedule`` -- every lane of a policy (x node count) design space
  end to end in one program.  Lanes are an explicit leading axis (the
  reference's ``vmap``); at every 8-row chunk boundary the carried
  timelines are folded at the clock and compacted to the events that change
  the running demand's bits (the **compaction** kernel's fold, one launch
  for all lanes x nodes).

The reference's ``lax.scan`` over rows becomes a host loop over rows, and
its ``while_loop`` of waits a host loop with one device-to-host read per
iteration; the state stays on the device.  Decisions are bit-identical to
the reference's: every comparison, ``nextafter``, gather and maximum is
exact, ties splice ``side="right"``, and the running sums add in the order
of XLA's CPU ``cumsum`` (``kernels.scan.xla_cumsum``) on the CPU and the card
alike, because compaction drops an event exactly when its delta leaves those
sums' bits unchanged.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from repro_torch.core.timeline import shared_probe_set
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.rangemax import masked_demand
from repro_torch.kernels.scan import xla_cumsum
from repro_torch.sim.traces import bucket_size, fine_bucket

F64 = torch.float64
_INF = float("inf")


def _t64(a, dev) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(dev)


def pad_rows(a: np.ndarray, n: int, fill: float) -> np.ndarray:
    """Pad axis 0 of ``a`` to ``n`` rows with ``fill`` (returns ``a``
    unchanged when already that size)."""
    if a.shape[0] == n:
        return a
    pad = np.full((n - a.shape[0], *a.shape[1:]), fill, dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def _first_true(mask: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Index of the first True along ``dim`` (0 when there is none), as the
    reference's ``argmax`` of a boolean mask picks the lowest index."""
    return torch.argmax(mask.to(torch.uint8), dim=dim)


# ---------------------------------------------------------------------------
# Shared per-(candidate, probe) demand pieces.
# ---------------------------------------------------------------------------


def candidate_probe_parts(P, starts, ends, rels, bnd, val, valext, sw, live, *, inclusive_end: bool):
    """Per-candidate demand pieces at a shared probe set (C candidates, Pp
    probes, k segments, float64): P (Pp,) +inf padded; starts/ends/rels
    (C,); bnd/val/sw/live (C, k); valext (C, k + 1).

    Returns (A, M, D), each (C, Pp): the candidate's own allocation at each
    probe, the membership mask of its window ([start, end] with
    ``inclusive_end``, else [start, end)), and its committed demand (its step
    value after the switches that fired, live on [start, release))."""
    k = bnd.shape[1]
    offs = P[None, :, None] - starts[:, None, None]
    idx = torch.clamp((bnd[:, None, :] < offs).sum(dim=-1), max=k - 1)
    A = torch.gather(val, 1, idx)
    below = (P[None, :] <= ends[:, None]) if inclusive_end else (P[None, :] < ends[:, None])
    M = (P[None, :] >= starts[:, None]) & below & torch.isfinite(P)[None, :]
    nst = (live[:, None, :] & (sw[:, None, :] <= P[None, :, None])).sum(dim=-1)
    inwin = (P[None, :] >= starts[:, None]) & (P[None, :] < rels[:, None])
    D = torch.where(inwin, torch.gather(valext, 1, nst), 0.0)
    return A, M, D


def admission_scan_plain(P, prof, starts, ends, rels, bnd, val, valext, sw, live, valid, budget: float):
    """Decide C admission candidates in order (plain version of the
    admission kernel; the reference's ``admission_program``).

    P (Pp,) probe instants, +inf padded; prof (Pp,) the profile read at
    them; starts/ends/rels/valid (C,); bnd/val/sw/live (C, k); valext (C,
    k + 1); all float64 but the bool ``live`` and ``valid``.  Candidate i
    is admitted when it is valid and ``prof + extra + A_i`` stays at or
    below ``budget`` at every probe of its window [start, end], where
    ``extra`` is the demand of the candidates admitted before it; an
    admitted candidate adds its own demand D_i to ``extra``.  Returns
    admits (C,) bool."""
    A, M, D = candidate_probe_parts(P, starts, ends, rels, bnd, val, valext, sw, live, inclusive_end=True)
    extra = torch.zeros_like(P)
    admits = torch.empty(valid.shape, dtype=torch.bool, device=P.device)
    for i in range(valid.shape[0]):
        admit = valid[i] & ~(M[i] & (prof + extra + A[i] > budget)).any()
        extra = extra + torch.where(admit, D[i], 0.0)
        admits[i] = admit
    return admits


# ---------------------------------------------------------------------------
# The carried-admission program: each shard's demand timeline lives in the
# sharded controller's state across batches; one call applies the queued
# releases, folds the clock forward, decides the batch and splices the
# admitted plans in.
# ---------------------------------------------------------------------------


def _scatter_add_in_order(dst: torch.Tensor, idx: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """``dst[idx[i]] += vals[i]`` for i in order, duplicates included (the
    reference's scatter-add applies its updates one after another), with
    ``idx == len(dst)`` dropped.  Each round adds at most one update per
    slot, so the order holds on any device."""
    held = idx < dst.shape[0]
    idx, vals, out = idx[held], vals[held], dst.clone()
    order = torch.sort(idx, stable=True).indices
    si = idx[order]
    rank = torch.empty_like(idx)
    rank[order] = torch.arange(idx.shape[0], device=idx.device) - torch.searchsorted(si, si, side="left")
    for r in range(int(rank.max()) + 1 if idx.numel() else 0):
        m = rank == r
        out.index_put_((idx[m],), vals[m], accumulate=True)
    return out


def _fold_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum of x from 0.0, one element after another."""
    acc = torch.zeros((), dtype=x.dtype, device=x.device)
    for v in x:
        acc = acc + v
    return acc


def _row_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of a (n,) float64 row, n a power of two, in the order of the
    reference's compiled ``jnp.sum`` on XLA's CPU backend: from 0.0 in index
    order up to 16 elements; at 32, the loop vectorised four doubles wide
    with four accumulators (element i in lane i % 4 of vector (i // 4) % 4;
    the vectors summed ((V1 + V0) + V2) + V3, then the lanes (R0 + R2) +
    (R1 + R3)); past 32, each window of 32 summed in order and the window
    totals in order (XLA's reduce-window rewrite)."""
    n = x.shape[0]
    if n > 32:
        return _fold_sum(torch.stack([_fold_sum(w) for w in x.split(32)]))
    if n == 32:
        v = (torch.zeros((), dtype=x.dtype, device=x.device) + x[:16]) + x[16:]
        v = v.view(4, 4)
        r = ((v[1] + v[0]) + v[2]) + v[3]
        return (r[0] + r[2]) + (r[1] + r[3])
    return _fold_sum(x)


def _admission_shard(base0, tl_t, tl_d, tl_c, slot_fold, rel_codes, starts, ends, rels, bnd, val, codes, valid,
                     t0: float, budget: float, Lp: int | None = None):
    """One shard's decision batch against its carried timeline (the plain
    version of one block of the admission_epoch kernel; the reference's
    ``_admission_shard``, step for step and sum for sum).

    Carried state: base0 () the demand folded in at or before the clock;
    tl_t/tl_d (L,) the sorted future event times (+inf padded) and deltas;
    tl_c (L,) int32 owner codes (-1: empty); slot_fold (Smax,) each owner's
    deltas already folded into base0.  Batch: rel_codes (Rb,) int32 codes
    released since the last call (-1 padded); starts/ends/rels (Cb,),
    bnd/val (Cb, k), codes (Cb,) int32 and valid (Cb,) bool, the candidates
    in arrival order; ``t0`` the batch clock; ``Lp`` the decision prefix
    (None: the whole axis).

    Steps: (1) the released owners' events leave the row (the survivors
    compacted left, stably) and their folded sums leave base0; (2) the
    events at or before t0 fold into base0 (the running sum's last element
    in XLA's order over L) and into their owners' slot_fold (in update
    order), and the row shifts left; (3) the candidates' slots are zeroed;
    (4) the candidates are decided in order at two probe families: the
    carried events in (start, end] read at tie-group-final positions, and
    every candidate's start and live switch instants in [start, end], each
    against the carried demand, the admitted candidates' event sums and the
    candidate's own allocation; (5) the admitted candidates' events are
    merged into the row by a stable sort (old events first on ties, then
    candidates in order).

    Returns ``(admits (Cb,), overflow (), n_live (), base0, tl_t, tl_d,
    tl_c, slot_fold)``; ``overflow`` flags a merge past L or a live event
    past Lp."""
    dev = tl_t.device
    L, k, Smax = tl_t.shape[0], bnd.shape[1], slot_fold.shape[0]
    Lp = L if Lp is None else min(Lp, L)
    ar = torch.arange(L, device=dev)

    # 1. releases
    rv = rel_codes >= 0
    rel_mask = torch.zeros(Smax + 1, dtype=torch.bool, device=dev)
    rel_mask[torch.where(rv, rel_codes, Smax).long()] = True
    gone = rel_mask[torch.where(tl_c >= 0, tl_c, Smax).long()]
    base0 = base0 - _row_sum(torch.where(rv, slot_fold[torch.clamp(rel_codes, min=0).long()], 0.0))
    slot_fold = torch.cat([slot_fold, slot_fold.new_zeros(1)])
    slot_fold[torch.where(rv, rel_codes, Smax).long()] = 0.0
    slot_fold = slot_fold[:Smax]
    keep = ~gone
    dst = torch.where(keep, torch.cumsum(keep, 0) - 1, L)

    def compact(x, fill):
        out = torch.full((L + 1,), fill, dtype=x.dtype, device=dev)
        out[dst] = x
        return out[:L]

    tl_t, tl_d, tl_c = compact(tl_t, _INF), compact(tl_d, 0.0), compact(tl_c, -1)

    # 2. fold the events at or before the clock
    fold = tl_t <= t0
    cnt = int(fold.sum())
    dfold = torch.where(fold, tl_d, 0.0)
    base0 = base0 + xla_cumsum(dfold)[-1]
    slot_fold = _scatter_add_in_order(slot_fold, torch.where(fold & (tl_c >= 0), tl_c, Smax).long(), dfold)
    idxc = torch.clamp(ar + cnt, max=L - 1)
    kept = ar + cnt < L
    tl_t = torch.where(kept, tl_t[idxc], _INF)
    tl_d = torch.where(kept, tl_d[idxc], 0.0)
    tl_c = torch.where(kept, tl_c[idxc], -1)

    # 3. the candidates' fresh slots
    slot_fold = torch.cat([slot_fold, slot_fold.new_zeros(1)])
    slot_fold[torch.where(valid, codes, Smax).long()] = 0.0
    slot_fold = slot_fold[:Smax]

    # 4. the two probe families and the decisions
    pt, pd = tl_t[:Lp], tl_d[:Lp]
    prefix_over = bool(torch.isfinite(tl_t[Lp])) if Lp < L else False
    cs = base0 + xla_cumsum(pd)
    cs0 = torch.cat([base0[None], cs])
    tie = torch.cat([pt[:-1] != pt[1:], torch.isfinite(pt[-1:])])
    t_new, d_new, live = _plan_events(starts, bnd, val, rels)
    sw = torch.nextafter(starts[:, None] + bnd, torch.full_like(bnd, _INF))
    Q = torch.cat([starts[:, None], torch.where(live, sw, _INF)], dim=1).reshape(-1)
    qprof = cs0[(pt[None, :] <= Q[:, None]).sum(dim=1)]
    evwin = tie[None, :] & (pt[None, :] > starts[:, None]) & (pt[None, :] <= ends[:, None])
    qwin = (Q[None, :] >= starts[:, None]) & (Q[None, :] <= ends[:, None])

    def own(p):  # the probing candidate's allocation at p: val[min(#(b < p - start), k - 1)]
        idx = (bnd[:, :, None] < (p[None, :] - starts[:, None])[:, None, :]).sum(dim=1)
        return torch.gather(val, 1, torch.clamp(idx, max=k - 1))

    def contrib(p):  # an admitted candidate's event deltas at or before p, summed from 0 in order
        acc = torch.zeros((t_new.shape[0], p.shape[0]), dtype=F64, device=dev)
        for j in range(t_new.shape[1]):
            acc = acc + d_new[:, j, None] * (t_new[:, j, None] <= p[None, :])
        return acc

    evself, qself, evcontrib, qcontrib = own(pt), own(Q), contrib(pt), contrib(Q)
    extra_ev, extra_q = torch.zeros_like(pd), torch.zeros_like(Q)
    admits = torch.empty(valid.shape, dtype=torch.bool, device=dev)
    for i in range(valid.shape[0]):
        over = (evwin[i] & (cs + extra_ev + evself[i] > budget)).any() | (
            qwin[i] & (qprof + extra_q + qself[i] > budget)).any()
        admit = valid[i] & ~over
        extra_ev = extra_ev + torch.where(admit, evcontrib[i], 0.0)
        extra_q = extra_q + torch.where(admit, qcontrib[i], 0.0)
        admits[i] = admit

    # 5. the splice: one stable sort of the live prefix and the admitted events
    new_t = torch.where(admits[:, None], t_new, _INF).reshape(-1)
    new_d = torch.where(admits[:, None], d_new, 0.0).reshape(-1)
    new_c = torch.where(admits, codes, -1)[:, None].expand(t_new.shape).reshape(-1).to(tl_c.dtype)
    head_t = torch.cat([pt, new_t])
    order = torch.sort(head_t, stable=True).indices
    comb_t = torch.cat([head_t[order], tl_t[Lp:]])
    comb_d = torch.cat([torch.cat([pd, new_d])[order], tl_d[Lp:]])
    comb_c = torch.cat([torch.cat([tl_c[:Lp], new_c])[order], tl_c[Lp:]])
    overflow = torch.tensor(bool(torch.isfinite(comb_t[L])) | prefix_over, device=dev)
    tl_t, tl_d, tl_c = comb_t[:L], comb_d[:L], comb_c[:L]
    n_live = torch.isfinite(tl_t).sum().to(torch.int32)
    return admits, overflow, n_live, base0, tl_t, tl_d, tl_c, slot_fold


def admission_epoch_plain(base0, tl_t, tl_d, tl_c, slot_fold, rel_codes, starts, ends, rels, bnd, val, codes, valid,
                          t0: float, budget: float, Lp: int | None = None):
    """Plain version of the admission_epoch kernel (the reference's
    ``admission_epoch``): ``_admission_shard`` over the leading shard axis S
    of every state and batch tensor, ``t0`` and ``budget`` shared.  Returns
    ``(admits (S, Cb), overflow (S,), n_live (S,), base0, tl_t, tl_d, tl_c,
    slot_fold)``."""
    outs = [
        _admission_shard(*(x[s] for x in (base0, tl_t, tl_d, tl_c, slot_fold, rel_codes, starts, ends, rels, bnd,
                                          val, codes, valid)), t0, budget, Lp)
        for s in range(tl_t.shape[0])
    ]
    return tuple(torch.stack(parts) for parts in zip(*outs))


# ---------------------------------------------------------------------------
# Fit probes: the O(log L) formulation shared by the epoch and sweep programs.
# Leading axes are lanes: tl_t (S, N, L) and per-lane rows b/v (S, k).
# ---------------------------------------------------------------------------


def _count_sorted(tl_t, pred, q_shape):
    """Per-row counts of the prefix satisfying a monotone predicate, by
    binary lifting: ``tl_t`` (..., L) ascending rows (+inf padded), ``pred``
    maps gathered times of shape ``q_shape`` (..., Q) to a mask that is True
    on a prefix of every row.  Returns int64 counts in [0, L]."""
    L = tl_t.shape[-1]
    lo = torch.zeros(q_shape, dtype=torch.int64, device=tl_t.device)
    step = 1 << max(L - 1, 0).bit_length()  # smallest power of two >= L
    while step:
        cand = lo + step
        t = torch.gather(tl_t, -1, torch.clamp(cand - 1, max=L - 1))
        lo = torch.where((cand <= L) & pred(t), cand, lo)
        step >>= 1
    return lo


def _floor_log2_table(L: int) -> np.ndarray:
    """``floor(log2(n))`` for n in [0, L] (0 at n = 0)."""
    n = np.maximum(np.arange(L + 1), 1)
    return np.asarray([int(v).bit_length() - 1 for v in n], dtype=np.int64)


def _range_max_query(tbl, log2_tbl, l, r):
    """Range max over [l, r) per query from the doubling table: ``tbl``
    (B, P, L) (``ops.range_max_table``), ``l``/``r`` (B, Q).  Two
    overlapping span lookups per query; -inf for empty windows."""
    B, P, L = tbl.shape
    length = torch.clamp(r - l, min=0)
    p = log2_tbl[length]
    span = torch.ones_like(p) << p
    flat = tbl.reshape(B, P * L)
    lo = torch.gather(flat, 1, p * L + torch.clamp(l, max=L - 1))
    hi = torch.gather(flat, 1, p * L + torch.clamp(r - span, min=0))
    return torch.where(length > 0, torch.maximum(lo, hi), -_INF)


def _plan_events(t_start, b, v, release):
    """Reservations' k+2 timeline events, batched over leading axes (the
    twin of ``core.timeline.plan_profile_events``): +v_0 at the start, each
    step delta at ``nextafter`` past a boundary that fires before the
    release, -v_end at the release.  Unfired switches park at +inf with a
    zero delta; a stable time sort keeps the host's order on ties.

    t_start/release (...,), b/v (..., k) -> (t_new (..., k+2), d_new, live (..., k))."""
    ts = t_start[..., None]
    sw = torch.nextafter(ts + b, torch.full_like(b, _INF))
    live = torch.isfinite(b) & (ts + b < release[..., None])
    steps = torch.cat([torch.diff(v, dim=-1), torch.zeros_like(v[..., :1])], dim=-1)
    vext = torch.cat([v, v[..., -1:]], dim=-1)
    v_end = torch.gather(vext, -1, live.sum(dim=-1, keepdim=True))
    t_new = torch.cat([ts, torch.where(live, sw, _INF), release[..., None]], dim=-1)
    d_new = torch.cat([v[..., :1], torch.where(live, steps, 0.0), -v_end], dim=-1)
    t_sorted, order = torch.sort(t_new, dim=-1, stable=True)
    return t_sorted, torch.gather(d_new, -1, order), live


def _splice_row(tn, t_new, channels):
    """Splice time-sorted new events into sorted timeline rows, batched over
    leading axes, ``side="right"`` (time-tied newcomers land after existing
    events, the host ``Timeline``'s order).  Slots pushed past the axis are
    dropped.  ``channels`` are ``(old (..., L), new (..., n), fill)`` payloads
    spliced alongside.  Returns ``(t2, *payloads2)``."""
    L, n = tn.shape[-1], t_new.shape[-1]
    dev = tn.device
    pos_new = (tn[..., None, :] <= t_new[..., :, None]).sum(dim=-1) + torch.arange(n, device=dev)
    old_tgt = torch.arange(L, device=dev) + (t_new[..., None, :] < tn[..., :, None]).sum(dim=-1)
    # targets past the axis land in a spare column that is cut off
    old_tgt, pos_new = torch.clamp(old_tgt, max=L), torch.clamp(pos_new, max=L)
    shape = (*tn.shape[:-1], L + 1)
    out = []
    for old, new, fill in [(tn, t_new, _INF), *channels]:
        buf = torch.full(shape, fill, dtype=old.dtype, device=dev)
        buf.scatter_(-1, old_tgt, old).scatter_(-1, pos_new, new)
        out.append(buf[..., :L])
    return tuple(out)


def _fit_tables(tl_t, tl_d, base0):
    """Running demand after every event (``base0`` included), masked to -inf
    off tie-group-final positions, and its doubling range-max table: (N, L)
    rows -> (csm (N, L), tbl (N, P, L)).  One rangemax launch on the card
    (``ops.fit_tables``)."""
    return ops.fit_tables(tl_t, tl_d, base0)


def _fit_probes(tl_t, csm, qmax, base0, b, v, pd, budget, cc, nmask=None):
    """(S, C, N) fit masks of one row per lane at clocks ``cc`` (S, C): the
    range-max formulation of the scalar ``demand_exceeds`` pass over the
    window [c, c + pd), decision-identical to a dense scan of the profile.

    tl_t/csm (S, N, L), base0 (S, N), b/v (S, k), pd/budget (S,), nmask
    (S, N) or None.  Own probes (the clock and the row's switch instants)
    read the profile at ``#(t <= p)``; the profile events inside the window
    enter per segment j as ONE range max over the suffix of in-window events
    with offset > b[j-1] (``qmax(ls (S, N, C, k), r (S, N, C))``: the sparse
    table of the epoch program or the suffix running max of the sweep).
    Every count comes from one binary-lifting pass with per-query (offset,
    threshold, strictness)."""
    S, N, L = tl_t.shape
    k = b.shape[-1]
    C = cc.shape[-1]
    dev = tl_t.device
    end = cc + pd[:, None]  # (S, C)
    dur_eff = end - cc
    x = cc[:, :, None] + b[:, None, :]
    p_sw = torch.nextafter(x, torch.full_like(x, _INF))  # (S, C, k)
    own_p = torch.cat([cc[:, :, None], p_sw], dim=-1)  # (S, C, k+1)
    own_ok = torch.cat(
        [torch.ones((S, C, 1), dtype=torch.bool, device=dev),
         (b[:, None, :] < dur_eff[:, :, None]) & (p_sw < end[:, :, None])],
        dim=-1,
    )
    offs = own_p - cc[:, :, None]
    oidx = torch.clamp((b[:, None, None, :] < offs[..., None]).sum(dim=-1), max=k - 1)
    cand_own = torch.gather(v[:, None, :].expand(S, C, k), -1, oidx)  # (S, C, k+1)
    n_own, n_lj = C * (k + 1), C * (k - 1)
    zero_c = torch.zeros((S, C), dtype=F64, device=dev)
    thr = [own_p.reshape(S, -1), end, cc]
    off = [torch.zeros((S, n_own), dtype=F64, device=dev), zero_c, zero_c]
    if k > 1:
        thr.append(b[:, None, : k - 1].expand(S, C, k - 1).reshape(S, -1))
        off.append(cc[:, :, None].expand(S, C, k - 1).reshape(S, -1))
    thr_q = torch.cat(thr, dim=1)[:, None, :]
    off_q = torch.cat(off, dim=1)[:, None, :]
    Q = n_own + 2 * C + n_lj
    strict = torch.zeros(Q, dtype=torch.bool, device=dev)
    strict[n_own : n_own + C] = True  # window ends: t < end
    cnt_all = _count_sorted(
        tl_t, lambda t: torch.where(strict, t - off_q < thr_q, t - off_q <= thr_q), (S, N, Q)
    )
    cnt = cnt_all[..., :n_own]
    r_win = cnt_all[..., n_own : n_own + C]
    l0 = cnt_all[..., n_own + C : n_own + 2 * C]
    cs0 = torch.cat([base0[..., None], csm], dim=-1)
    prof_own = torch.gather(cs0, -1, cnt).reshape(S, N, C, k + 1)
    bud = budget[:, None, None, None]
    over = (own_ok[:, None] & (prof_own + cand_own[:, None] > bud)).any(dim=-1)  # (S, N, C)
    if k > 1:
        ls = torch.cat([l0[..., None], cnt_all[..., n_own + 2 * C :].reshape(S, N, C, k - 1)], dim=-1)
    else:
        ls = l0[..., None]
    m = qmax(ls, r_win)  # (S, N, C, k)
    over_ev = (m + v[:, None, None, :] > bud).any(dim=-1)
    fit = ~(over | over_ev)
    if nmask is not None:
        fit &= nmask[:, :, None]
    return fit.transpose(1, 2)


def _suffix_max_query(csm, ls, r):
    """The table-free ``qmax``: maxima of ``csm`` (S, N, L) over [l_j, r)
    from one masked reverse running max per clock (ls (S, N, C, k), r
    (S, N, C)); the same maxima as the sparse-table read."""
    L = csm.shape[-1]
    inwin = torch.arange(L, device=csm.device) < r[..., None]  # (S, N, C, L)
    masked = torch.where(inwin, csm[:, :, None, :], -_INF)
    rm = torch.flip(torch.cummax(torch.flip(masked, dims=[-1]), dim=-1).values, dims=[-1])
    g = torch.gather(rm, -1, torch.clamp(ls, max=L - 1))
    return torch.where(ls < r[..., None], g, -_INF)


def _pop_pending(t, ev, fit_many, CH):
    """One wait iteration of the epoch and sweep programs, per lane: pop up
    to CH earliest pending completions and probe at each ``max(t, t_i)``
    together -- the oracle's pop / re-probe / pop sequence, consuming
    exactly the events it would.  t (S,), ev (S, H) ->
    (t2, ev2, npop, hit, node2, dead)."""
    tt, idx = torch.topk(ev, CH, dim=-1, largest=False, sorted=True)  # ascending
    fin = torch.isfinite(tt)
    cc = torch.maximum(t[:, None], tt)
    F = fit_many(torch.where(fin, cc, t[:, None])) & fin[:, :, None]  # (S, CH, N)
    anyfit = F.any(dim=-1)
    hit = anyfit.any(dim=-1)
    i = _first_true(anyfit)
    npop = torch.where(hit, i + 1, fin.sum(dim=-1))
    popped = torch.arange(CH, device=ev.device) < npop[:, None]
    ev2 = ev.scatter(1, idx, torch.where(popped, _INF, tt))
    last = torch.clamp(npop - 1, min=0)
    c_i = torch.gather(cc, 1, i[:, None])[:, 0]
    c_last = torch.gather(cc, 1, last[:, None])[:, 0]
    t2 = torch.where(hit, c_i, torch.where(npop > 0, c_last, t))
    F_i = torch.gather(F, 1, i[:, None, None].expand(-1, 1, F.shape[-1]))[:, 0]
    return t2, ev2, npop, hit, _first_true(F_i), ~hit & (npop == 0)


# ---------------------------------------------------------------------------
# The window programs: first-fit for rows that all share the epoch clock.
# ---------------------------------------------------------------------------


def _window_program_shared(P, prof, now, ends, rels, bnd, val, cap):
    """First-fit of w rows at the clock ``now`` over ONE probe set P (Pp,)
    shared by all nodes, prof (N, Pp) the nodes' profile reads.  Each
    candidate's pieces are computed once (``candidate_probe_parts``); a row
    that fits no node blocks every later row.  Returns (placed (w,), node (w,))."""
    N = prof.shape[0]
    w = bnd.shape[0]
    dev = prof.device
    starts = torch.full((w,), now, dtype=F64, device=dev)
    x = now + bnd
    sw = torch.nextafter(x, torch.full_like(x, _INF))
    live = torch.isfinite(bnd) & (now + bnd < rels[:, None])
    valext = torch.cat([val, val[:, -1:]], dim=1)
    A, M, D = candidate_probe_parts(P, starts, ends, rels, bnd, val, valext, sw, live, inclusive_end=False)
    node_ids = torch.arange(N, device=dev)
    extra = torch.zeros_like(prof)  # this window's placed demand
    blocked = torch.zeros((), dtype=torch.bool, device=dev)
    placed, nodes = [], []
    for r in range(w):
        fit = ~(M[r][None, :] & (prof + extra + A[r][None, :] > cap)).any(dim=-1)  # (N,)
        can = ~blocked & fit.any()
        node = _first_true(fit)
        extra = extra + torch.where((can & (node_ids == node))[:, None], D[r][None, :], 0.0)
        blocked = blocked | ~can
        placed.append(can)
        nodes.append(node)
    return torch.stack(placed), torch.stack(nodes)


def first_fit_window(
    now: float,
    bnd: np.ndarray,
    val: np.ndarray,
    run_times: np.ndarray,
    probe_times: np.ndarray,
    profiles: list[tuple[np.ndarray, np.ndarray]],
    capacity_budget: float,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """First-fit placements for one window of rows at the fixed clock ``now``.

    bnd/val (w, k) node-capped schedules; run_times (w,) occupancy (the
    release instants), probe_times (w,) fit windows (the full predicted
    duration); profiles per node ``Timeline.arrays()``; capacity_budget the
    fits budget (capacity + 1e-6).  Probes are the clock, every candidate's
    switch instants and the profile events inside the widest window,
    deduped; the host reads each node's profile at them.  Returns
    ``(placed, node)``; ``placed`` is a prefix."""
    dev = resolve_device(device)
    N = len(profiles)
    ends = now + probe_times
    rels = now + run_times
    sw = np.nextafter(now + bnd, np.inf)
    tmax = float(ends.max())
    csw = shared_probe_set(np.asarray([now]), sw[np.isfinite(sw)])
    P = shared_probe_set(csw, *(t[(t > now) & (t < tmax)] for t, _ in profiles))
    Pp = fine_bucket(len(P), floor=128)
    prof = np.zeros((N, Pp))
    for n, (t, c) in enumerate(profiles):
        prof[n, : len(P)] = c[np.searchsorted(t, P, side="right")]
    P = np.concatenate([P, np.full(Pp - len(P), np.inf)])
    placed, node = _window_program_shared(
        _t64(P, dev), _t64(prof, dev), float(now), _t64(ends, dev), _t64(rels, dev), _t64(bnd, dev),
        _t64(val, dev), float(capacity_budget),
    )
    return placed.cpu().numpy(), node.cpu().numpy()


# ---------------------------------------------------------------------------
# The scheduling-epoch program: first-fit with the event clock and the
# release heap in the program's state.
# ---------------------------------------------------------------------------


def _schedule_program(tl_t, tl_d, base0, ev, h0, now0, bnd, val, run, pdur, cap, budget):
    """One scheduling epoch: place the (w, k) rows in order.

    tl_t/tl_d (N, L) the nodes' future events (sorted, +inf / 0 padded),
    base0 (N,) each node's demand at the clock, ev (H,) pending completions
    (+inf = free slot; a placed row r pushes at ``h0 + r``), now0 the clock.
    Per row: build the running sums and the range-max table once (the
    rangemax kernel), probe every node at the clock; while none fits, pop
    pending completions (``_pop_pending``), advance the clock and probe
    again.  A placed row's events are spliced into its node's timeline and
    its completion pushed on the heap.  At most ``cap`` rows commit to one
    node per epoch; the row that would exceed it aborts the epoch with its pops
    and clock advance discarded (the host re-dispatches it).  A drained heap
    with no fit marks the row dead.

    Returns (placed (w,), node (w,), start (w,), final clock, pops, rows
    that waited, dead)."""
    N, L = tl_t.shape
    w = bnd.shape[0]
    dev = tl_t.device
    CH = 8  # pending completions probed per wait iteration
    log2_tbl = torch.as_tensor(_floor_log2_table(L), device=dev)

    def one(a):  # the lane axis of the shared probe functions
        return a[None]

    now = torch.tensor(now0, dtype=F64, device=dev)
    cnts = np.zeros(N, dtype=np.int64)
    pops = waited = 0
    blocked = dead_any = False
    placed_o = np.zeros(w, dtype=bool)
    node_o = np.zeros(w, dtype=np.int64)
    start_o = np.zeros(w, dtype=np.float64)
    for r in range(w):
        if blocked:  # a row before did not place: nothing after it runs
            start_o[r:w] = now.item()
            break
        b, v = bnd[r], val[r]
        csm, tbl = _fit_tables(tl_t, tl_d, base0)

        def qmax(ls, rr, tbl=tbl):
            shape = ls.shape
            r_q = rr[..., None].expand(shape)
            return _range_max_query(tbl, log2_tbl, ls.reshape(N, -1), r_q.reshape(N, -1)).reshape(shape)

        def fit_many(cc, b=b, v=v, pd=pdur[r:r + 1], csm=csm, qmax=qmax):
            return _fit_probes(one(tl_t), one(csm), qmax, one(base0), one(b), one(v), pd, budget, cc)

        fit0 = fit_many(now.view(1, 1))[0, 0]
        node = _first_true(fit0)
        found = bool(fit0.any())
        t, ev_, row_pops, dead = now, ev, 0, False
        while not found and not dead:
            t2, ev2, npop, hit, node2, _ = _pop_pending(t.view(1), ev_.view(1, -1), fit_many, CH)
            t, ev_, node = t2[0], ev2[0], node2[0]
            npop, found = int(npop), bool(hit)
            row_pops += npop
            dead = not found and npop == 0
        n = int(node)
        full = cnts[n] >= cap
        placed = found and not full
        if placed:
            end = t + run[r]
            t_new, d_new, _ = _plan_events(t, b, v, end)
            t2, d2 = _splice_row(tl_t[n], t_new, [(tl_d[n], d_new, 0.0)])
            tl_t, tl_d = tl_t.clone(), tl_d.clone()
            tl_t[n], tl_d[n] = t2, d2
            ev_ = ev_.clone()
            ev_[h0 + r] = end
        if placed or not found:  # an aborted row's pops and clock are discarded
            now, ev = t, ev_
        pops += 0 if (found and full) else row_pops
        waited += int(placed and row_pops > 0)
        blocked = not placed
        cnts[n] += int(placed)
        dead_any |= dead
        placed_o[r], node_o[r], start_o[r] = placed, n, t.item()
    return placed_o, node_o, start_o, float(now), pops, waited, dead_any


def schedule_epoch(
    now: float,
    bnd: np.ndarray,
    val: np.ndarray,
    run_times: np.ndarray,
    node_events: list[tuple[np.ndarray, np.ndarray]],
    pending: np.ndarray,
    capacity_budget: float,
    window_bucket: int = 32,
    probe_times: np.ndarray | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, float, int, int, bool]:
    """Place up to one window of attempt rows, resolving waits in-program.

    bnd/val (w, k) node-capped schedules, run_times (w,) occupancy,
    node_events per node ``Timeline.events()``, pending (E,) completion
    instants still in the scheduler's wait heap, capacity_budget the fits
    budget, probe_times (w,) fit windows (default: run_times).

    Returns ``(placed, node, start, now_final, n_pops, n_waited, dead)``
    for the w rows: ``placed`` is a prefix -- False past the first row that
    aborted on a full per-node commit buffer (the caller re-dispatches) or,
    with ``dead``, past a row that drained the heap with no fit.  ``n_pops``
    pending events were consumed (the smallest of ``pending`` and this
    epoch's own completions).  ``window_bucket`` is the reference's padded
    row count: it sets the per-node commit cap (``max(2, min(bucket, 8))``)
    and the sizes of the timeline axis and the heap."""
    dev = resolve_device(device)
    k = bnd.shape[1]
    Wb = int(window_bucket)
    cap = max(2, min(Wb, 8))
    N = len(node_events)
    # events at or before the clock fold into a base demand (the sequential
    # np.cumsum prefix, the value the host profile reads at the clock)
    cuts = [np.searchsorted(t, now, side="right") for t, _ in node_events]
    base0 = np.asarray([np.cumsum(d[:c])[-1] if c else 0.0 for (_, d), c in zip(node_events, cuts)])
    e0 = max((len(t) - c for (t, _), c in zip(node_events, cuts)), default=0)
    L = fine_bucket(e0 + cap * (k + 2), floor=64)
    tl_t = np.full((N, L), np.inf)
    tl_d = np.zeros((N, L))
    for n, ((t, d), c) in enumerate(zip(node_events, cuts)):
        tl_t[n, : len(t) - c] = t[c:]
        tl_d[n, : len(d) - c] = d[c:]
    h0 = len(pending)
    H = bucket_size(h0 + Wb, floor=32)
    ev = np.full(H, np.inf)
    ev[:h0] = np.sort(np.asarray(pending, dtype=np.float64))
    if probe_times is None:
        probe_times = run_times
    placed, node, start, now_f, pops, waited, dead = _schedule_program(
        _t64(tl_t, dev), _t64(tl_d, dev), _t64(base0, dev), _t64(ev, dev), h0, float(now),
        _t64(bnd, dev), _t64(val, dev), _t64(run_times, dev), _t64(probe_times, dev),
        cap, torch.tensor([capacity_budget], dtype=F64, device=dev),
    )
    return placed, node, start, now_f, pops, waited, dead


# ---------------------------------------------------------------------------
# The sweep program: every lane of a design space scheduled end to end.
# ---------------------------------------------------------------------------

_SWEEP_W = 8  # rows per fold chunk (the windows loop's wait-window cadence)
_SWEEP_CH = 8  # pending completions probed per wait iteration


def _fold_and_compact(now, base, tl_t, tl_d):
    """The chunk-boundary step of the sweep, all lanes x nodes at once: fold
    the events at or before each lane's clock into its nodes' base demand,
    then drop every event whose delta leaves the running sum's bits
    unchanged and front-compact the rest.  One compaction launch on the
    card (``ops.fold_compact``), and the max over nodes.  Returns (base,
    tl_t, tl_d, csm, carried) with csm the tie-masked running sums and
    carried (S,) the busiest node's kept count."""
    S, N, L = tl_t.shape
    base, tl_t, tl_d, csm, kept = ops.fold_compact(tl_t.reshape(S * N, L), tl_d.reshape(S * N, L),
                                                   base.reshape(S * N), now, N)
    return (base.view(S, N), tl_t.view(S, N, L), tl_d.view(S, N, L), csm.view(S, N, L),
            kept.view(S, N).amax(dim=-1))


def _sweep_program(bnd, val, run, pdur, valid, nmask, budget, L, tail_fold):
    """Every lane scheduled end to end (the reference's ``_sweep_lane``
    under ``vmap``, with the lanes as a leading axis).

    bnd/val (S, R, k), run/pdur/valid (S, R), nmask (S, N), budget (S,).
    Rows walk in chunks of ``_SWEEP_W``; each chunk starts with
    ``_fold_and_compact``.  Per row every lane probes its clock (the
    suffix-max backend over its carried sums); lanes that fit nowhere pop
    pending completions until one fits, the others hold their state (the
    ``while_loop``-under-``vmap`` semantics).  Commits splice the placed
    node's events and refresh its sums only.  A lane whose timeline
    outgrows L flags overflow (its splices lost events; the host
    re-dispatches with a larger axis); a drained heap with no fit marks a
    lane dead.  ``tail_fold`` folds once more after the last row, for the
    high-water mark only: the reference pads the rows to a bucket and folds
    at every chunk boundary inside it, and the first padded boundary may
    carry more than any earlier one (later ones carry no more).

    Returns per-row (placed, node, start) (S, R) plus (clock, pops, waited,
    dead, overflow, carried-breakpoint high-water mark) per lane."""
    S, R, k = bnd.shape
    N = nmask.shape[1]
    dev = bnd.device
    lanes = torch.arange(S, device=dev)
    now = torch.zeros(S, dtype=F64, device=dev)
    base = torch.zeros((S, N), dtype=F64, device=dev)
    tl_t = torch.full((S, N, L), _INF, dtype=F64, device=dev)
    tl_d = torch.zeros((S, N, L), dtype=F64, device=dev)
    ev = torch.full((S, max(R, _SWEEP_CH)), _INF, dtype=F64, device=dev)  # release heap: one slot per row
    zi = torch.zeros(S, dtype=torch.int64, device=dev)
    pops, waited, hw = zi.clone(), zi.clone(), zi.clone()
    dead_any = torch.zeros(S, dtype=torch.bool, device=dev)
    over_any = dead_any.clone()
    placed_o = torch.zeros((S, R), dtype=torch.bool, device=dev)
    node_o = torch.zeros((S, R), dtype=torch.int64, device=dev)
    start_o = torch.zeros((S, R), dtype=F64, device=dev)
    for r in range(R):
        if r % _SWEEP_W == 0:
            base, tl_t, tl_d, csm, carried = _fold_and_compact(now, base, tl_t, tl_d)
            hw = torch.maximum(hw, carried)
        b, v, dur, pd, ok = bnd[:, r], val[:, r], run[:, r], pdur[:, r], valid[:, r]

        def fit_many(cc, b=b, v=v, pd=pd, tl_t=tl_t, csm=csm):
            return _fit_probes(tl_t, csm, lambda ls, rr: _suffix_max_query(csm, ls, rr), base, b, v, pd, budget,
                               cc, nmask)

        fit0 = fit_many(now[:, None])[:, 0]  # (S, N)
        found = fit0.any(dim=-1)
        node = _first_true(fit0)
        t, ev_, row_pops = now, ev, zi
        dead = torch.zeros_like(found)
        searching = ok & ~dead_any & ~found
        while bool(searching.any()):
            t2, ev2, npop, hit, node2, dead2 = _pop_pending(t, ev_, fit_many, _SWEEP_CH)
            t = torch.where(searching, t2, t)
            ev_ = torch.where(searching[:, None], ev2, ev_)
            row_pops = row_pops + torch.where(searching, npop, 0)
            found = torch.where(searching, hit, found)
            node = torch.where(searching, node2, node)
            dead = torch.where(searching, dead2, dead)
            searching = ok & ~dead_any & ~found & ~dead
        ran = ok & ~dead_any
        placed = found & ran
        end = t + dur
        t_new, d_new, live = _plan_events(t, b, v, end)
        tn, dn = tl_t[lanes, node], tl_d[lanes, node]  # (S, L)
        over_loc = placed & (torch.isfinite(tn).sum(dim=-1) + 2 + live.sum(dim=-1) > L)
        t2, d2 = _splice_row(tn, t_new, [(dn, d_new, 0.0)])
        csm_n = masked_demand(t2, d2, base[lanes, node])
        pm = placed[:, None]
        tl_t, tl_d, csm = tl_t.clone(), tl_d.clone(), csm.clone()
        tl_t[lanes, node] = torch.where(pm, t2, tn)
        tl_d[lanes, node] = torch.where(pm, d2, dn)
        csm[lanes, node] = torch.where(pm, csm_n, csm[lanes, node])
        ev2 = ev_.clone()
        ev2[:, r] = torch.where(placed, end, ev_[:, r])
        keep_s = placed | (ran & dead)
        now = torch.where(keep_s, t, now)
        ev = torch.where(keep_s[:, None], ev2, ev)
        pops = pops + row_pops
        waited = waited + (placed & (row_pops > 0)).to(torch.int64)
        dead_any = dead_any | (ran & dead)
        over_any = over_any | over_loc
        placed_o[:, r], node_o[:, r], start_o[:, r] = placed, node, t
    if tail_fold:
        hw = torch.maximum(hw, _fold_and_compact(now, base, tl_t, tl_d)[-1])
    return placed_o, node_o, start_o, now, pops, waited, dead_any, over_any, hw


# The timeline axis the last dispatch of a grid shape settled on, so warm
# calls skip the doubling ladder: a bounded LRU (a pure performance cache;
# an evicted key re-probes from the floor).
_SWEEP_L_HINT: "collections.OrderedDict[tuple, int]" = collections.OrderedDict()
_SWEEP_L_HINT_CAP = 64


def _hint_get(key: tuple) -> int:
    """LRU read: 0 when unknown (the floor decides)."""
    L = _SWEEP_L_HINT.get(key, 0)
    if L:
        _SWEEP_L_HINT.move_to_end(key)
    return L


def _hint_put(key: tuple, L: int) -> None:
    """LRU write with eviction at ``_SWEEP_L_HINT_CAP`` entries."""
    _SWEEP_L_HINT[key] = L
    _SWEEP_L_HINT.move_to_end(key)
    while len(_SWEEP_L_HINT) > _SWEEP_L_HINT_CAP:
        _SWEEP_L_HINT.popitem(last=False)


def sweep_axis_hint(S: int, rmax: int, kmax: int, N: int, *, timeline_floor: int = 256) -> int:
    """The timeline axis the sweep would start from for this grid shape (the
    ``placement="auto"`` router's L-hat): the LRU hint after a run at the
    shape, else an estimate from the compaction bound (live breakpoints,
    ~0.4x a lane's attempt rows)."""
    R = _row_bucket(max(rmax, 1))
    hinted = _hint_get((S, R, kmax, N))
    if hinted:
        return hinted
    bound = bucket_size(max(rmax * 2 // 5, 1), floor=timeline_floor)
    return max(bucket_size(_SWEEP_W * (kmax + 2), floor=timeline_floor), min(bound, 8192))


def _row_bucket(n: int) -> int:
    """The reference's row-axis bucket, in eighths of a power of two and a
    multiple of ``_SWEEP_W``: the axis hint's key, and where the reference's
    last chunk boundary lies (the rows themselves are not padded here)."""
    p = bucket_size(n, floor=8 * _SWEEP_W)
    for eighths in (4, 5, 6, 7):
        c = p * eighths // 8
        if c >= n and c % _SWEEP_W == 0:
            return c
    return p


def sweep_schedule(
    lane_rows: list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]],
    lane_nodes: list[int],
    lane_budgets: list[float],
    *,
    timeline_floor: int = 256,
    timeline_cap: int = 8192,
    stats: dict | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Schedule every lane of a design space in one program.

    lane_rows per lane ``(bnd (r, k), val (r, k), run (r,), probe (r,))`` in
    queue order (``cluster._policy_rows`` layout); lane_nodes per lane its
    node count (nodes past it are masked); lane_budgets per lane the fits
    budget.  A lane whose future events outgrow the timeline axis flags
    overflow and the whole grid runs again with the axis doubled, up to
    ``timeline_cap``; a lane still overflowing there is reported dead.
    ``stats`` accumulates ``program_calls``, ``program_wall_s`` and
    ``waits_program``, and receives the last run's ``carried_hw`` (per lane)
    and ``timeline_axis``.

    Returns ``(node (S, R), start (S, R), pops (S,), waited (S,), dead (S,))``;
    rows of a dead lane are undefined (the caller replays that lane through
    the windows engine)."""
    dev = resolve_device(device)
    S = len(lane_rows)
    R = max((b.shape[0] for b, _, _, _ in lane_rows), default=1)
    kmax = max(b.shape[1] for b, _, _, _ in lane_rows)
    N = max(lane_nodes)
    bnd = np.full((S, R, kmax), np.inf)
    val = np.zeros((S, R, kmax))
    run = np.zeros((S, R))
    pdur = np.zeros((S, R))
    valid = np.zeros((S, R), dtype=bool)
    nmask = np.zeros((S, N), dtype=bool)
    for s, ((b, v, rr, pr), nn) in enumerate(zip(lane_rows, lane_nodes)):
        r, k = b.shape
        bnd[s, :r, :k] = b
        val[s, :r, :k] = v
        if k < kmax:
            val[s, :r, k:] = v[:, -1:]
        run[s, :r] = rr
        pdur[s, :r] = pr
        valid[s, :r] = True
        nmask[s, :nn] = True
    args = (
        _t64(bnd, dev), _t64(val, dev), _t64(run, dev), _t64(pdur, dev), torch.as_tensor(valid).to(dev),
        torch.as_tensor(nmask).to(dev), _t64(lane_budgets, dev),
    )
    R_ref = _row_bucket(max(R, 1))
    hint_key = (S, R_ref, kmax, N)
    tail_fold = -(-R // _SWEEP_W) * _SWEEP_W < R_ref  # a padded chunk boundary in the reference
    L = max(bucket_size(_SWEEP_W * (kmax + 2), floor=timeline_floor), min(_hint_get(hint_key), timeline_cap))
    while True:
        t0 = time.perf_counter()
        placed, node, start, _, pops, waited, dead, over, hw = _sweep_program(*args, L, tail_fold)
        placed, dead, over = placed.cpu().numpy(), dead.cpu().numpy(), over.cpu().numpy()
        if stats is not None:
            stats["program_calls"] = stats.get("program_calls", 0) + 1
            stats["program_wall_s"] = stats.get("program_wall_s", 0.0) + (time.perf_counter() - t0)
        if not over.any() or L >= timeline_cap:
            break
        L *= 2
    _hint_put(hint_key, L)
    dead = dead | over  # still overflowing at the cap: replay on the windows engine
    for s, (b, _, _, _) in enumerate(lane_rows):
        if not (dead[s] or placed[s, : b.shape[0]].all()):
            raise RuntimeError(f"sweep lane {s}: unplaced rows")
    waited = waited.cpu().numpy().astype(np.int64)
    if stats is not None:
        stats["waits_program"] = stats.get("waits_program", 0) + int(waited[~dead].sum())
        stats["carried_hw"] = hw.cpu().numpy().astype(np.int64).tolist()
        stats["timeline_axis"] = L
    return (
        node.cpu().numpy().astype(np.int64),
        start.cpu().numpy().astype(np.float64),
        pops.cpu().numpy().astype(np.int64),
        waited,
        dead,
    )
