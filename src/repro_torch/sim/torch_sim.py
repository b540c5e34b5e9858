"""The paper's online evaluation loop as two batched phases on tensors.

Port of ``repro.sim.jax_sim``.  The reference walks a task's executions in
one ``lax.scan``: each step predicts every method's allocation, replays the
execution with retries, then folds the observation into the k-Segments
carry.  The carry is updated only from observations (input size, runtime,
segment peaks); replay outcomes never feed back into it.  So the port splits
the scan in two:

(a) **Predict.**  Every execution's ``(bounds, values)`` for every method,
    for all executions at once.  The only sequential part is the fold of
    the regression statistics, one execution after another in the scan's
    order (one scan launch on the card, ``ops.prefix_sum``); errors,
    offsets and predictions are then elementwise or running maxima over
    those prefixes, which are exact.
(b) **Replay.**  All ``(lane, execution, method)`` rows together, each
    row's whole retry ladder with the reference's selective / partial /
    cap-jump bumps: one wastage launch on the card, at most
    ``MAX_RETRIES + 1`` rounds of attempt scoring on the CPU.

Lanes are a batch dimension: task types of one padded bucket for the Fig. 7
grid, or the segment counts ``k_eff`` of the Fig. 8 sweep.  The segmax and
wastage kernels (``repro_torch.kernels.ops``) carry the two data-parallel
loops: segment peaks at the start of (a), the retry ladders of (b); the
scan kernel every running sum of (a).

The grid runs in float32, as the reference with x64 off; the cluster's
retry ladders (``ladder_lanes``) also run in float64 on request, and sum
their attempt wastage in float64 either way.  Where the
reference uses ``jnp.cumsum``, ``_xla_cumsum`` adds in the order XLA's CPU
lowering of it does (sequential within 16-wide blocks, the block totals
scanned the same way, recursively; ``kernels.scan``), so those prefix sums
equal the reference's bit for bit and are the same on the CPU and the card.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import regression
from repro_torch.core.predictor import METHODS, retry_flags
from repro_torch.core.sizey import RAQ_EPS, SIZEY_QUANTILE_PCT, SIZEY_UNDER_PENALTY
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, wastage
from repro_torch.kernels.scan import XLA_SCAN_BLOCK
from repro_torch.kernels.scan import exclusive as _exclusive

MIB_PER_GIB = 1024.0
MAX_RETRIES = wastage.MAX_RETRIES

# Method rows this engine scores, in output-row order.
ENGINE_METHODS = METHODS


def _check_methods(methods) -> tuple[str, ...]:
    for m in methods:
        if m not in ENGINE_METHODS:
            raise ValueError(f"engine does not implement {m!r}; available: {ENGINE_METHODS}")
    return tuple(methods)


def _check_error_mode(error_mode: str, insample_window: int) -> None:
    if error_mode not in ("progressive", "insample"):
        raise ValueError(f"unknown error mode: {error_mode!r}")
    if error_mode == "insample" and insample_window < 1:
        raise ValueError("insample error mode needs an explicit history bound (insample_window >= 1)")
    if error_mode == "progressive" and insample_window:
        raise ValueError("insample_window only applies to error_mode='insample' (pass 0)")


# ---------------------------------------------------------------------------
# Prefix sums and running maxima along the last axis.
# ---------------------------------------------------------------------------


def _xla_cumsum(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive prefix sum along ``dim`` in the order of XLA's CPU ``cumsum``."""
    return ops.prefix_sum(a, dim, XLA_SCAN_BLOCK)


def _excl_xla_cumsum(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Exclusive prefix sum along ``dim`` in XLA's order (0 first)."""
    return _exclusive(_xla_cumsum(a, dim).movedim(dim, -1)).movedim(-1, dim)


def _running_max(a: torch.Tensor, dim: int, init: float) -> torch.Tensor:
    """``out[i] = max(init, a[0..i-1])`` along ``dim`` (exclusive)."""
    incl = torch.cummax(a.movedim(dim, -1), dim=-1).values
    return torch.clamp(_exclusive(incl, -torch.inf), min=init).movedim(-1, dim)


# ---------------------------------------------------------------------------
# k-Segments prediction from a carry.
# ---------------------------------------------------------------------------


def _schedule(r_e, v, k: int, k_eff, interval_s: float, floor_mib: float):
    """Step schedule (bounds, values (..., k)) of a runtime estimate r_e
    (...) and segment values v (..., k): ``k`` is the array width, ``k_eff
    <= k`` the live segment count; segments beyond ``k_eff`` get +inf
    boundaries (the hold-last-value region)."""
    dt, dev = v.dtype, v.device
    r_e = torch.clamp(r_e, min=interval_s)[..., None]
    s = torch.arange(k, device=dev)
    ke = torch.as_tensor(k_eff, device=dev)[..., None]
    bounds = (s + 1).to(dt) * (r_e / ke.to(dt))
    bounds = torch.where(s == ke - 1, r_e, bounds)  # exact last edge
    bounds = torch.where(s >= ke, torch.inf, bounds)
    v0 = v[..., :1]
    v = torch.cat([torch.where(v0 < 0, floor_mib, v0), v[..., 1:]], dim=-1)
    v = torch.cummax(v, dim=-1).values
    return bounds, torch.clamp(v, min=floor_mib)


def _predict(rt_stats, rt_over, seg_stats, seg_under, u, k: int, k_eff, interval_s: float, floor_mib: float):
    """k-Segments prediction (progressive or insample offsets), batched over
    leading axes: rt_stats (..., 5), rt_over (...), seg_stats (..., k, 5),
    seg_under (..., k), u (...), k_eff (...) int -> bounds, values (..., k)."""
    r_e = regression.predict(rt_stats, u) - torch.clamp(rt_over, min=0.0)
    v = regression.predict(seg_stats, u[..., None]) + torch.clamp(seg_under, min=0.0)
    return _schedule(r_e, v, k, k_eff, interval_s, floor_mib)


def _predict_rel(rt_stats, rt_over_rel, seg_stats, seg_under_rel, u, k: int, k_eff, interval_s: float,
                 floor_mib: float):
    """KS+ prediction: as ``_predict``, with offsets relative to the
    (floored) prediction, rescaled by it, so that the margin tracks the
    allocation's size."""
    raw = regression.predict(rt_stats, u)
    r_e = raw - torch.clamp(rt_over_rel, min=0.0) * torch.clamp(raw, min=interval_s)
    v = regression.predict(seg_stats, u[..., None])
    v = v + torch.clamp(seg_under_rel, min=0.0) * torch.clamp(v, min=floor_mib)
    return _schedule(r_e, v, k, k_eff, interval_s, floor_mib)


# ---------------------------------------------------------------------------
# Prefix programs: step i is the model fitted on executions j < i.
# ---------------------------------------------------------------------------


def _prefix_bank(u, gpeak):
    """The regression bank of ``gpeak ~ u`` over executions j < i for every
    step i, batched over lanes: (N, B) -> (N, B, 5).  Witt-LR's fits and
    Sizey's linear model's."""
    return _excl_xla_cumsum(regression.stats_terms(u, gpeak), dim=-2)


def _witt_prefix_values(u, gpeak, floor_mib, pref=None):
    """Witt-LR allocation values of every step, batched over lanes:
    u, gpeak (N, B) -> (val_std, val_max) (N, B).  ``e[i, j]`` is step i's
    fit's error on execution j; ``pref`` is ``_prefix_bank(u, gpeak)``."""
    B = u.shape[-1]
    dt, dev = u.dtype, u.device
    intercept, slope = regression.fit(_prefix_bank(u, gpeak) if pref is None else pref)  # (N, B)
    e = gpeak[..., None, :] - intercept[..., :, None] - slope[..., :, None] * u[..., None, :]  # (N, B, B)
    steps = torch.arange(B, device=dev)
    seen = steps[None, :] < steps[:, None]
    zero = torch.zeros((), dtype=dt, device=dev)
    n = torch.clamp(seen.sum(dim=1), min=1).to(dt)
    mean = torch.where(seen, e, zero).sum(dim=-1) / n
    var = torch.where(seen, e * e, zero).sum(dim=-1) / n - mean * mean
    std = torch.where(steps >= 2, torch.sqrt(torch.clamp(var, min=0.0)), zero)  # Witt: >= 2 residuals
    emax = torch.where(seen, e, -torch.inf).amax(dim=-1)
    off_max = torch.clamp(torch.where(torch.isfinite(emax), emax, zero), min=0.0)
    base = intercept + slope * u
    return torch.clamp(base + std, min=floor_mib), torch.clamp(base + off_max, min=floor_mib)


def _ppm_prefix_values(gpeak, rt_samples, cap_mib, floor_mib):
    """Tovar PPM candidate selection for every observation prefix, batched
    over lanes: gpeak, rt_samples (N, B) -> (val_orig, val_improved) (N, B).

    Peaks are sorted once (stably); at step i sorted position m is a
    candidate iff its execution came before i, and the expected-wastage
    terms are masked prefix sums.  Every observed peak is a candidate."""
    B = gpeak.shape[-1]
    dt, dev = gpeak.dtype, gpeak.device
    order = torch.argsort(gpeak, dim=-1, stable=True)
    p = torch.gather(gpeak, -1, order)  # sorted candidate/peak values
    rt = torch.gather(rt_samples, -1, order)
    seen = order[..., None, :] < torch.arange(B, device=dev)[:, None]  # (N, B_steps, B_sorted)
    seen_f = seen.to(dt)
    C = _xla_cumsum(seen_f * rt[..., None, :])  # masked prefix runtime sums
    S = _xla_cumsum(seen_f * (p * rt)[..., None, :])
    pj = p[..., None, :]
    waste_ok = pj * C - S  # successes: (q - p_i) * rt_i
    rt_bad = C[..., -1:] - C
    s_bad = S[..., -1:] - S
    # original: a failed first attempt wastes q*rt, the retry at node cap (cap - p)*rt
    waste_orig = waste_ok + pj * rt_bad + cap_mib * rt_bad - s_bad
    # improved: smallest ladder level a = q * 2^ceil(log2(p/q)) >= p (capped)
    # wastes (2a - q - p) * rt
    q = torch.clamp(p, min=1e-6)[..., :, None]
    ratio = pj / q
    a = torch.clamp(q * torch.exp2(torch.ceil(torch.log2(torch.clamp(ratio, min=1.0)))), max=cap_mib)
    pi = p[..., :, None]
    zero = torch.zeros((), dtype=dt, device=dev)
    w_pair = torch.where(pj > pi, (2.0 * a - pi - pj) * rt[..., None, :], zero)  # (N, B_cand, B_sorted)
    # step i adds execution i-1's column: an exclusive prefix sum over the
    # columns gathered into execution order
    inv = torch.argsort(order, dim=-1)
    contrib = torch.gather(w_pair, -1, inv[..., None, :].expand_as(w_pair)).transpose(-1, -2)  # (N, B_exec, B_cand)
    waste_imp = waste_ok + _excl_xla_cumsum(contrib, dim=-2)
    val_orig = torch.gather(p, -1, torch.argmin(torch.where(seen, waste_orig, torch.inf), dim=-1))
    val_imp = torch.gather(p, -1, torch.argmin(torch.where(seen, waste_imp, torch.inf), dim=-1))
    return torch.clamp(val_orig, min=floor_mib), torch.clamp(val_imp, min=floor_mib)


def _sizey_prefix_values(u, gpeak, floor_mib, pref=None):
    """Sizey portfolio allocation of every step, batched over lanes:
    u, gpeak (N, B) -> (N, B).  At step i both models are fitted on
    executions j < i: the linear one from Witt's prefix bank (``pref``),
    the quantile one as the ``SIZEY_QUANTILE_PCT``-th order statistic of the
    peaks seen, by masked integer ranks over one stable sort.  Each model's
    offset is the exclusive running maximum of its under-predictions over
    j >= 1; its allocation-quality score the exclusive prefix mean over
    j in [1, i) of its efficiency ratio less the penalised under-prediction
    rate.  The quantile model wins from step 2 on when it scores strictly
    higher (ties and the cold start go to the linear model)."""
    B = u.shape[-1]
    dt, dev = u.dtype, u.device
    steps = torch.arange(B, device=dev)
    intercept, slope = regression.fit(_prefix_bank(u, gpeak) if pref is None else pref)
    pred_lin = intercept + slope * u  # (N, B)
    order = torch.argsort(gpeak, dim=-1, stable=True)
    p = torch.gather(gpeak, -1, order)
    seen = order[..., None, :] < steps[:, None]  # (N, B_steps, B_sorted)
    rank = torch.cumsum(seen.to(torch.int32), dim=-1)  # integers: exact in any order
    # 1-based target rank ceil(pct * (i - 1) / 100) + 1, in exact integers
    target = 1 - torch.div(-SIZEY_QUANTILE_PCT * (steps - 1), 100, rounding_mode="floor")
    hit = seen & (rank == target[:, None])
    pred_q = torch.gather(p, -1, torch.argmax(hit.to(torch.uint8), dim=-1))  # the first hit; step 0 none
    preds = torch.stack([pred_lin, pred_q], dim=-2)  # (N, 2, B)
    res = torch.where(steps >= 1, gpeak[..., None, :] - preds, -torch.inf)
    v = torch.clamp(preds + _running_max(res, dim=-1, init=0.0), min=floor_mib)  # each model's proposal
    g = gpeak[..., None, :]
    ratio = torch.minimum(v, g) / torch.clamp(torch.maximum(v, g), min=RAQ_EPS)
    m1 = (steps >= 1).to(dt)
    excl = _excl_xla_cumsum(torch.stack([ratio * m1, (v < g).to(dt) * m1]))  # (2, N, 2, B)
    cnt = torch.clamp(steps - 1, min=1).to(dt)
    score = (excl[0] - SIZEY_UNDER_PENALTY * excl[1]) / cnt
    choose_q = (steps >= 2) & (score[..., 1, :] > score[..., 0, :])
    return torch.where(choose_q, v[..., 1, :], v[..., 0, :])


# ---------------------------------------------------------------------------
# Bounded-history insample offsets.
# ---------------------------------------------------------------------------


def _window_residuals(rt_stats, seg_stats, hu, hrt, hpk, interval_s: float, floor_mib: float):
    """Residuals of history rows under the fit of the given banks, batched:
    rt_stats (..., 5), seg_stats (..., k, 5), hu/hrt (..., W), hpk (..., W, k)
    -> (runtime over-prediction (..., W), segment under-prediction (..., W,
    k), and both relative to the floored prediction, KS+'s)."""
    rt_pred = regression.predict(rt_stats[..., None, :], hu)
    a, b = regression.fit(seg_stats)
    seg_pred = a[..., None, :] + b[..., None, :] * hu[..., None]
    rt_res, seg_res = rt_pred - hrt, hpk - seg_pred
    return (rt_res, seg_res, rt_res / torch.clamp(rt_pred, min=interval_s),
            seg_res / torch.clamp(seg_pred, min=floor_mib))


def _window_offsets(rt_stats, seg_stats, hist, n_obs, ev, interval_s: float, floor_mib: float):
    """Insample error offsets at prediction time: masked extremes of the
    window residuals under the current fit, combined with the frozen
    extremes of evicted rows (-inf while nothing was evicted).

    hist = (hu (..., W), hrt (..., W), hpk (..., W, k)) whose first
    ``min(n_obs, W)`` slots are filled; ev = (ev_rt (...), ev_seg (..., k),
    ev_rt_rel, ev_seg_rel).  Returns (rt_over (...), seg_under (..., k),
    rt_over_rel, seg_under_rel)."""
    hu, hrt, hpk = hist
    W = hu.shape[-1]
    res = _window_residuals(rt_stats, seg_stats, hu, hrt, hpk, interval_s, floor_mib)
    filled = torch.arange(W, device=hu.device) < torch.clamp(torch.as_tensor(n_obs, device=hu.device), max=W)[..., None]
    return tuple(
        torch.maximum(torch.where(f, r, -torch.inf).amax(dim=d), e)
        for r, e, f, d in zip(res, ev, (filled, filled[..., None]) * 2, (-1, -2) * 2)
    )


def _ksegments_offsets(P_rt, P_seg, incl_rt, incl_seg, u, runtime, peaks, *, error_mode, insample_window,
                       interval_s, floor_mib, relative):
    """Offsets (rt_over (N, B), seg_under (N, B, k), rt_over_rel,
    seg_under_rel) each step predicts with; the relative pair (KS+'s) is
    None unless ``relative``.  P_* are the banks before each step's
    observation, incl_* after it."""
    B = u.shape[1]
    dev = u.device
    if error_mode == "progressive":
        # score-then-update: running maxima of one-step-ahead errors, from 0
        has_data = P_rt[..., regression.N] > 0
        rt_pred = regression.predict(P_rt, u)
        seg_pred = regression.predict(P_seg, u[..., None])
        errs = (rt_pred - runtime, peaks - seg_pred)
        if relative:
            errs += (errs[0] / torch.clamp(rt_pred, min=interval_s), errs[1] / torch.clamp(seg_pred, min=floor_mib))
        offs = tuple(
            _running_max(torch.where(m, e, -torch.inf), dim=1, init=0.0)
            for e, m in zip(errs, (has_data, has_data[..., None]) * 2)
        )
        return offs if relative else (*offs, None, None)
    W = insample_window
    steps = torch.arange(B, device=dev)
    # step i's window holds executions i-1, ..., i-W (lag order: max ignores order)
    j = torch.clamp(steps[:, None] - 1 - torch.arange(W, device=dev)[None, :], min=0)  # (B, W)
    hist = (u[:, j], runtime[:, j], peaks[:, j])
    # step s >= W evicts execution s-W, frozen at its residual under the
    # banks after folding s; step i sees the evictions of steps s < i
    old = torch.clamp(steps - W, min=0)
    ev = _window_residuals(incl_rt, incl_seg, u[:, old, None], runtime[:, old, None], peaks[:, old, None],
                           interval_s, floor_mib)
    evict = steps >= W
    ev = tuple(
        _running_max(torch.where(m, r[:, :, 0], -torch.inf), dim=1, init=-torch.inf)
        for r, m in zip(ev, (evict, evict[:, None]) * 2)
    )
    offs = _window_offsets(P_rt, P_seg, hist, steps, ev, interval_s, floor_mib)
    return offs if relative else (*offs[:2], None, None)


# ---------------------------------------------------------------------------
# The two phases.
# ---------------------------------------------------------------------------


def predict_lanes(u, y, lengths, series, default_mib, k_eff, *, methods, k, interval_s, floor_mib, cap_mib,
                  error_mode, insample_window):
    """Phase (a): bounds, values (N, B, M, k) of every method at every step
    (arguments as ``simulate_lanes``)."""
    N, B = u.shape
    dt, dev = u.dtype, u.device
    T = y.shape[1]
    need = set(methods)
    # peaks of the float32 series are exact in float64 (the x64 ladders)
    peaks = ops.segment_peaks(y, lengths, series.reshape(-1), k_eff.repeat_interleave(B), k).view(N, B, k).to(dt)
    zero = torch.zeros((), dtype=dt, device=dev)
    gpeak = torch.where(torch.arange(T, device=dev) < lengths[:, None], y.to(dt), zero).amax(dim=1)[series]
    len_nb = lengths[series].to(dt)
    has_obs = (torch.arange(B, device=dev) >= 1)[None, :, None]  # step 0 has no history
    inf_bounds = torch.full((N, B, k), torch.inf, dtype=dt, device=dev)
    default = default_mib[:, None, None].expand(N, B, k)

    rows = {"default": (inf_bounds, default)}  # method -> (bounds, values) (N, B, k)
    need_ks = bool(need & {"ksegments-selective", "ksegments-partial"})
    need_rel = "ksplus" in need
    if need_ks or need_rel:
        runtime = len_nb * interval_s
        terms = torch.cat(
            [regression.stats_terms(u, runtime)[..., None, :], regression.stats_terms(u[..., None], peaks)], dim=2
        )  # (N, B, 1 + k, 5)
        incl = ops.prefix_sum(terms, dim=1, block=B)  # the fold, in execution order
        P = _exclusive(incl.movedim(1, -1)).movedim(-1, 1)
        rt_over, seg_under, rt_rel, seg_rel = _ksegments_offsets(
            P[:, :, 0], P[:, :, 1:], incl[:, :, 0], incl[:, :, 1:], u, runtime, peaks, error_mode=error_mode,
            insample_window=insample_window, interval_s=interval_s, floor_mib=floor_mib, relative=need_rel,
        )

        def after_first(b, v):  # step 0 has no history
            return torch.where(has_obs, b, inf_bounds), torch.where(has_obs, v, default)

        if need_ks:
            rows["ksegments-selective"] = rows["ksegments-partial"] = after_first(*_predict(
                P[:, :, 0], rt_over, P[:, :, 1:], seg_under, u, k, k_eff[:, None], interval_s, floor_mib))
        if need_rel:
            rows["ksplus"] = after_first(*_predict_rel(
                P[:, :, 0], rt_rel, P[:, :, 1:], seg_rel, u, k, k_eff[:, None], interval_s, floor_mib))
    per_step = {}
    if need & {"witt-lr", "witt-lr-max", "sizey"}:
        pref = _prefix_bank(u, gpeak)  # Witt's fits and Sizey's linear model's
    if need & {"witt-lr", "witt-lr-max"}:
        per_step["witt-lr"], per_step["witt-lr-max"] = _witt_prefix_values(u, gpeak, floor_mib, pref)
    if need & {"ppm", "ppm-improved"}:
        per_step["ppm"], per_step["ppm-improved"] = _ppm_prefix_values(gpeak, len_nb, cap_mib, floor_mib)
    if "sizey" in need:
        per_step["sizey"] = _sizey_prefix_values(u, gpeak, floor_mib, pref)
    for m in need & per_step.keys():
        rows[m] = (inf_bounds, torch.where(has_obs, per_step[m][..., None], default).expand(N, B, k))
    return torch.stack([rows[m][0] for m in methods], dim=2), torch.stack([rows[m][1] for m in methods], dim=2)


def _replay(y, lengths, series, bounds, values, k_eff, *, methods, interval_s, factor, cap_mib, max_attempts=None,
            acc_dtype=None):
    """Phase (b): replay every (lane, execution, method) row with retries.

    bounds/values (N, B, M, k) -> (waste (N, M, B), retries (N, M, B) i32),
    waste summed in ``acc_dtype`` (default: the values' dtype).  A failed
    row bumps its allocation (selective: the failed segment; partial: it and
    all later ones; cap jump: the node cap), capped and kept monotone; on
    the card the whole ladder is one wastage launch (``ops.replay_ladder``).

    With ``max_attempts`` set, every attempt is also recorded (the
    reference's ``_replay_multi`` with ``max_attempts``): values (N, M, B,
    A, k), failure index (N, M, B, A) with -1 for success and for slots past
    the ladder, wastage (N, M, B, A) and n_attempts (N, M, B); a row stops
    after A attempts, its last failure index then >= 0."""
    N, B, M, k = values.shape
    selective, cap_jump = retry_flags(methods)
    out = ops.replay_ladder(
        y, lengths, series.contiguous(), bounds.contiguous(), values.contiguous(), k_eff, selective, cap_jump,
        interval_s=interval_s, factor=factor, cap_mib=cap_mib, max_attempts=max_attempts, acc_dtype=acc_dtype,
    )
    waste, retries = (a.view(N, B, M).transpose(1, 2) for a in out[:2])
    if max_attempts is None:
        return waste, retries
    vbuf, fbuf, wbuf, natt = out[2]
    A = int(max_attempts)
    rec = (
        vbuf.view(N, B, M, A, k).transpose(1, 2),
        fbuf.view(N, B, M, A).transpose(1, 2),
        wbuf.view(N, B, M, A).transpose(1, 2),
        natt.view(N, B, M).transpose(1, 2),
    )
    return waste, retries, rec


def simulate_lanes(u, y, lengths, series, default_mib, k_eff, *, methods, k, interval_s, factor, floor_mib, cap_mib,
                   error_mode, insample_window):
    """Both phases over N lanes of B executions that read series of ``y``.

    u (N, B) f32 shifted input sizes, y (S, T) f32 series, lengths (S,) i32,
    series (N, B) i32 rows of y, default_mib (N,) f32, k_eff (N,) i32, all on
    one device.  Returns (waste (N, M, B), retries (N, M, B))."""
    methods = _check_methods(methods)
    _check_error_mode(error_mode, insample_window)
    # the two ranges name the phases in a torch.profiler trace
    with torch.profiler.record_function("torch_sim.predict"):
        bounds, values = predict_lanes(
            u, y, lengths, series, default_mib, k_eff, methods=methods, k=k, interval_s=interval_s,
            floor_mib=floor_mib, cap_mib=cap_mib, error_mode=error_mode, insample_window=insample_window,
        )
    with torch.profiler.record_function("torch_sim.replay"):
        return _replay(y, lengths, series, bounds, values, k_eff, methods=methods, interval_s=interval_s,
                       factor=factor, cap_mib=cap_mib)


def ladder_lanes(u, y, lengths, series, default_mib, k_eff, *, methods, k, interval_s, factor, floor_mib, cap_mib,
                 error_mode, insample_window, max_attempts):
    """Every execution's full retry ladder for every method, over N lanes
    (the counterpart of the reference's ``simulate_task_ladders``).

    Arguments as ``simulate_lanes``; ``u`` and ``default_mib`` carry the
    working dtype (float32, or float64 for the x64 ladders) while ``y`` stays
    float32.  Attempt wastage is summed in float64 either way, as the
    reference sums it under its x64 context.  Returns a dict of (N, M, B,
    ...) tensors: ``boundaries`` (..., k), ``values`` (..., A, k),
    ``failure_index`` (..., A), ``wastage_gib_s`` (..., A), ``n_attempts``."""
    methods = _check_methods(methods)
    _check_error_mode(error_mode, insample_window)
    with torch.profiler.record_function("torch_sim.predict"):
        bounds, values = predict_lanes(
            u, y, lengths, series, default_mib, k_eff, methods=methods, k=k, interval_s=interval_s,
            floor_mib=floor_mib, cap_mib=cap_mib, error_mode=error_mode, insample_window=insample_window,
        )
    with torch.profiler.record_function("torch_sim.replay"):
        _, _, (vbuf, fbuf, wbuf, natt) = _replay(
            y, lengths, series, bounds, values, k_eff, methods=methods, interval_s=interval_s, factor=factor,
            cap_mib=cap_mib, max_attempts=max_attempts, acc_dtype=torch.float64,
        )
    return {
        "boundaries": bounds.transpose(1, 2),
        "values": vbuf,
        "failure_index": fbuf,
        "wastage_gib_s": wbuf,
        "n_attempts": natt,
    }


def simulate_task_methods(
    x,
    y,
    lengths,
    default_mib,
    k_eff=None,
    *,
    methods: tuple[str, ...] = ENGINE_METHODS,
    k: int = 4,
    interval_s: float = 2.0,
    factor: float = 2.0,
    floor_mib: float = 100.0,
    cap_mib: float = 128 * 1024.0,
    error_mode: str = "progressive",
    insample_window: int = 0,
    device=None,
):
    """Score every requested method on one task type's executions.

    Args: x (B,) input sizes, y (B, T) padded MiB series, lengths (B,),
    default_mib the workflow's static directive, k_eff the live segment
    count (defaults to k).  Returns (waste, retries): (M, B) tensors on the
    device.  Execution i is scored against each method's prediction from
    executions [0, i) (the default allocation at i = 0), so a training
    fraction is a slice at ``n_train``.
    """
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(x), dtype=torch.float32).to(dev)
    u = (x - x[0])[None]
    y = torch.as_tensor(np.asarray(y), dtype=torch.float32).to(dev).contiguous()
    lengths = torch.as_tensor(np.asarray(lengths), dtype=torch.int32).to(dev)
    B = y.shape[0]
    waste, retries = simulate_lanes(
        u,
        y,
        lengths,
        torch.arange(B, dtype=torch.int32, device=dev)[None],
        torch.tensor([float(default_mib)], dtype=torch.float32, device=dev),
        torch.tensor([k if k_eff is None else int(k_eff)], dtype=torch.int32, device=dev),
        methods=methods,
        k=k,
        interval_s=interval_s,
        factor=factor,
        floor_mib=floor_mib,
        cap_mib=cap_mib,
        error_mode=error_mode,
        insample_window=insample_window,
    )
    return waste[0], retries[0]
