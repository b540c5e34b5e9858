"""wastage on the card: the launch wrappers of ``csrc/wastage.cu``, and the
plain version of its retry ladder.

Replaces the TPU kernel ``repro/kernels/wastage.py`` (``wastage_pallas``):
an allocation attempt's first OOM sample and GiB*s wastage.  Its plain
version is ``repro_torch.core.allocation.attempt_outcomes_batch``;
``kernels.ops.attempt_wastage`` picks between them by the tensors' device.
The same kernel also runs whole retry ladders, the reference's
``jax_sim._replay_multi``: ``replay_ladder_cuda`` in one launch, against
``replay_ladder_plain``, a host loop of rounds (``kernels.ops.
replay_ladder`` picks).  One source, three precisions (schedule/sums):
f32/f32 for the grid, f32/f64 and f64/f64 for the cluster's retry ladders.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.core.allocation import attempt_outcomes_batch
from repro_torch.kernels import build

MAX_K = 128  # kMaxK in csrc/wastage.cu
MAX_RETRIES = 64  # kMaxRetries in csrc/wastage.cu: the reference engine's bound
MAX_METHODS = 32  # method rows per execution: bits of the kernel's retry-mode masks
# (schedule dtype, accumulator dtype) -> the ``precision`` code of the launchers
_PRECISION = {
    (torch.float32, torch.float32): 0,
    (torch.float32, torch.float64): 1,
    (torch.float64, torch.float64): 2,
}

launches = 0  # kernel launches since the last ops.reset_launch_counts()

_fns: dict = {}  # launcher name -> its ctypes function


def _launcher(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.library("wastage"), name)
        p, i, u, d = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_double
        fn.argtypes = {
            "wastage_launch": [p, i, p, p, p, p, i, i, d, i, p, p, p],
            "ladder_launch": [p, i, p, p, p, p, i, i, i, i, p, u, u, d, d, d, i, i, p, p, p, p, p, p, p],
        }[name]
        fn.restype = i
        _fns[name] = fn
    return fn


def _precision(vdt: torch.dtype, acc: torch.dtype) -> int:
    precision = _PRECISION.get((vdt, acc))
    if precision is None:
        raise ValueError(f"wastage: no instantiation for schedule {vdt} with sums in {acc}")
    return precision


def _check_series(y: torch.Tensor, lengths: torch.Tensor, dev: torch.device) -> None:
    build.check_arg("y", y, torch.float32, 2, dev)
    build.check_arg("lengths", lengths, torch.int32, 1, dev)
    if lengths.shape[0] != y.shape[0]:
        raise ValueError(f"wastage: y {tuple(y.shape)} but lengths {tuple(lengths.shape)}")


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} launch failed with CUDA error {err}")


def wastage_cuda(
    y: torch.Tensor,
    lengths: torch.Tensor,
    series: torch.Tensor,
    bounds: torch.Tensor,
    values: torch.Tensor,
    interval_s: float,
    acc_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One attempt per row: y (S, T) f32, lengths (S,) i32, series (R,) i32,
    bounds/values (R, k) f32 or f64 -> (waste GiB*s (R,) in ``acc_dtype``
    (default: the schedule's), fail index (R,) i32, -1 on success)."""
    global launches
    dev = y.device
    vdt = values.dtype
    acc = acc_dtype or vdt
    precision = _precision(vdt, acc)
    _check_series(y, lengths, dev)
    build.check_arg("series", series, torch.int32, 1, dev)
    build.check_arg("bounds", bounds, vdt, 2, dev)
    build.check_arg("values", values, vdt, 2, dev)
    T = y.shape[1]
    R, k = values.shape
    if series.shape[0] != R or bounds.shape != values.shape or not 1 <= k <= MAX_K:
        raise ValueError(f"wastage: shapes series {tuple(series.shape)}, bounds {tuple(bounds.shape)}, "
                         f"values {tuple(values.shape)}")
    waste = torch.empty((R,), dtype=acc, device=dev)
    fail_idx = torch.empty((R,), dtype=torch.int32, device=dev)
    err = _launcher("wastage_launch")(
        y.data_ptr(), T, lengths.data_ptr(), series.data_ptr(), bounds.data_ptr(), values.data_ptr(), k, R,
        float(interval_s), precision, waste.data_ptr(), fail_idx.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on(err, "wastage")
    launches += 1
    return waste, fail_idx


def _bits(flags) -> int:
    return sum(1 << m for m, f in enumerate(flags) if f)


def replay_ladder_cuda(y, lengths, series, bounds, values, k_eff, selective, cap_jump, *, interval_s, factor,
                       cap_mib, max_attempts=None, acc_dtype=None):
    """The whole retry ladder of every row in one launch; arguments and
    results as ``replay_ladder_plain``."""
    global launches
    build.check_cuda("replay_ladder", values)
    dev = values.device
    vdt = values.dtype
    acc = acc_dtype or vdt
    precision = _precision(vdt, acc)
    _check_series(y, lengths, dev)
    N, B, M, k = values.shape
    build.check_arg("series", series, torch.int32, 2, dev)
    build.check_arg("bounds", bounds, vdt, 4, dev)
    build.check_arg("values", values, vdt, 4, dev)
    build.check_arg("k_eff", k_eff, torch.int32, 1, dev)
    if (series.shape != (N, B) or bounds.shape != values.shape or k_eff.shape != (N,) or not 1 <= k <= MAX_K
            or not 1 <= M <= MAX_METHODS or len(selective) != M or len(cap_jump) != M):
        raise ValueError(f"replay_ladder: shapes series {tuple(series.shape)}, bounds {tuple(bounds.shape)}, "
                         f"values {tuple(values.shape)}, k_eff {tuple(k_eff.shape)}, {len(selective)} / "
                         f"{len(cap_jump)} retry flags")
    R = N * B * M
    record = max_attempts is not None
    A = int(max_attempts) if record else 0
    if record and A < 1:
        raise ValueError(f"replay_ladder: max_attempts must be >= 1, got {max_attempts}")
    waste = torch.empty((R,), dtype=acc, device=dev)
    retries = torch.empty((R,), dtype=torch.int32, device=dev)
    rec = ()
    if record:
        rec = (
            torch.empty((R, A, k), dtype=vdt, device=dev),
            torch.empty((R, A), dtype=torch.int32, device=dev),
            torch.empty((R, A), dtype=acc, device=dev),
            torch.empty((R,), dtype=torch.int64, device=dev),
        )
    if R:
        rec_ptrs = [t.data_ptr() for t in rec] if record else [None] * 4
        err = _launcher("ladder_launch")(
            y.data_ptr(), y.shape[1], lengths.data_ptr(), series.data_ptr(), bounds.data_ptr(), values.data_ptr(),
            k, N, B, M, k_eff.data_ptr(), _bits(selective), _bits(cap_jump), float(interval_s), float(factor),
            float(cap_mib), A, precision, waste.data_ptr(), retries.data_ptr(),
            *rec_ptrs,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        _raise_on(err, "replay_ladder")
        launches += 1
    return (waste, retries, rec) if record else (waste, retries)


def replay_ladder_plain(y, lengths, series, bounds, values, k_eff, selective, cap_jump, *, interval_s, factor,
                        cap_mib, max_attempts=None, acc_dtype=None):
    """Replay every (lane, execution, method) row with retries, in rounds:
    each round scores the rows still active (``attempt_outcomes_batch``); a
    failed row bumps its allocation (selective: the failed segment; partial:
    it and all later ones; cap jump: the node cap), capped and kept
    monotone, as the reference's ``_replay_multi``.

    y (S, T) f32, lengths (S,) i32, series (N, B) rows of y, bounds/values
    (N, B, M, k), k_eff (N,) i32, selective / cap_jump one flag per method.
    Returns (waste (R,), retries (R,) i32) over rows r = (n * B + b) * M + m,
    waste summed in ``acc_dtype`` (default: the values' dtype).  With
    ``max_attempts`` set, every attempt is also recorded: values (R, A, k),
    failure index (R, A) with -1 for success and for slots past the ladder,
    wastage (R, A) and n_attempts (R,); a row stops after A attempts, its
    last failure index then >= 0.  An empty execution succeeds at once with
    zero waste."""
    N, B, M, k = values.shape
    dev = values.device
    R = N * B * M
    acc = acc_dtype or values.dtype
    bounds = bounds.reshape(R, k)
    vals = torch.clamp(values.reshape(R, k), max=cap_mib)
    row_series = series.reshape(-1).repeat_interleave(M)
    row_keff = k_eff.repeat_interleave(B * M)
    row_sel = torch.tensor(selective, device=dev).repeat(N * B)
    row_cap = torch.tensor(cap_jump, device=dev).repeat(N * B)
    seg_pos = torch.arange(k, device=dev)
    waste = torch.zeros(R, dtype=acc, device=dev)
    retries = torch.zeros(R, dtype=torch.int32, device=dev)
    record = max_attempts is not None
    if record:
        A = int(max_attempts)
        vbuf = torch.zeros((R, A, k), dtype=values.dtype, device=dev)
        fbuf = torch.full((R, A), -1, dtype=torch.int32, device=dev)
        wbuf = torch.zeros((R, A), dtype=acc, device=dev)
        natt = torch.zeros(R, dtype=torch.int64, device=dev)
        active = torch.arange(R, device=dev)  # every row records its first attempt
    else:
        active = torch.nonzero(lengths[row_series] > 0).squeeze(1)
    while active.numel():
        b, v = bounds[active], vals[active]
        s = row_series[active]
        w, fail_idx = attempt_outcomes_batch(y[s], lengths[s], interval_s, b, v, acc)
        waste[active] += w
        if record:
            att = natt[active]
            vbuf[active, att] = v
            fbuf[active, att] = fail_idx
            wbuf[active, att] = w
            natt[active] += 1
        failed = fail_idx >= 0
        active = active[failed]
        if not active.numel():
            break
        b, v = b[failed], v[failed]
        t_fail = (fail_idx[failed].to(b.dtype) + 0.5) * interval_s
        seg = torch.minimum((t_fail[:, None] > b).sum(dim=1), row_keff[active] - 1)[:, None]
        bump_sel = torch.where(seg_pos == seg, v * factor, v)
        bump_par = torch.where(seg_pos >= seg, v * factor, v)
        bumped = torch.where(row_cap[active, None], cap_mib, torch.where(row_sel[active, None], bump_sel, bump_par))
        vals[active] = torch.clamp(torch.cummax(bumped, dim=1).values, max=cap_mib)
        retries[active] += 1
        go_on = retries[active] <= MAX_RETRIES
        if record:
            go_on &= natt[active] < A  # ladder buffer full
        active = active[go_on]
    if not record:
        return waste, retries
    return waste, retries, (vbuf, fbuf, wbuf, natt)
