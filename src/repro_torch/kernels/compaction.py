"""compaction on the card: the launch wrappers of ``csrc/compaction.cu``,
and their plain PyTorch versions.

Replaces the TPU kernel ``repro/kernels/compaction.py`` (``compact_pallas``):
stable front-compaction of sorted ``(time, delta)`` event rows by a keep
mask, ``(+inf, 0)`` behind (``compaction_cuda``, ``compact_events_plain``).
The sweep program's chunk-boundary step that keeps its carried timelines
sized by live breakpoints (``repro_torch.sim.device_timeline``) runs it
inside a fold of the events up to each lane's clock, with three running
sums in XLA's order around it: ``fold_compact_cuda`` does that whole step
in one launch, ``fold_compact_plain`` is its plain chain.
``kernels.ops.compact_events`` and ``kernels.ops.fold_compact`` pick
between kernel and plain version by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.rangemax import masked_demand
from repro_torch.kernels.scan import xla_cumsum

launches = 0  # kernel launches since the last ops.reset_launch_counts()

_DTYPES = {torch.float32: 0, torch.float64: 1}
_fns: dict = {}  # launcher name -> its ctypes function


def compact_events_plain(t: torch.Tensor, d: torch.Tensor, keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (B, L) rows and bool keep mask -> compacted rows.
    Kept entries go to their rank (``cumsum`` of the mask) by one
    ``scatter``; dropped ones to a spare column that is cut off."""
    B, L = t.shape
    tgt = torch.where(keep, torch.cumsum(keep.to(torch.int64), dim=1) - 1, L)
    t2 = torch.full((B, L + 1), torch.inf, dtype=t.dtype, device=t.device).scatter_(1, tgt, t)
    d2 = torch.zeros((B, L + 1), dtype=d.dtype, device=d.device).scatter_(1, tgt, d)
    return t2[:, :L], d2[:, :L]


def fold_compact_plain(t: torch.Tensor, d: torch.Tensor, base: torch.Tensor, now: torch.Tensor, n_nodes: int):
    """Plain version of the sweep's chunk-boundary fold.  Rows are nodes:
    row r is node ``r % n_nodes`` of lane ``r // n_nodes``, t, d (R, L)
    its sorted event times (+inf padded) and deltas, base (R,) its base
    demand, now (R / n_nodes,) the lanes' clocks.  Folds the events at or
    before the clock into the base, shifts them out, keeps the events whose
    delta changes the running sum's bits, and front-compacts them.

    Returns (base (R,), t, d, csm (R, L), kept (R,) int64): csm is the
    compacted row's running demand masked to -inf off tie-group-final
    events, kept the row's kept count.  Every sum is in XLA's order."""
    L = t.shape[-1]
    le = t <= now.repeat_interleave(n_nodes)[:, None]
    cnt = le.to(torch.int64).cumprod(dim=-1).sum(dim=-1, keepdim=True)  # the prefix at or before the clock
    gain = torch.gather(xla_cumsum(d), -1, torch.clamp(cnt - 1, min=0))
    base = base + torch.where(cnt > 0, gain, 0.0)[:, 0]
    idx = torch.arange(L, device=t.device) + cnt
    ahead = idx < L
    idxc = torch.clamp(idx, max=L - 1)
    t = torch.where(ahead, torch.gather(t, -1, idxc), torch.inf)
    d = torch.where(ahead, torch.gather(d, -1, idxc), 0.0)
    cs = base[:, None] + xla_cumsum(d)
    keep = torch.isfinite(t) & (cs != torch.cat([base[:, None], cs[:, :-1]], dim=-1))
    t, d = compact_events_plain(t, d, keep)
    return base, t, d, masked_demand(t, d, base), keep.sum(dim=-1)


def _launcher(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.library("compaction"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {"compaction_launch": [p, p, p, i, i, i, p, p, p],
                       "fold_compact_launch": [p, p, p, p, i, i, i, i, p, p, p, p, p, p, p],
                       "fold_compact_scratch": [i, i]}[name]
        fn.restype = ctypes.c_longlong if name == "fold_compact_scratch" else i
        _fns[name] = fn
    return fn


def _dtype_code(x: torch.Tensor) -> int:
    if x.dtype not in _DTYPES:
        raise ValueError(f"compaction: need float32 or float64, got {x.dtype}")
    return _DTYPES[x.dtype]


def compaction_cuda(t: torch.Tensor, d: torch.Tensor, keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """t, d (B, L) f32 or f64 and keep (B, L) bool on the card -> compacted (t, d)."""
    global launches
    build.check_cuda("compaction", t)
    code = _dtype_code(t)
    dev = t.device
    build.check_arg("t", t, t.dtype, 2, dev)
    build.check_arg("d", d, t.dtype, 2, dev)
    build.check_arg("keep", keep, torch.bool, 2, dev)
    if d.shape != t.shape or keep.shape != t.shape:
        raise ValueError(f"compaction: shapes t {tuple(t.shape)}, d {tuple(d.shape)}, keep {tuple(keep.shape)}")
    B, L = t.shape
    t2, d2 = torch.empty_like(t), torch.empty_like(d)
    err = _launcher("compaction_launch")(t.data_ptr(), d.data_ptr(), keep.data_ptr(), B, L, code, t2.data_ptr(),
                                         d2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"compaction launch failed with CUDA error {err}")
    launches += 1
    return t2, d2


def fold_compact_cuda(t: torch.Tensor, d: torch.Tensor, base: torch.Tensor, now: torch.Tensor, n_nodes: int):
    """The sweep's chunk-boundary fold on the card, one launch for all R
    rows: arguments and results as ``fold_compact_plain`` (f32 or f64)."""
    global launches
    build.check_cuda("fold_compact", t)
    code = _dtype_code(t)
    dev = t.device
    build.check_arg("t", t, t.dtype, 2, dev)
    build.check_arg("d", d, t.dtype, 2, dev)
    build.check_arg("base", base, t.dtype, 1, dev)
    build.check_arg("now", now, t.dtype, 1, dev)
    R, L = t.shape
    if d.shape != t.shape or base.shape != (R,) or n_nodes < 1 or now.shape[0] * n_nodes != R:
        raise ValueError(f"fold_compact: shapes t {tuple(t.shape)}, d {tuple(d.shape)}, base {tuple(base.shape)}, "
                         f"now {tuple(now.shape)}, n_nodes {n_nodes}")
    row = _launcher("fold_compact_scratch")(L, code)
    scratch = torch.empty((R, row), dtype=torch.uint8, device=dev) if row > 0 else None
    base2 = torch.empty(R, dtype=t.dtype, device=dev)
    t2, d2, csm = (torch.empty((R, L), dtype=t.dtype, device=dev) for _ in range(3))
    kept = torch.empty(R, dtype=torch.int64, device=dev)
    err = _launcher("fold_compact_launch")(
        t.data_ptr(), d.data_ptr(), base.data_ptr(), now.data_ptr(), R, n_nodes, L, code, base2.data_ptr(),
        t2.data_ptr(), d2.data_ptr(), csm.data_ptr(), kept.data_ptr(), scratch.data_ptr() if row > 0 else None,
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fold_compact launch failed with CUDA error {err}")
    launches += 1
    return base2, t2, d2, csm, kept
