"""compaction on the card: the launch wrapper of ``csrc/compaction.cu``, and
its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/compaction.py`` (``compact_pallas``):
stable front-compaction of sorted ``(time, delta)`` event rows by a keep
mask, ``(+inf, 0)`` behind -- the sweep program's chunk-boundary step that
keeps its carried timelines sized by live breakpoints
(``repro_torch.sim.device_timeline``).  ``kernels.ops.compact_events`` picks
between the kernel and ``compact_events_plain`` by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0  # kernel launches since the last ops.reset_launch_counts()

_DTYPES = {torch.float32: 0, torch.float64: 1}
_fn = None


def compact_events_plain(t: torch.Tensor, d: torch.Tensor, keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain version: (B, L) rows and bool keep mask -> compacted rows.
    Kept entries go to their rank (``cumsum`` of the mask) by one
    ``scatter``; dropped ones to a spare column that is cut off."""
    B, L = t.shape
    tgt = torch.where(keep, torch.cumsum(keep.to(torch.int64), dim=1) - 1, L)
    t2 = torch.full((B, L + 1), torch.inf, dtype=t.dtype, device=t.device).scatter_(1, tgt, t)
    d2 = torch.zeros((B, L + 1), dtype=d.dtype, device=d.device).scatter_(1, tgt, d)
    return t2[:, :L], d2[:, :L]


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("compaction").compaction_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, p, p, p]
        fn.restype = i
        _fn = fn
    return _fn


def compaction_cuda(t: torch.Tensor, d: torch.Tensor, keep: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """t, d (B, L) f32 or f64 and keep (B, L) bool on the card -> compacted (t, d)."""
    global launches
    if t.dtype not in _DTYPES:
        raise ValueError(f"compaction: need float32 or float64, got {t.dtype}")
    dev = t.device
    build.check_arg("t", t, t.dtype, 2, dev)
    build.check_arg("d", d, t.dtype, 2, dev)
    build.check_arg("keep", keep, torch.bool, 2, dev)
    if d.shape != t.shape or keep.shape != t.shape:
        raise ValueError(f"compaction: shapes t {tuple(t.shape)}, d {tuple(d.shape)}, keep {tuple(keep.shape)}")
    B, L = t.shape
    t2, d2 = torch.empty_like(t), torch.empty_like(d)
    err = _launcher()(t.data_ptr(), d.data_ptr(), keep.data_ptr(), B, L, _DTYPES[t.dtype], t2.data_ptr(),
                      d2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"compaction launch failed with CUDA error {err}")
    launches += 1
    return t2, d2
