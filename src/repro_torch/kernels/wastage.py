"""wastage on the card: the launch wrapper of ``csrc/wastage.cu``.

Replaces the TPU kernel ``repro/kernels/wastage.py`` (``wastage_pallas``).
Its plain PyTorch version is ``repro_torch.core.allocation.
attempt_outcomes_batch``; ``kernels.ops.attempt_wastage`` picks between them
by the tensors' device.  One source, three precisions (schedule/sums):
f32/f32 for the grid, f32/f64 and f64/f64 for the cluster's retry ladders.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

MAX_K = 128  # kMaxK in csrc/wastage.cu
# (schedule dtype, accumulator dtype) -> the ``precision`` code of wastage_launch
_PRECISION = {
    (torch.float32, torch.float32): 0,
    (torch.float32, torch.float64): 1,
    (torch.float64, torch.float64): 2,
}

launches = 0  # kernel launches since the last ops.reset_launch_counts()

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("wastage").wastage_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, p, i, i, ctypes.c_double, i, p, p, p]
        fn.restype = i
        _fn = fn
    return _fn


def wastage_cuda(
    y: torch.Tensor,
    lengths: torch.Tensor,
    series: torch.Tensor,
    bounds: torch.Tensor,
    values: torch.Tensor,
    interval_s: float,
    acc_dtype: torch.dtype | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """y (S, T) f32, lengths (S,) i32, series (R,) i32, bounds/values (R, k)
    f32 or f64 -> (waste GiB*s (R,) in ``acc_dtype`` (default: the
    schedule's), fail index (R,) i32, -1 on success)."""
    global launches
    dev = y.device
    vdt = values.dtype
    acc = acc_dtype or vdt
    precision = _PRECISION.get((vdt, acc))
    if precision is None:
        raise ValueError(f"wastage: no instantiation for schedule {vdt} with sums in {acc}")
    build.check_arg("y", y, torch.float32, 2, dev)
    build.check_arg("lengths", lengths, torch.int32, 1, dev)
    build.check_arg("series", series, torch.int32, 1, dev)
    build.check_arg("bounds", bounds, vdt, 2, dev)
    build.check_arg("values", values, vdt, 2, dev)
    S, T = y.shape
    R, k = values.shape
    if lengths.shape[0] != S or series.shape[0] != R or bounds.shape != values.shape or not 1 <= k <= MAX_K:
        raise ValueError(f"wastage: shapes y {tuple(y.shape)}, lengths {tuple(lengths.shape)}, "
                         f"series {tuple(series.shape)}, bounds {tuple(bounds.shape)}, values {tuple(values.shape)}")
    waste = torch.empty((R,), dtype=acc, device=dev)
    fail_idx = torch.empty((R,), dtype=torch.int32, device=dev)
    err = _launcher()(
        y.data_ptr(), T, lengths.data_ptr(), series.data_ptr(), bounds.data_ptr(), values.data_ptr(), k, R,
        float(interval_s), precision, waste.data_ptr(), fail_idx.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"wastage launch failed with CUDA error {err}")
    launches += 1
    return waste, fail_idx
