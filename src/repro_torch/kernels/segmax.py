"""segmax on the card: the launch wrapper of ``csrc/segmax.cu``.

Replaces the TPU kernel ``repro/kernels/segmax.py`` (``segmax_pallas``).
Its plain PyTorch version is ``repro_torch.core.segmentation.
segment_peaks_dynamic``; ``kernels.ops.segment_peaks`` picks between them by
the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0  # kernel launches since the last ops.reset_launch_counts()

_fn = None


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("segmax").segmax_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, p, p, p, i, i, p, p]
        fn.restype = i
        _fn = fn
    return _fn


def segmax_cuda(
    y: torch.Tensor, lengths: torch.Tensor, series: torch.Tensor, k_eff: torch.Tensor, k_max: int
) -> torch.Tensor:
    """y (S, T) f32, lengths (S,) i32, series/k_eff (R,) i32 -> (R, k_max) f32 peaks."""
    global launches
    build.check_cuda("segmax", y)
    dev = y.device
    build.check_arg("y", y, torch.float32, 2, dev)
    build.check_arg("lengths", lengths, torch.int32, 1, dev)
    build.check_arg("series", series, torch.int32, 1, dev)
    build.check_arg("k_eff", k_eff, torch.int32, 1, dev)
    S, T = y.shape
    R = series.shape[0]
    if lengths.shape[0] != S or k_eff.shape[0] != R or k_max < 1:
        raise ValueError(f"segmax: shapes y {tuple(y.shape)}, lengths {tuple(lengths.shape)}, "
                         f"series {tuple(series.shape)}, k_eff {tuple(k_eff.shape)}, k_max {k_max}")
    out = torch.empty((R, k_max), dtype=torch.float32, device=dev)
    err = _launcher()(
        y.data_ptr(), T, lengths.data_ptr(), series.data_ptr(), k_eff.data_ptr(), k_max, R, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"segmax launch failed with CUDA error {err}")
    launches += 1
    return out
