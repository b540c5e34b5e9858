"""fitstats on the card: the launch wrapper of ``csrc/fitstats.cu``, and its
plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/fitstats.py`` (``_fitstats_kernel``
/ ``fitstats_pallas``): the weighted ``(k, 5)`` bank ``(n, Σu, Σu², Σy,
Σuy)`` of k segment regressions over a batch of pre-shifted input sizes
``u``, segment peaks ``y`` and row weights.  ``kernels.ops.fit_stats`` picks
between the kernel and ``fit_stats_plain`` by the tensors' device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0  # kernel launches since the last ops.reset_launch_counts()

MAX_K = 128  # kMaxK in csrc/fitstats.cu, the reference's K_PAD
THREADS = 256  # kThreads in csrc/fitstats.cu
MAX_BLOCKS = 1024  # pass 1's blocks at most: one wave of 256-thread blocks on 132 SMs
MIN_STEPS = 8  # rows a thread of pass 1 folds at least

_fn = None


def fit_stats_plain(x: torch.Tensor, peaks: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Plain version (the reference's ``ref.fit_stats``): x (B,), peaks
    (B, k), valid (B,) weights, all float32 -> (k, 5) float32."""
    w = valid.reshape(-1, 1)
    x = x.reshape(-1, 1)
    ones = torch.ones((peaks.shape[1],), dtype=peaks.dtype, device=peaks.device)
    n = torch.sum(w) * ones
    sx = torch.sum(w * x) * ones
    sxx = torch.sum(w * x * x) * ones
    sy = torch.sum(w * peaks, dim=0)
    sxy = torch.sum(w * x * peaks, dim=0)
    return torch.stack([n, sx, sxx, sy, sxy], dim=-1)


def grid(B: int, k: int) -> tuple[int, int]:
    """Pass 1's (rows per block, blocks) for a (B, k) batch: a fixed
    function of the shape, so the summation order (and the bits) are too."""
    rows = max((THREADS // k) * MIN_STEPS, -(-B // MAX_BLOCKS))
    return rows, max(-(-B // rows), 1)


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("fitstats").fitstats_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, i, p, p, p]
        fn.restype = i
        _fn = fn
    return _fn


def fitstats_cuda(x: torch.Tensor, peaks: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """x (B,), peaks (B, k), valid (B,) float32 on the card, 1 <= k <= 128
    -> (k, 5) float32 bank."""
    global launches
    dev = peaks.device
    build.check_arg("x", x, torch.float32, 1, dev)
    build.check_arg("peaks", peaks, torch.float32, 2, dev)
    build.check_arg("valid", valid, torch.float32, 1, dev)
    B, k = peaks.shape
    if x.shape[0] != B or valid.shape[0] != B or not 1 <= k <= MAX_K:
        raise ValueError(f"fitstats: shapes x {tuple(x.shape)}, peaks {tuple(peaks.shape)}, "
                         f"valid {tuple(valid.shape)} (need 1 <= k <= {MAX_K})")
    rows, blocks = grid(B, k)
    partial = torch.empty(((3 + 2 * k) * blocks,), dtype=torch.float32, device=dev)
    out = torch.empty((k, 5), dtype=torch.float32, device=dev)
    err = _launcher()(
        x.data_ptr(), peaks.data_ptr(), valid.data_ptr(), B, k, rows, blocks, partial.data_ptr(), out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"fitstats launch failed with CUDA error {err}")
    launches += 1
    return out
