"""rangemax on the card: the launch wrapper of ``csrc/rangemax.cu``, and its
plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/rangemax.py`` (``rangemax_pallas``):
the doubling range-max table ``out[..., p, i] = max(x[..., i : i + 2**p])``
(-inf past the row end) that the scheduling epoch's fit probes query in
O(log L) (``repro_torch.sim.device_timeline``).  ``kernels.ops.
range_max_table`` picks between the kernel and ``table_levels`` by the
tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0  # kernel launches since the last ops.reset_launch_counts()

_DTYPES = {torch.float32: 0, torch.float64: 1}
_fn = None


def num_levels(L: int) -> int:
    """Levels that answer any [l, r) window over an ``L``-long axis:
    ``floor(log2(L)) + 1``."""
    if L < 1:
        raise ValueError(f"rangemax: need L >= 1, got {L}")
    return L.bit_length()


def table_levels(x: torch.Tensor) -> torch.Tensor:
    """Plain version: (..., L) -> (..., P, L), one ``torch.maximum`` of
    each level with its copy shifted by the level's span."""
    L = x.shape[-1]
    levels = [x]
    span = 1
    for _ in range(1, num_levels(L)):
        prev = levels[-1]
        pad = torch.full((*prev.shape[:-1], span), -torch.inf, dtype=x.dtype, device=x.device)
        levels.append(torch.maximum(prev, torch.cat([prev[..., span:], pad], dim=-1)))
        span *= 2
    return torch.stack(levels, dim=-2)


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("rangemax").rangemax_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, i, p, p]
        fn.restype = i
        _fn = fn
    return _fn


def rangemax_cuda(x: torch.Tensor) -> torch.Tensor:
    """x (B, L) f32 or f64 on the card -> (B, P, L) table levels."""
    global launches
    if x.dtype not in _DTYPES:
        raise ValueError(f"rangemax: need float32 or float64, got {x.dtype}")
    build.check_arg("x", x, x.dtype, 2, x.device)
    B, L = x.shape
    P = num_levels(L)
    out = torch.empty((B, P, L), dtype=x.dtype, device=x.device)
    err = _launcher()(x.data_ptr(), B, L, P, _DTYPES[x.dtype], out.data_ptr(),
                      torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rangemax launch failed with CUDA error {err}")
    launches += 1
    return out
