"""Prefix sums in a fixed order of additions: the plain version, and the
launch wrapper of ``csrc/scan.cu``.

The reference adds its running sums in two orders.  Its engine folds the
regression banks one execution after another (the ``lax.scan`` carry), and
its prefix programs call ``jnp.cumsum``, which XLA's CPU backend folds in
blocks of 16: sequentially within each block, then the block totals the same
way, recursively.  ``cumsum(a, block)`` adds in either order (``block >= n``
the scan's, ``block = 16`` XLA's), so every sum has the reference's bits;
``scan_cuda`` gives the same bits on the card in one launch (the scan's
order: a chain of adds a column, fed through shared memory; XLA's: a warp a
line, or a block a tile of 32 columns along a middle axis with many of
them), and ``kernels.ops.prefix_sum`` picks between the two by the
tensor's device.
The fit-table and fold kernels (``csrc/rangemax.cu``, ``csrc/compaction.cu``)
share the card's XLA order with it (``csrc/xla_scan.cuh``).
"""

from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

XLA_SCAN_BLOCK = 16

launches = 0  # kernel launches since the last ops.reset_launch_counts()

_DTYPES = {torch.float32: 0, torch.float64: 1}
_fns: dict = {}  # launcher name -> its ctypes function


def cumsum(a: torch.Tensor, block: int) -> torch.Tensor:
    """Inclusive prefix sum along the last axis: sequential within blocks of
    ``block``, plus the block totals' own prefix sum (the same way,
    recursively).  ``block >= n`` is one sequential fold, the order of a
    scan; ``block = 16`` is the order of XLA's CPU ``cumsum``."""
    n = a.shape[-1]
    if n <= block:
        out = torch.empty_like(a)
        acc = torch.zeros_like(a[..., 0])
        for i in range(n):
            acc = torch.add(acc, a[..., i], out=out[..., i])
        return out
    m = -(-n // block)
    local = cumsum(F.pad(a, (0, m * block - n)).reshape(*a.shape[:-1], m, block), block)
    totals = cumsum(local[..., -1], block)
    local += exclusive(totals)[..., None]
    return local.reshape(*a.shape[:-1], m * block)[..., :n]


def exclusive(incl: torch.Tensor, fill: float = 0.0) -> torch.Tensor:
    """Shift an inclusive prefix along the last axis by one, ``fill`` first."""
    return torch.cat([torch.full_like(incl[..., :1], fill), incl[..., :-1]], dim=-1)


def prefix_sum_plain(a: torch.Tensor, dim: int = -1, block: int = XLA_SCAN_BLOCK) -> torch.Tensor:
    """Plain version: ``cumsum(., block)`` along ``dim``."""
    return cumsum(a.movedim(dim, -1), block).movedim(-1, dim)


def xla_cumsum(a: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Inclusive prefix sum along ``dim`` in the order of XLA's CPU ``cumsum``."""
    return prefix_sum_plain(a, dim, XLA_SCAN_BLOCK)


def _launcher(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.library("scan"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {"scan_launch": [p, i, i, i, i, i, p, p, p], "scan_scratch": [i, i, i]}[name]
        fn.restype = ctypes.c_longlong if name == "scan_scratch" else i
        _fns[name] = fn
    return fn


def scan_cuda(a: torch.Tensor, dim: int = -1, block: int = XLA_SCAN_BLOCK) -> torch.Tensor:
    """``prefix_sum_plain(a, dim, block)`` on the card, bit for bit, in one
    launch: f32 or f64, ``block >= n`` (the scan's order) or 16 (XLA's).  A
    non-contiguous ``a`` is copied once first."""
    global launches
    build.check_cuda("scan", a)
    if a.dtype not in _DTYPES:
        raise ValueError(f"scan: need float32 or float64, got {a.dtype}")
    if a.dim() == 0:
        raise ValueError("scan: need at least one axis")
    dim %= a.dim()
    n = a.shape[dim]
    sequential = block >= n
    if not sequential and block != XLA_SCAN_BLOCK:
        raise ValueError(f"scan: block {block} is neither >= n ({n}) nor {XLA_SCAN_BLOCK}")
    a = a.contiguous()
    outer, inner = math.prod(a.shape[:dim]), math.prod(a.shape[dim + 1:])
    out = torch.empty(a.shape, dtype=a.dtype, device=a.device)
    if a.numel() == 0:
        return out
    code = _DTYPES[a.dtype]
    row = 0 if sequential else _launcher("scan_scratch")(n, inner, code)
    scratch = torch.empty((outer * inner, row), dtype=torch.uint8, device=a.device) if row > 0 else None
    err = _launcher("scan_launch")(a.data_ptr(), outer, n, inner, int(sequential), code, out.data_ptr(),
                                   scratch.data_ptr() if scratch is not None else None,
                                   torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"scan launch failed with CUDA error {err}")
    launches += 1
    return out
