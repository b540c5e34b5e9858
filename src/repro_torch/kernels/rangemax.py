"""rangemax on the card: the launch wrappers of ``csrc/rangemax.cu``, and
their plain PyTorch versions.

Replaces the TPU kernel ``repro/kernels/rangemax.py`` (``rangemax_pallas``):
the doubling range-max table ``out[..., p, i] = max(x[..., i : i + 2**p])``
(-inf past the row end) that the scheduling epoch's fit probes query in
O(log L) (``repro_torch.sim.device_timeline``).  The epoch program builds
it before every row from the nodes' event rows, after their running sums
(``fit_tables_cuda``, one launch; ``fit_tables_plain``).  ``kernels.ops.
range_max_table`` and ``kernels.ops.fit_tables`` pick between kernel and
plain version by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.scan import xla_cumsum

launches = 0  # kernel launches since the last ops.reset_launch_counts()

_DTYPES = {torch.float32: 0, torch.float64: 1}


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


def tie_last(tl_t: torch.Tensor) -> torch.Tensor:
    """Mask of tie-group-final positions along the last axis: the running
    sum after event i is a settled profile value only when no later event
    shares its instant."""
    return torch.cat([tl_t[..., :-1] != tl_t[..., 1:], torch.isfinite(tl_t[..., -1:])], dim=-1)


def masked_demand(tl_t: torch.Tensor, tl_d: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """The running demand after every event (``base`` (...,) included,
    summed in XLA's CPU order), masked to -inf off tie-group-final
    positions: (..., L) event rows -> (..., L)."""
    return torch.where(tie_last(tl_t), base[..., None] + xla_cumsum(tl_d), -torch.inf)


def fit_tables_plain(tl_t: torch.Tensor, tl_d: torch.Tensor, base0: torch.Tensor):
    """Plain version of the fit tables: ``masked_demand`` and its table
    levels, (N, L) rows -> (csm (N, L), tbl (N, P, L))."""
    csm = masked_demand(tl_t, tl_d, base0)
    return csm, table_levels(csm)


_fns: dict = {}  # launcher name -> its ctypes function


def _launcher(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.library("rangemax"), name)
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {"rangemax_launch": [p, i, i, i, i, p, p], "fit_tables_launch": [p, p, p, i, i, i, i, p, p]}[name]
        fn.restype = i
        _fns[name] = fn
    return fn


def _check_dtype(x: torch.Tensor) -> int:
    if x.dtype not in _DTYPES:
        raise ValueError(f"rangemax: need float32 or float64, got {x.dtype}")
    return _DTYPES[x.dtype]


def _raise_on(err: int) -> None:
    if err != 0:
        raise RuntimeError(f"rangemax launch failed with CUDA error {err}")


def rangemax_cuda(x: torch.Tensor) -> torch.Tensor:
    """x (B, L) f32 or f64 on the card -> (B, P, L) table levels."""
    global launches
    code = _check_dtype(x)
    build.check_arg("x", x, x.dtype, 2, x.device)
    B, L = x.shape
    P = num_levels(L)
    out = torch.empty((B, P, L), dtype=x.dtype, device=x.device)
    _raise_on(_launcher("rangemax_launch")(x.data_ptr(), B, L, P, code, out.data_ptr(),
                                           torch.cuda.current_stream(x.device).cuda_stream))
    launches += 1
    return out


def fit_tables_cuda(tl_t: torch.Tensor, tl_d: torch.Tensor, base0: torch.Tensor):
    """tl_t, tl_d (N, L), base0 (N,), f32 or f64 on the card -> (csm (N, L),
    tbl (N, P, L)) in one launch; csm is the table's level 0."""
    global launches
    build.check_cuda("fit_tables", tl_d)
    code = _check_dtype(tl_d)
    dev = tl_d.device
    build.check_arg("tl_t", tl_t, tl_d.dtype, 2, dev)
    build.check_arg("tl_d", tl_d, tl_d.dtype, 2, dev)
    build.check_arg("base0", base0, tl_d.dtype, 1, dev)
    N, L = tl_d.shape
    if tl_t.shape != tl_d.shape or base0.shape != (N,):
        raise ValueError(f"fit_tables: shapes tl_t {tuple(tl_t.shape)}, tl_d {tuple(tl_d.shape)}, "
                         f"base0 {tuple(base0.shape)}")
    P = num_levels(L)
    tbl = torch.empty((N, P, L), dtype=tl_d.dtype, device=dev)
    _raise_on(_launcher("fit_tables_launch")(tl_t.data_ptr(), tl_d.data_ptr(), base0.data_ptr(), N, L, P, code,
                                             tbl.data_ptr(), torch.cuda.current_stream(dev).cuda_stream))
    launches += 1
    return tbl[:, 0], tbl
