"""MoE dispatch on the card: the launch wrapper of ``csrc/moe_dispatch.cu``,
and its plain PyTorch version.

No TPU kernel: replaces the reference's sort-based dispatch, which it
leaves to XLA (``repro/models/layers.py``, ``_moe_dispatch_compute`` and
``moe``: ``argsort`` over the flat expert ids, ``bincount``, ``cumsum``,
the scatter into ``buf``).  ``kernels.ops.moe_dispatch`` sends CUDA
tensors to the kernel and CPU tensors to ``moe_dispatch_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0  # calls that launched the kernel, since the last ops.reset_launch_counts()

_fn = None


def moe_dispatch_plain(xf: torch.Tensor, ids: torch.Tensor, E: int, C: int) -> tuple[torch.Tensor, torch.Tensor]:
    """xf (N, D), ids (N, k) int -> (buf (E, C, D) in xf's dtype, pos (N, k)
    int32).

    The reference's formula: assignment ``f = n * k + j`` takes its position
    in its expert in the order of f (``argsort(stable=True)``, as
    ``jnp.argsort`` is stable), from ``bincount`` and ``cumsum``.  ``pos``
    is -1 for an id outside ``[0, E)`` (another expert slice's).  An
    assignment with ``0 <= pos < C`` is kept and its token's row put at
    ``buf[e, pos]``; every other slot is zero."""
    N, k = ids.shape
    flat = ids.reshape(-1).long()
    in_slice = (flat >= 0) & (flat < E)
    key = torch.where(in_slice, flat, E)  # other slices sort to the end
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=E + 1)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.empty_like(flat)
    pos[order] = torch.arange(N * k, device=flat.device) - starts[key[order]]
    pos = torch.where(in_slice, pos, -1)
    keep = in_slice & (pos < C)
    buf = torch.zeros((E, C, xf.shape[1]), dtype=xf.dtype, device=xf.device)
    tok = torch.arange(N * k, device=flat.device) // k
    buf[flat[keep], pos[keep]] = xf[tok[keep]]
    return buf, pos.view(N, k).to(torch.int32)


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("moe_dispatch").moe_dispatch_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, p, i, i, i, p, p, p, p]
        fn.restype = i
        _fn = fn
    return _fn


def moe_dispatch_cuda(xf: torch.Tensor, ids: torch.Tensor, E: int, C: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``moe_dispatch_plain`` on the card: one call, two device launches (the
    rank pass a block per expert, then the gather a warp per slot row); buf
    bit for bit and pos exact."""
    global launches
    build.check_cuda("moe_dispatch", xf)
    dev = xf.device
    if xf.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"moe_dispatch: xf must be float32 or bfloat16, got {xf.dtype}")
    build.check_arg("xf", xf, xf.dtype, 2, dev)
    build.check_arg("ids", ids, torch.int32, 2, dev)
    N, D = xf.shape
    k = ids.shape[1]
    if ids.shape[0] != N or E < 1 or C < 1:
        raise ValueError(f"moe_dispatch: xf {tuple(xf.shape)}, ids {tuple(ids.shape)}, E {E}, C {C}")
    pos = torch.empty((N, k), dtype=torch.int32, device=dev)
    slot = torch.empty((E, C), dtype=torch.int32, device=dev)
    buf = torch.empty((E, C, D), dtype=xf.dtype, device=dev)
    err = _launcher()(xf.data_ptr(), N, D * xf.element_size(), ids.data_ptr(), k, E, C, pos.data_ptr(),
                      slot.data_ptr(), buf.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_dispatch launch failed with CUDA error {err}")
    launches += 1
    return buf, pos
