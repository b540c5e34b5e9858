"""MoE combine on the card: the launch wrapper of ``csrc/moe_combine.cu``,
and its plain PyTorch version.

No TPU kernel: replaces the reference's weighted gather and scatter-add
into ``out``, which it leaves to XLA (``repro/models/layers.py``,
``_moe_dispatch_compute`` and ``moe``).  ``kernels.ops.moe_combine`` sends
CUDA tensors to the kernel and CPU tensors to ``moe_combine_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0  # kernel launches since the last ops.reset_launch_counts()

MAX_K = 64  # assignments a token at most (csrc/moe_combine.cu:kMaxK)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def moe_combine_plain(out_buf: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor,
                      weights: torch.Tensor) -> torch.Tensor:
    """out_buf (E, C, D), ids / pos (N, k) int, weights (N, k) f32 -> out
    (N, D) in out_buf's dtype.

    Token n starts from zero and adds ``out_buf[e, pos] * w`` over its kept
    assignments (``0 <= e < E``, ``0 <= pos < C``) in ascending expert id,
    ``w`` rounded to the dtype first: eager ops, so each multiply and each
    add rounds to the dtype, as the reference's scatter-add does in its
    expert-sorted order."""
    E, C, D = out_buf.shape
    N, k = ids.shape
    order = torch.argsort(ids, dim=1, stable=True)
    e, p, w = (t.gather(1, order) for t in (ids.long(), pos.long(), weights))
    keep = (e >= 0) & (e < E) & (p >= 0) & (p < C)
    rows = out_buf.reshape(E * C, D)
    flat = torch.where(keep, e * C + p, 0)
    out = torch.zeros((N, D), dtype=out_buf.dtype, device=out_buf.device)
    for j in range(k):
        term = rows[flat[:, j]] * w[:, j, None].to(out_buf.dtype)
        out = torch.where(keep[:, j, None], out + term, out)
    return out


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("moe_combine").moe_combine_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, i, i, i, p, p, p, i, i, i, p, p]
        fn.restype = i
        _fn = fn
    return _fn


def moe_combine_cuda(out_buf: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor,
                     weights: torch.Tensor) -> torch.Tensor:
    """``moe_combine_plain`` on the card, bit for bit: one launch, a block
    per token."""
    global launches
    build.check_cuda("moe_combine", out_buf)
    dev = out_buf.device
    if out_buf.dtype not in _DTYPES:
        raise ValueError(f"moe_combine: out_buf must be float32 or bfloat16, got {out_buf.dtype}")
    build.check_arg("out_buf", out_buf, out_buf.dtype, 3, dev)
    build.check_arg("ids", ids, torch.int32, 2, dev)
    build.check_arg("pos", pos, torch.int32, 2, dev)
    build.check_arg("weights", weights, torch.float32, 2, dev)
    E, C, D = out_buf.shape
    N, k = ids.shape
    if pos.shape != ids.shape or weights.shape != ids.shape or k > MAX_K:
        raise ValueError(f"moe_combine: ids {tuple(ids.shape)}, pos {tuple(pos.shape)}, weights "
                         f"{tuple(weights.shape)} (k at most {MAX_K})")
    out = torch.empty((N, D), dtype=out_buf.dtype, device=dev)
    err = _launcher()(out_buf.data_ptr(), E, C, D, ids.data_ptr(), pos.data_ptr(), weights.data_ptr(), N, k,
                      _DTYPES[out_buf.dtype], out.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_combine launch failed with CUDA error {err}")
    launches += 1
    return out
