"""The MoE combine's backward on the card: the launch wrapper of
``csrc/moe_combine_bwd.cu``, its plain PyTorch version, and the autograd
function that joins it to the forward (``csrc/moe_combine.cu``).

No TPU kernel: replaces the gradient that JAX's autodiff takes of the
reference's weighted gather and scatter-add into ``out``
(``repro/models/layers.py``, ``moe`` and ``_moe_dispatch_compute``).  On
the card ``kernels.ops.moe_combine`` goes through ``MoECombine`` where
autograd records the call; on the CPU autograd runs through
``moe_combine.moe_combine_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, moe_combine

launches = 0  # calls that launched the kernels, since the last ops.reset_launch_counts()

MAX_EXPERTS = 1024  # csrc/moe_combine_bwd.cu:kMaxExperts
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def moe_combine_bwd_plain(dout: torch.Tensor, out_buf: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor,
                          weights: torch.Tensor, need_buf: bool = True,
                          need_w: bool = True) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """The gradients of ``moe_combine_plain(out_buf, ids, pos, weights)``
    given its output's, dout (N, D) -> (d_out_buf (E, C, D) in out_buf's
    dtype, dw (N, k) f32), either None where not wanted.

    An assignment is kept when ``0 <= e < E`` and ``0 <= pos < C``.  A kept
    slot's row of d_out_buf is ``dout[n] * w`` with ``w`` rounded to the
    dtype first, the product rounded once; every other slot is zero.  A kept
    assignment's dw is ``sum_d out_buf[e, pos, d] * dout[n, d]``, each
    product rounded to the dtype and the sum to the dtype (f32 accumulation,
    as ``torch.sum``); a dropped one's is 0.  That is autograd's gradient
    through the forward's ``w.to(dtype)`` and its multiply."""
    E, C, D = out_buf.shape
    N, k = ids.shape
    e, p = ids.long(), pos.long()
    keep = (e >= 0) & (e < E) & (p >= 0) & (p < C)
    flat = torch.where(keep, e * C + p, 0)
    d_out_buf = dw = None
    if need_buf:
        d_rows = torch.zeros((E * C, D), dtype=out_buf.dtype, device=out_buf.device)
        wd = weights.to(out_buf.dtype)
        for j in range(k):
            sel = keep[:, j]
            d_rows[flat[sel, j]] = dout[sel] * wd[sel, j, None]
        d_out_buf = d_rows.view(E, C, D)
    if need_w:
        rows = out_buf.reshape(E * C, D)
        dw = torch.stack([(rows[flat[:, j]] * dout).sum(-1) for j in range(k)], 1).float()
        dw = torch.where(keep, dw, 0.0)
    return d_out_buf, dw


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("moe_combine_bwd").moe_combine_bwd_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, i, i, i, p, p, p, i, i, i, p, p, p, p]
        fn.restype = i
        _fn = fn
    return _fn


def moe_combine_bwd_cuda(dout: torch.Tensor, out_buf: torch.Tensor, ids: torch.Tensor, pos: torch.Tensor,
                         weights: torch.Tensor, need_buf: bool = True,
                         need_w: bool = True) -> tuple[torch.Tensor | None, torch.Tensor | None]:
    """``moe_combine_bwd_plain`` on the card: one launch (a count of each
    expert's kept slots, then a block per token and blocks for the empty
    slots); d_out_buf bit for bit, dw in another order of its sum.  ``pos``
    must be as ``moe_dispatch`` gives it: expert e's kept slots are the
    first ones of its row of C."""
    global launches
    build.check_cuda("moe_combine_bwd", dout)
    dev = dout.device
    if out_buf.dtype not in _DTYPES:
        raise ValueError(f"moe_combine_bwd: out_buf must be float32 or bfloat16, got {out_buf.dtype}")
    build.check_arg("dout", dout, out_buf.dtype, 2, dev)
    build.check_arg("out_buf", out_buf, out_buf.dtype, 3, dev)
    build.check_arg("ids", ids, torch.int32, 2, dev)
    build.check_arg("pos", pos, torch.int32, 2, dev)
    build.check_arg("weights", weights, torch.float32, 2, dev)
    E, C, D = out_buf.shape
    N, k = ids.shape
    if (dout.shape != (N, D) or pos.shape != ids.shape or weights.shape != ids.shape or k > moe_combine.MAX_K
            or not 1 <= E <= MAX_EXPERTS):
        raise ValueError(f"moe_combine_bwd: dout {tuple(dout.shape)}, out_buf {tuple(out_buf.shape)}, ids "
                         f"{tuple(ids.shape)}, pos {tuple(pos.shape)}, weights {tuple(weights.shape)} (k at most "
                         f"{moe_combine.MAX_K}, E at most {MAX_EXPERTS})")
    if not (need_buf or need_w):
        return None, None
    d_out_buf = torch.empty((E, C, D), dtype=out_buf.dtype, device=dev) if need_buf else None
    dw = torch.empty((N, k), dtype=torch.float32, device=dev) if need_w else None
    fill = torch.empty((E,), dtype=torch.int32, device=dev) if need_buf else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _launcher()(dout.data_ptr(), out_buf.data_ptr(), E, C, D, ids.data_ptr(), pos.data_ptr(),
                      weights.data_ptr(), N, k, _DTYPES[out_buf.dtype], ptr(d_out_buf), ptr(dw), ptr(fill),
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"moe_combine_bwd launch failed with CUDA error {err}")
    launches += 1
    return d_out_buf, dw


class MoECombine(torch.autograd.Function):
    """The MoE combine on the card with its gradient: the forward kernel,
    then ``moe_combine_bwd_cuda`` for what ``needs_input_grad`` asks.
    Nothing of it calls a plain version."""

    @staticmethod
    def forward(ctx, out_buf, ids, pos, weights):
        ctx.save_for_backward(out_buf, ids, pos, weights)
        return moe_combine.moe_combine_cuda(out_buf, ids, pos, weights)

    @staticmethod
    def backward(ctx, dout):
        out_buf, ids, pos, weights = ctx.saved_tensors
        need_buf, _, _, need_w = ctx.needs_input_grad
        d_out_buf, dw = moe_combine_bwd_cuda(dout.contiguous(), out_buf, ids, pos, weights, need_buf, need_w)
        return d_out_buf, None, None, dw
