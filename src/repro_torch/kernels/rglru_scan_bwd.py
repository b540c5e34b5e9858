"""The RG-LRU recurrence's backward on the card: the launch wrapper of
``csrc/rglru_scan_bwd.cu``, its plain PyTorch version, and the autograd
function that joins it to the forward (``csrc/rglru_scan.cu``).

No TPU kernel: replaces the gradient that JAX's autodiff takes of the
recurrence the reference leaves to XLA (``repro/models/recurrent.py``,
``rglru_block``'s ``lax.associative_scan``).  On the card
``kernels.ops.rglru_scan`` goes through ``RGLRUScan`` where autograd
records the call; on the CPU autograd runs through
``rglru_scan.rglru_scan_plain``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, rglru_scan

launches = 0  # kernel launches since the last ops.reset_launch_counts()

_fn = None


def rglru_scan_bwd_plain(a: torch.Tensor, h0: torch.Tensor, h_seq: torch.Tensor, dh_seq: torch.Tensor,
                         dh_last: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradient of ``h_t = a_t h_{t-1} + b_t``: a, h_seq, dh_seq (B, T,
    R) f32, h0, dh_last (B, R) -> (da, db (B, T, R), dh0 (B, R)).  In
    reverse token order from c = dh_last: g = dh_seq_t + c, da_t = g
    h_{t-1} (h0 before the first token), db_t = g, c = a_t g; dh0 the last
    c.  Each multiply and add rounds on its own, in that order."""
    da, db = torch.empty_like(a), torch.empty_like(a)
    c = dh_last
    for t in range(a.shape[1] - 1, -1, -1):
        g = dh_seq[:, t] + c
        da[:, t] = g * (h_seq[:, t - 1] if t else h0)
        db[:, t] = g
        c = a[:, t] * g
    return da, db, c


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("rglru_scan_bwd").rglru_scan_bwd_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, i, i, i, p, p, p, p]
        fn.restype = i
        _fn = fn
    return _fn


def rglru_scan_bwd_cuda(a: torch.Tensor, h0: torch.Tensor, h_seq: torch.Tensor, dh_seq: torch.Tensor,
                        dh_last: torch.Tensor, need_a: bool = True, need_b: bool = True,
                        need_h0: bool = True) -> tuple[torch.Tensor | None, torch.Tensor | None, torch.Tensor | None]:
    """``rglru_scan_bwd_plain`` on the card, bit for bit: one launch, a
    block per (batch row, 32 channels) whose chain warp runs the
    channels in reverse token order, fed and drained by TMA copies through
    a ring of stages (4-byte copies for rows TMA cannot take: any
    alignment).  Only the gradients asked for are written; the others are
    None."""
    global launches
    build.check_cuda("rglru_scan_bwd", a)
    dev = a.device
    for name, t in (("a", a), ("h_seq", h_seq), ("dh_seq", dh_seq)):
        build.check_arg(name, t, torch.float32, 3, dev)
    build.check_arg("h0", h0, torch.float32, 2, dev)
    build.check_arg("dh_last", dh_last, torch.float32, 2, dev)
    B, T, R = a.shape
    if T < 1 or h_seq.shape != a.shape or dh_seq.shape != a.shape or h0.shape != (B, R) or dh_last.shape != (B, R):
        raise ValueError(f"rglru_scan_bwd: a {tuple(a.shape)}, h0 {tuple(h0.shape)}, h_seq {tuple(h_seq.shape)}, "
                         f"dh_seq {tuple(dh_seq.shape)}, dh_last {tuple(dh_last.shape)}")
    da = torch.empty_like(a) if need_a else None
    db = torch.empty_like(a) if need_b else None
    dh0 = torch.empty_like(h0) if need_h0 else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _launcher()(a.data_ptr(), h0.data_ptr(), h_seq.data_ptr(), dh_seq.data_ptr(), dh_last.data_ptr(), B, T, R,
                      ptr(da), ptr(db), ptr(dh0), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan_bwd launch failed with CUDA error {err}")
    launches += 1
    return da, db, dh0


class RGLRUScan(torch.autograd.Function):
    """The RG-LRU recurrence on the card with its gradient: the forward
    kernel, then ``rglru_scan_bwd_cuda`` for what ``needs_input_grad``
    asks (b itself is not needed).  Nothing of it calls a plain version."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h_seq, h_last = rglru_scan.rglru_scan_cuda(a, b, h0)
        ctx.save_for_backward(a, h0, h_seq)
        return h_seq, h_last

    @staticmethod
    def backward(ctx, dh_seq, dh_last):
        a, h0, h_seq = ctx.saved_tensors
        need_a, need_b, need_h0 = ctx.needs_input_grad
        return rglru_scan_bwd_cuda(a, h0, h_seq, dh_seq.contiguous(), dh_last.contiguous(), need_a, need_b,
                                   need_h0)
