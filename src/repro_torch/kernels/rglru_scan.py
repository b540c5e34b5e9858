"""The RG-LRU's affine recurrence on the card: the launch wrapper of
``csrc/rglru_scan.cu``, and its plain PyTorch version.

No TPU kernel: replaces the recurrence of ``rglru_block``, which the
reference leaves to XLA (``repro/models/recurrent.py``: the
``lax.associative_scan`` of ``h_t = a_t h_{t-1} + b_t``, and the single
step at T = 1).  ``kernels.ops.rglru_scan`` sends CUDA tensors to the
kernel and CPU tensors to ``rglru_scan_plain``; both run the recurrence in
token order, each multiply and add rounded on its own, so they agree bit
for bit (the reference's tree differs from both by float32 rounding).
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0  # kernel launches since the last ops.reset_launch_counts()

_fn = None


def rglru_scan_plain(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """a, b (B, T, R) f32, h0 (B, R) f32 -> (h_seq (B, T, R), h_last (B, R)):
    ``h_t = a_t * h_{t-1} + b_t`` from ``h0``, a step at a time."""
    h, out = h0, []
    for t in range(a.shape[1]):
        h = a[:, t] * h + b[:, t]
        out.append(h)
    return torch.stack(out, dim=1), h


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("rglru_scan").rglru_scan_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, i, i, i, p, p, p]
        fn.restype = i
        _fn = fn
    return _fn


def rglru_scan_cuda(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``rglru_scan_plain`` on the card, bit for bit: one launch, a thread a
    channel in token order, a and b fed through a ring of asynchronous
    copies in shared memory (any alignment of the rows)."""
    global launches
    build.check_cuda("rglru_scan", a)
    dev = a.device
    build.check_arg("a", a, torch.float32, 3, dev)
    build.check_arg("b", b, torch.float32, 3, dev)
    build.check_arg("h0", h0, torch.float32, 2, dev)
    B, T, R = a.shape
    if T < 1 or b.shape != a.shape or h0.shape != (B, R):
        raise ValueError(f"rglru_scan: a {tuple(a.shape)}, b {tuple(b.shape)}, h0 {tuple(h0.shape)}")
    h_seq = torch.empty_like(a)
    h_last = torch.empty_like(h0)
    err = _launcher()(a.data_ptr(), b.data_ptr(), h0.data_ptr(), B, T, R, h_seq.data_ptr(), h_last.data_ptr(),
                      torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed with CUDA error {err}")
    launches += 1
    return h_seq, h_last
