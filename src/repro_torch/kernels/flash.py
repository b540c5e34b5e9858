"""flash attention on the card: the launch wrapper of ``csrc/flash.cu``, and
its plain PyTorch version.

Replaces the TPU kernel ``repro/kernels/flash.py`` (``_flash_kernel`` /
``flash_attention_pallas``): the attention forward with online softmax,
position-based causal mask, sliding window, softcap and GQA, with
``k_pos = -1`` marking empty cache slots.  ``kernels.ops.flash_attention``
sends CUDA tensors to the kernel and CPU tensors to
``flash_attention_plain``, the reference's XLA path
(``repro/models/layers.py:flash_attention``): a loop over KV chunks of 1024
with the score matrix of one chunk at a time.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0  # kernel launches since the last ops.reset_launch_counts()

HEAD_DIMS = (16, 64, 80, 128, 256)  # every attention head_dim in configs/, and reduced()'s 16
NEG_INF = -1.0e30  # masked scores, as the reference (not -inf)
KV_CHUNK = 1024

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_fn = None


def flash_attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    *,
    causal: bool,
    window: int | None,
    softcap: float | None,
    kv_chunk: int = KV_CHUNK,
) -> torch.Tensor:
    """q (B, T, H, hd); k, v (B, S, KV, hd) with H % KV == 0; q_pos (B, T);
    k_pos (B, S), -1 marks empty slots.  Returns (B, T, H, hd) in q.dtype.

    Scores and the PV product take the operands' values in f32 (the
    reference's ``preferred_element_type``); ``p`` is rounded to v's type
    before the PV product, the running sum takes it unrounded."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd**-0.5
    qf = q.float()
    q_pos = q_pos.expand(B, T)[:, :, None]
    m = torch.full((B, T, H), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((B, T, H), dtype=torch.float32, device=q.device)
    acc = torch.zeros((B, T, H, hd), dtype=torch.float32, device=q.device)
    for c0 in range(0, S, kv_chunk):
        kx = k[:, c0 : c0 + kv_chunk].repeat_interleave(G, dim=2).float()
        vx = v[:, c0 : c0 + kv_chunk].repeat_interleave(G, dim=2).float()
        pc = k_pos[:, None, c0 : c0 + kv_chunk]  # (B, 1, C)
        s = torch.einsum("bthd,bchd->bthc", qf, kx) * scale
        if softcap is not None:
            s = softcap * torch.tanh(s / softcap)
        ok = pc >= 0
        if causal:
            ok = ok & (pc <= q_pos)
        if window is not None:
            ok = ok & (pc > q_pos - window)
        s = torch.where(ok[:, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bthc,bchd->bthd", p.to(v.dtype).float(), vx)
        m = m_new
    out = acc / torch.clamp(l, min=1e-30)[..., None]
    return out.to(q.dtype)


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("flash").flash_launch
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p, p, p, p, p, p, i, i, i, i, i, i, i, f, i, i, f, p]
        fn.restype = i
        _fn = fn
    return _fn


def flash_attention_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    *,
    causal: bool,
    window: int | None,
    softcap: float | None,
) -> torch.Tensor:
    """The kernel: q (B, T, H, hd), k/v (B, S, KV, hd) in f32 or bf16,
    q_pos (B, T) and k_pos (B, S) int32, all contiguous on one card ->
    (B, T, H, hd) in q's type."""
    global launches
    dev, dt = q.device, q.dtype
    if dt not in _DTYPES:
        raise ValueError(f"flash: need float32 or bfloat16 operands, got {dt}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.check_arg(name, t, dt, 4, dev)
    build.check_arg("q_pos", q_pos, torch.int32, 2, dev)
    build.check_arg("k_pos", k_pos, torch.int32, 2, dev)
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash: head_dim {hd} has no kernel instance (one of {HEAD_DIMS})")
    if (
        tuple(k.shape) != (B, S, KV, hd) or tuple(v.shape) != (B, S, KV, hd) or KV < 1 or H % KV
        or tuple(q_pos.shape) != (B, T) or tuple(k_pos.shape) != (B, S) or B * KV > 65535
    ):
        raise ValueError(f"flash: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"q_pos {tuple(q_pos.shape)}, k_pos {tuple(k_pos.shape)}")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash: q, k and v must start on a 16-byte boundary")
    out = torch.empty_like(q)
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(), k_pos.data_ptr(), out.data_ptr(),
        B, T, S, H, KV, hd, _DTYPES[dt], hd**-0.5, int(causal), int(window or 0), float(softcap or 0.0),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash launch failed with CUDA error {err}")
    launches += 1
    return out
