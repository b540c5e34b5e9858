"""flash attention's backward on the card: the launch wrapper of
``csrc/flash_bwd.cu``, its plain PyTorch version, and the autograd function
that joins it to the forward (``csrc/flash.cu``).

Replaces no TPU kernel: the reference trains through the XLA path of
``repro/models/layers.py:flash_attention`` (``USE_FLASH_KERNEL`` is False,
``repro/models/flags.py:38``), and JAX's autodiff differentiates its
KV-chunk ``lax.scan``.  On the card the gradient is a kernel, fed by the
forward's output and the log-sum-exp of each of its rows
(``flash.flash_attention_lse_cuda``); on the CPU autograd runs through
``flash.flash_attention_plain``.

A row with no valid key (no training row: each position sees its own key)
gets the gradient of the forward's mean of V over the S slots: the
forward writes ``flash.LSE_EMPTY`` as its lse, the backward's P is 0 there,
and each slot's dV takes the row's dO / S.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, flash

launches = 0  # calls that launched the kernels, since the last ops.reset_launch_counts()

CORE_TILE = 32  # f32: rows and keys a tile, both kernels
TILE = 64  # bf16: queries a row tile of the dK/dV kernel; the dQ kernel's key tiles are 128 keys, 32 at hd 256
PAD_ROWS = 128  # the D and lse copies' rows: T rounded up to this
_fn = None


def _expand(x: torch.Tensor, G: int) -> torch.Tensor:
    return x.repeat_interleave(G, dim=2).float()


def flash_attention_bwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    *,
    causal: bool,
    window: int | None,
    softcap: float | None,
    kv_chunk: int = flash.KV_CHUNK,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq (B, T, H, hd) and dk, dv (B, S, KV, hd) in q's type, from the
    forward's inputs, its output ``out``, its rows' ``lse`` (B, T, H) and the
    output's gradient ``dout``; in f32, KV chunk by chunk:
    ``P = exp(s - lse)`` with ``s`` the scaled, softcapped and masked score,
    ``D = rowsum(dout * out)``, ``dV = P^T dO``, ``dS = P (dO V^T - D)``
    (times ``1 - tanh^2`` of the capped argument under softcap), ``dQ =
    scale dS K``, ``dK = scale dS^T Q``, dK and dV summed over each kv
    head's G query heads.  A row with no valid key (lse ``LSE_EMPTY``) has
    P = 0 at every slot; the forward gave it the mean of V over the S
    slots, so its dO / S goes to every slot's dV: ``dV += E / S`` with E
    the sum of dO over the group's empty rows, and nothing to dQ or dK."""
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = hd**-0.5
    qf, dof = q.float(), dout.float()
    dsum = (dof * out.float()).sum(-1)  # (B, T, H)
    q_pos = q_pos.expand(B, T)[:, :, None]
    dq = torch.zeros((B, T, H, hd), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for c0 in range(0, S, kv_chunk):
        kx, vx = _expand(k[:, c0 : c0 + kv_chunk], G), _expand(v[:, c0 : c0 + kv_chunk], G)
        pc = k_pos[:, None, c0 : c0 + kv_chunk]  # (B, 1, C)
        x = torch.einsum("bthd,bchd->bthc", qf, kx) * scale
        dtanh = None
        if softcap is not None:
            t = torch.tanh(x / softcap)
            x, dtanh = softcap * t, 1.0 - t * t
        ok = pc >= 0
        if causal:
            ok = ok & (pc <= q_pos)
        if window is not None:
            ok = ok & (pc > q_pos - window)
        s = torch.where(ok[:, :, None, :], x, flash.NEG_INF)
        p = torch.exp(s - lse[..., None])  # (B, T, H, C)
        ds = p * (torch.einsum("bthd,bchd->bthc", dof, vx) - dsum[..., None])
        if dtanh is not None:
            ds = ds * dtanh
        dq += torch.einsum("bthc,bchd->bthd", ds, kx) * scale
        C = kx.shape[1]
        dvs.append(torch.einsum("bthc,bthd->bchd", p, dof).view(B, C, KV, G, hd).sum(3))
        dks.append((torch.einsum("bthc,bthd->bchd", ds, qf) * scale).view(B, C, KV, G, hd).sum(3))
    empty = (lse == flash.LSE_EMPTY)[..., None]  # (B, T, H, 1)
    esum = torch.where(empty, dof, 0.0).view(B, T, KV, G, hd).sum((1, 3))  # (B, KV, hd)
    dv = torch.cat(dvs, 1) + esum[:, None] / S
    return dq.to(q.dtype), torch.cat(dks, 1).to(k.dtype), dv.to(v.dtype)


def scratch_layout(B: int, T: int, S: int, H: int, KV: int, hd: int, dtype: torch.dtype) -> int:
    """Bytes of the scratch ``flash_bwd_launch`` takes
    (``csrc/flash_bwd.cu:carve``), each piece from a 256-byte boundary: the
    summaries (16 bytes each) of each batch row's key tiles and row tiles,
    D and the lse copy (B, H, Tp) f32 with Tp = T rounded up to
    ``PAD_ROWS``, the q_pos copy (B, Tp), the k_pos copy (B, S rounded up
    to a key tile), E (B, KV, hd) f32.  Tiles: bf16 128 keys (32 at hd 256)
    and 64 queries of one head; f32 32 keys and 32 rows of the G heads
    packed."""
    kt = CORE_TILE if dtype == torch.float32 else (TILE // 2 if hd == 256 else 2 * TILE)
    n_rt = -(-(T * (H // KV)) // CORE_TILE) if dtype == torch.float32 else -(-T // TILE)
    sp, tp = -(-S // kt) * kt, -(-T // PAD_ROWS) * PAD_ROWS

    def a256(x):
        return -(-x // 256) * 256

    return (a256(B * (sp // kt) * 16) + a256(B * n_rt * 16) + 2 * a256(4 * B * H * tp) + a256(4 * B * tp)
            + a256(4 * B * sp) + a256(4 * B * KV * hd))


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("flash_bwd").flash_bwd_launch
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        fn.argtypes = [p] * 11 + [i] * 7 + [f, i, i, f, p, ctypes.c_size_t, p]
        fn.restype = i
        _fn = fn
    return _fn


def flash_bwd_cuda(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    out: torch.Tensor,
    lse: torch.Tensor,
    dout: torch.Tensor,
    q_pos: torch.Tensor,
    k_pos: torch.Tensor,
    *,
    causal: bool,
    window: int | None,
    softcap: float | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The kernel: arguments and results as ``flash_attention_bwd_plain``'s,
    every tensor contiguous on one card, q, k, v, out and dout in f32 or
    bf16 alike, lse f32, positions int32.  One call counts one launch,
    whatever the number of device launches (six: two tile summaries, D, E,
    dK/dV, dQ)."""
    global launches
    dev, dt = q.device, q.dtype
    if dt not in flash._DTYPES:
        raise ValueError(f"flash_bwd: need float32 or bfloat16 operands, got {dt}")
    for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
        build.check_arg(name, t, dt, 4, dev)
    build.check_arg("lse", lse, torch.float32, 3, dev)
    build.check_arg("q_pos", q_pos, torch.int32, 2, dev)
    build.check_arg("k_pos", k_pos, torch.int32, 2, dev)
    B, T, H, hd = q.shape
    S, KV = k.shape[1], k.shape[2]
    if hd not in flash.HEAD_DIMS:
        raise ValueError(f"flash_bwd: head_dim {hd} has no kernel instance (one of {flash.HEAD_DIMS})")
    if (
        tuple(k.shape) != (B, S, KV, hd) or tuple(v.shape) != (B, S, KV, hd) or KV < 1 or H % KV
        or tuple(out.shape) != (B, T, H, hd) or tuple(dout.shape) != (B, T, H, hd) or tuple(lse.shape) != (B, T, H)
        or tuple(q_pos.shape) != (B, T) or tuple(k_pos.shape) != (B, S) or B * KV > 65535
    ):
        raise ValueError(f"flash_bwd: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
                         f"out {tuple(out.shape)}, dout {tuple(dout.shape)}, lse {tuple(lse.shape)}, "
                         f"q_pos {tuple(q_pos.shape)}, k_pos {tuple(k_pos.shape)}")
    if any(t.data_ptr() % 16 for t in (q, k, v, out, dout)):
        raise ValueError("flash_bwd: q, k, v, out and dout must start on a 16-byte boundary")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    nbytes = scratch_layout(B, T, S, H, KV, hd, dt)
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dev)
    err = _launcher()(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), dout.data_ptr(), lse.data_ptr(),
        q_pos.data_ptr(), k_pos.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        B, T, S, H, KV, hd, flash._DTYPES[dt], hd**-0.5, int(causal), int(window or 0), float(softcap or 0.0),
        scratch.data_ptr(), nbytes, torch.cuda.current_stream(dev).cuda_stream,
    )
    if err != 0:
        raise RuntimeError(f"flash_bwd launch failed with CUDA error {err}"
                           + (" (no TMA tensor map for these operands)" if err == 801 else ""))
    launches += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """flash attention on the card with its gradient: the forward kernel
    with each row's log-sum-exp, then ``flash_bwd_cuda``.  Nothing of it
    calls a plain version."""

    @staticmethod
    def forward(ctx, q, k, v, q_pos, k_pos, causal, window, softcap):
        out, lse = flash.flash_attention_lse_cuda(q, k, v, q_pos, k_pos, causal=causal, window=window,
                                                  softcap=softcap)
        ctx.save_for_backward(q, k, v, out, lse, q_pos, k_pos)
        ctx.mask = (causal, window, softcap)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse, q_pos, k_pos = ctx.saved_tensors
        causal, window, softcap = ctx.mask
        dq, dk, dv = flash_bwd_cuda(q, k, v, out, lse, dout.contiguous(), q_pos, k_pos, causal=causal,
                                    window=window, softcap=softcap)
        return dq, dk, dv, None, None, None, None, None
