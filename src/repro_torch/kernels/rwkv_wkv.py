"""The RWKV-6 WKV recurrence on the card: the launch wrapper of
``csrc/rwkv_wkv.cu``, and its plain PyTorch version.

No TPU kernel: replaces the recurrence of ``rwkv_time_mix``, which the
reference leaves to XLA (``repro/models/recurrent.py``: the ``lax.scan`` of
``chunk_step`` over chunks of 64 tokens, and the single step at T = 1).
``kernels.ops.rwkv_wkv`` sends CUDA tensors to the kernel and CPU tensors
to ``wkv_plain``.

Per head, with the state S (hd_k, hd_v) carried from token to token::

    o_t[v] = sum_k r_t[k] (u[k] k_t[k] v_t[v] + S[k, v])
    S[k, v] = exp(logw_t[k]) S[k, v] + k_t[k] v_t[v]
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

launches = 0  # kernel launches since the last ops.reset_launch_counts()

HEAD = 64  # RWKV-6's head size, the kernel's only one (csrc/rwkv_wkv.cu:kHead)
CHUNK = 64  # the reference's chunk of tokens (repro/models/recurrent.py:RWKV_CHUNK)
_fn = None


def wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor, u: torch.Tensor,
              S0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, logw (B, T, H, hd) f32, u (H, hd), S0 (B, H, hd, hd) f32 ->
    (o (B, T, H, hd), S (B, H, hd, hd)), in the reference's arithmetic: at
    T = 1 its two contractions and the state update; otherwise its factored
    chunk form over chunks of 64, padded with k = r = v = 0 and logw = 0
    (keep), so padded steps leave the state as it is."""
    B, T, H, hd = r.shape
    if T == 1:
        rt, kt, vt, wt = r[:, 0], k[:, 0], v[:, 0], torch.exp(logw[:, 0])
        kv = torch.einsum("bhk,bhv->bhkv", kt, vt)
        o = torch.einsum("bhk,bhkv->bhv", rt * u[None], kv) + torch.einsum("bhk,bhkv->bhv", rt, S0)
        return o[:, None], wt[..., None] * S0 + kv
    L = CHUNK
    pad = (-T) % L
    if pad:
        r, k, v, logw = (torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, logw))
    n = (T + pad) // L
    rc, kc, vc, wc = (a.reshape(B, n, L, H, hd).permute(1, 0, 3, 2, 4) for a in (r, k, v, logw))
    mask = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device), diagonal=-1)
    S, outs = S0, []
    for i in range(n):
        rr, kk, vv, lw = rc[i], kc[i], vc[i], wc[i]  # (B, H, L, hd)
        c = torch.cumsum(lw, dim=2)  # inclusive log-decay
        c_prev = c - lw  # exclusive: decay up to t - 1
        q_f = rr * torch.exp(c_prev)
        k_f = kk * torch.exp(-c)
        A = torch.where(mask, torch.einsum("bhtd,bhsd->bhts", q_f, k_f), 0.0)
        o = torch.einsum("bhts,bhsd->bhtd", A, vv)
        o = o + torch.einsum("bhtd,bhtd->bht", rr * u[None, :, None, :], kk)[..., None] * vv
        o = o + torch.einsum("bhtk,bhkv->bhtv", q_f, S)
        c_last = c[:, :, -1:, :]
        S = torch.exp(c_last[:, :, 0])[..., None] * S + torch.einsum("bhtk,bhtv->bhkv", kk * torch.exp(c_last - c),
                                                                     vv)
        outs.append(o)
    o = torch.stack(outs).permute(1, 0, 3, 2, 4).reshape(B, n * L, H, hd)[:, :T]
    return o, S


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("rwkv_wkv").rwkv_wkv_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, i, i, i, p, p, p]
        fn.restype = i
        _fn = fn
    return _fn


def rwkv_wkv_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor, u: torch.Tensor,
                  S0: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``wkv_plain`` on the card: one launch, any T.  Prefill computes the
    plain version's chunk form on the tensor cores (three TF32 passes a
    product), a block per (b, h, half of the value columns) walking its
    chunks in order; T = 1 takes the token form."""
    global launches
    build.check_cuda("rwkv_wkv", r)
    dev = r.device
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw)):
        build.check_arg(name, t, torch.float32, 4, dev)
    build.check_arg("u", u, torch.float32, 2, dev)
    build.check_arg("S0", S0, torch.float32, 4, dev)
    B, T, H, hd = r.shape
    if (hd != HEAD or T < 1 or any(t.shape != r.shape for t in (k, v, logw)) or u.shape != (H, hd)
            or S0.shape != (B, H, hd, hd)):
        raise ValueError(f"rwkv_wkv: r/k/v/logw {tuple(r.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(logw.shape)}, u {tuple(u.shape)}, S0 {tuple(S0.shape)} (head size {HEAD})")
    # the kernel reads 16 bytes at a time: a view off that alignment is copied
    r, k, v, logw, u, S0 = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (r, k, v, logw, u, S0))
    o = torch.empty_like(r)
    S = torch.empty_like(S0)
    err = _launcher()(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(), S0.data_ptr(), B, T,
                      H, o.data_ptr(), S.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rwkv_wkv launch failed with CUDA error {err}")
    launches += 1
    return o, S
