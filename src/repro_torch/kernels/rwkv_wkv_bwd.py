"""The RWKV-6 WKV recurrence's backward on the card: the launch wrapper of
``csrc/rwkv_wkv_bwd.cu``, its plain PyTorch version, and the autograd
function that joins it to the forward (``csrc/rwkv_wkv.cu``).

No TPU kernel: replaces the gradient that JAX's autodiff takes of the
recurrence the reference leaves to XLA (``repro/models/recurrent.py``,
``rwkv_time_mix``'s ``lax.scan`` of ``chunk_step`` and its single step at
T = 1).  On the card ``kernels.ops.rwkv_wkv`` goes through ``RWKVWKV``
where autograd records the call; on the CPU autograd runs through
``rwkv_wkv.wkv_plain``.  ``wkv_bwd_chunk_plain`` is the kernels' chunk
form in PyTorch, for the CPU tests; no path of the port calls it.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, rwkv_wkv

launches = 0  # calls that launched the kernels, since the last ops.reset_launch_counts()

CHUNK = rwkv_wkv.CHUNK  # tokens a chunk of the checkpoints and of the kernels (csrc/rwkv_wkv_bwd.cu:kChunk)
_fn = None


def wkv_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor, u: torch.Tensor,
                  S0: torch.Tensor, do: torch.Tensor, dS: torch.Tensor):
    """The gradient of ``rwkv_wkv.wkv_plain`` in the token form, written
    out: r, k, v, logw, do (B, T, H, hd), u (H, hd), S0, dS (B, H, hd, hd),
    all f32 -> (dr, dk, dv, dlogw, du, dS0).  With w_t = exp(logw_t),
    S_{t-1} the state before token t and dS_t the gradient of the state
    after it (dS_T = dS), in reverse time::

        dr_t[k]    = sum_v do_t[v] (u_k k_t[k] v_t[v] + S_{t-1}[k, v])
        dk_t[k]    = sum_v dS_t[k, v] v_t[v] + r_t[k] u_k (do_t . v_t)
        dv_t[v]    = sum_k dS_t[k, v] k_t[k] + (sum_k r_t[k] u_k k_t[k]) do_t[v]
        dlogw_t[k] = w_t[k] sum_v dS_t[k, v] S_{t-1}[k, v]
        dS_{t-1}   = w_t ⊙_k dS_t + r_t do_t^T
        du[h, k]   = sum_{b, t} r_t[k] k_t[k] (do_t . v_t)

    and dS0 the last dS_{t-1}.  The states S_{t-1} come from a forward walk
    in token order, kept for every token."""
    T = r.shape[1]
    w = torch.exp(logw)
    S, states = S0, []
    for t in range(T):
        states.append(S)
        S = w[:, t, :, :, None] * S + k[:, t, :, :, None] * v[:, t, :, None, :]
    dov = torch.einsum("bthv,bthv->bth", do, v)
    ruk = torch.einsum("bthk,hk,bthk->bth", r, u, k)
    dr, dk, dv, dlogw = (torch.empty_like(r) for _ in range(4))
    dS_t = dS
    for t in range(T - 1, -1, -1):
        Sp, rt, kt, vt, wt, dt = states[t], r[:, t], k[:, t], v[:, t], w[:, t], do[:, t]
        dr[:, t] = torch.einsum("bhkv,bhv->bhk", Sp, dt) + u * kt * dov[:, t, :, None]
        dk[:, t] = torch.einsum("bhkv,bhv->bhk", dS_t, vt) + rt * u * dov[:, t, :, None]
        dv[:, t] = torch.einsum("bhkv,bhk->bhv", dS_t, kt) + ruk[:, t, :, None] * dt
        dlogw[:, t] = wt * torch.einsum("bhkv,bhkv->bhk", dS_t, Sp)
        dS_t = wt[..., None] * dS_t + rt[..., None] * dt[..., None, :]
    du = torch.einsum("bthk,bthk,bth->hk", r, k, dov)
    return dr, dk, dv, dlogw, du, dS_t


def wkv_bwd_chunk_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor, u: torch.Tensor,
                        S0: torch.Tensor, do: torch.Tensor, dS: torch.Tensor, ckpt: torch.Tensor):
    """``wkv_bwd_plain``'s gradients in the chunk form that
    ``csrc/rwkv_wkv_bwd.cu`` computes, fed by the forward's checkpoints
    ``ckpt`` (``rwkv_wkv.checkpoint_shape``: the state after each chunk of
    CHUNK tokens).  Per chunk, with c = cumsum(logw) (inclusive), e its last
    token, q_f = r exp(c - logw), k_f = k exp(-c), D = exp(c_e) ⊙_k dS_out,
    A = tril_-1(q_f k_f^T) + diag(Σ r u k) and M = tril_-1(do v^T)::

        dS_in  = exp(c_e) ⊙_k dS_out + q_f^T do      (in reverse, from dS)
        dr     = exp(c - logw) ⊙ (do S_in^T + M k_f) + u k (do . v)
        dk     = exp(-c) ⊙ (v D^T + M^T q_f)         + r u (do . v)
        dv     = k_f D + A^T do
        dlogw_t = P + Σ_{s>t} x_s - y_t,   y = k_f ⊙ (v D^T + M^T q_f),
                  x = q_f ⊙ (do S_in^T + M k_f) - y,   P = Σ_v dS_out ⊙ S_out

    (x and y are r ⊙ drS - k ⊙ dkS and k ⊙ dkS, with drS and dkS the state
    parts of dr and dk, so dlogw is the token identity dlogw_t = dlogw_{t+1}
    + r_{t+1} drS_{t+1} - k_t dkS_t summed from the chunk's end), du the
    chunks' sums of r k (do . v) added over (b, chunk) in order, and dS0 the
    first chunk's dS_in.  Padded tokens (past T) are zeros with logw = 0."""
    B, T, H, hd = r.shape
    L = CHUNK
    n = -(-T // L)
    pad = n * L - T

    def chunks(a):  # (B, T, H, hd) -> (n, B, H, L, hd), zeros past T
        a = torch.nn.functional.pad(a, (0, 0, 0, 0, 0, pad)) if pad else a
        return a.reshape(B, n, L, H, hd).permute(1, 0, 3, 2, 4)

    rc, kc, vc, wc, dc = (chunks(a) for a in (r, k, v, logw, do))
    c = torch.cumsum(wc, dim=3)
    q_f = rc * torch.exp(c - wc)
    k_f = kc * torch.exp(-c)
    ece = torch.exp(c[:, :, :, -1])  # (n, B, H, hd)
    # the reverse state pass: the gradient of the state after each chunk
    dS_out, cur = [None] * n, dS
    for i in range(n - 1, -1, -1):
        dS_out[i] = cur
        cur = ece[i][..., None] * cur + torch.einsum("bhtk,bhtv->bhkv", q_f[i], dc[i])
    dS0, dS_out = cur, torch.stack(dS_out)
    S_out = ckpt.permute(2, 0, 1, 3, 4)
    S_in = torch.cat([S0[None], S_out[:-1]])
    D = ece[..., None] * dS_out
    lower = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device), diagonal=-1)
    ruk = torch.einsum("nbhtk,hk->nbht", rc * kc, u)
    dov = torch.einsum("nbhtv,nbhtv->nbht", dc, vc)
    M = torch.where(lower, torch.einsum("nbhtv,nbhsv->nbhts", dc, vc), 0.0)
    A = torch.where(lower, torch.einsum("nbhtk,nbhsk->nbhts", q_f, k_f), 0.0) + torch.diag_embed(ruk)
    acc_r = torch.einsum("nbhtv,nbhkv->nbhtk", dc, S_in) + M @ k_f
    acc_k = torch.einsum("nbhtv,nbhkv->nbhtk", vc, D) + M.transpose(-1, -2) @ q_f
    dr = torch.exp(c - wc) * acc_r + u[:, None] * kc * dov[..., None]
    dk = torch.exp(-c) * acc_k + rc * u[:, None] * dov[..., None]
    dv = k_f @ D + A.transpose(-1, -2) @ dc
    y = k_f * acc_k
    x = q_f * acc_r - y
    after = torch.flip(torch.cumsum(torch.flip(x, [3]), dim=3), [3]) - x  # Σ_{s>t} x_s
    dlogw = torch.einsum("nbhkv,nbhkv->nbhk", dS_out, S_out)[:, :, :, None] + after - y
    du_part = torch.einsum("nbhtk,nbht->nbhk", rc * kc, dov)  # a chunk's sum
    du = torch.zeros_like(u)
    for b in range(B):
        for i in range(n):
            du = du + du_part[i, b]

    def tokens(a):  # (n, B, H, L, hd) -> (B, T, H, hd)
        return a.permute(1, 0, 3, 2, 4).reshape(B, n * L, H, hd)[:, :T]

    return tokens(dr), tokens(dk), tokens(dv), tokens(dlogw), du, dS0


def _launcher():
    global _fn
    if _fn is None:
        fn = build.library("rwkv_wkv_bwd").rwkv_wkv_bwd_launch
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = [p, p, p, p, p, p, p, p, p, i, i, i, p, p, p, p, p, p, p, p, p]
        fn.restype = i
        _fn = fn
    return _fn


def rwkv_wkv_bwd_cuda(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, logw: torch.Tensor, u: torch.Tensor,
                      S0: torch.Tensor, do: torch.Tensor, dS: torch.Tensor, ckpt: torch.Tensor,
                      need: tuple[bool, ...] = (True,) * 6):
    """``wkv_bwd_plain`` on the card (within 1e-4 of each output's max
    |plain|, the same from run to run), any T, in the chunk form of
    ``wkv_bwd_chunk_plain`` on the tensor cores: one call, three launches
    (the reverse state pass, the chunks, du's fixed-order sum).  ``ckpt``
    is the forward's checkpoints (``rwkv_wkv.rwkv_wkv_cuda(..., ckpt)``).
    ``need`` names which of (dr, dk, dv, dlogw, du, dS0) to compute; the
    others are None."""
    global launches
    build.check_cuda("rwkv_wkv_bwd", r)
    dev = r.device
    for name, t in (("r", r), ("k", k), ("v", v), ("logw", logw), ("do", do)):
        build.check_arg(name, t, torch.float32, 4, dev)
    build.check_arg("u", u, torch.float32, 2, dev)
    build.check_arg("S0", S0, torch.float32, 4, dev)
    build.check_arg("dS", dS, torch.float32, 4, dev)
    B, T, H, hd = r.shape
    if (hd != rwkv_wkv.HEAD or T < 1 or any(t.shape != r.shape for t in (k, v, logw, do)) or u.shape != (H, hd)
            or S0.shape != (B, H, hd, hd) or dS.shape != S0.shape):
        raise ValueError(f"rwkv_wkv_bwd: r/k/v/logw/do {tuple(r.shape)}, {tuple(k.shape)}, {tuple(v.shape)}, "
                         f"{tuple(logw.shape)}, {tuple(do.shape)}, u {tuple(u.shape)}, S0 {tuple(S0.shape)}, "
                         f"dS {tuple(dS.shape)} (head size {rwkv_wkv.HEAD})")
    # the kernels read 16 bytes at a time: a view off that alignment is copied
    r, k, v, logw, u, S0, do, dS = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (r, k, v, logw, u, S0, do, dS))
    rwkv_wkv.check_checkpoints("rwkv_wkv_bwd", ckpt, B, T, H, dev)
    outs = [torch.empty_like(r) if n else None for n in need[:4]]
    du = torch.empty_like(u) if need[4] else None
    dS0 = torch.empty_like(S0) if need[5] else None
    dS_ck = torch.empty_like(ckpt)  # the gradient of each checkpoint, from the state pass
    du_part = torch.empty((B * H * ckpt.shape[2], hd), dtype=torch.float32, device=dev) if need[4] else None

    def ptr(t):
        return None if t is None else t.data_ptr()

    err = _launcher()(r.data_ptr(), k.data_ptr(), v.data_ptr(), logw.data_ptr(), u.data_ptr(), S0.data_ptr(),
                      do.data_ptr(), dS.data_ptr(), ckpt.data_ptr(), B, T, H, *(ptr(t) for t in outs), ptr(du),
                      ptr(dS0), dS_ck.data_ptr(), ptr(du_part), torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rwkv_wkv_bwd launch failed with CUDA error {err}")
    launches += 1
    return (*outs, du, dS0)


class RWKVWKV(torch.autograd.Function):
    """The WKV recurrence on the card with its gradient: the forward kernel
    (``rwkv_wkv.rwkv_wkv_cuda``), which also writes the checkpoints the
    backward reads, then ``rwkv_wkv_bwd_cuda`` for what ``needs_input_grad``
    asks.  Any T; nothing of it calls a plain version."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, S0):
        B, T, H, _ = r.shape
        ckpt = torch.empty(rwkv_wkv.checkpoint_shape(B, T, H), dtype=torch.float32, device=r.device)
        o, S = rwkv_wkv.rwkv_wkv_cuda(r, k, v, logw, u, S0, ckpt)
        ctx.save_for_backward(r, k, v, logw, u, S0, ckpt)
        return o, S

    @staticmethod
    def backward(ctx, do, dS):
        *args, ckpt = ctx.saved_tensors
        return rwkv_wkv_bwd_cuda(*args, do.contiguous(), dS.contiguous(), need=ctx.needs_input_grad, ckpt=ckpt)
