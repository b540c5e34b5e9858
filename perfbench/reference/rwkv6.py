"""Plain reference of RWKV-6 ("Finch", arXiv:2404.05892) as the program
defines it.

Each layer: RMS norm, time mix, residual; RMS norm, channel mix, residual.
Time mix over heads of 64: token shift (``x + (x_{t-1} - x) * mu_i`` for
the five rows of ``mu``: r, k, v, g, w; the first step's x_{t-1} is 0), r,
k, v and g products, the log-decay ``-exp(w0 + tanh(x_w A) B)`` clamped to
[``logw_min``, ``logw_max``], the WKV recurrence

    o_t = r_t (diag(u) k_t v_t^T + S_{t-1}),   S_t = diag(exp(logw_t)) S_{t-1} + k_t v_t^T

from S_0 = 0, an RMS norm of o over the whole width, times silu(g), the
output product.  Channel mix: token shift with two rows (k, r),
``sigmoid(x_r W_r) * (relu(x_k W_k)^2 W_v)``.  A prefill's cache is each
layer's last input of the time mix (``shift``), its final S (``wkv``) and
the channel mix's last input (``cm_shift``).

Departures of the program (and so of this reference) from the published
Finch, noted in PERF.md: static token-shift mixes (no data-dependent
lerp), an RMS norm over the width in place of the group norm, the norms'
``1 + scale``, and the decay's clamp.

The recurrence runs in chunks of ``CHUNK`` tokens: within a chunk the
pairs (t, s < t) through their decay products, across chunks the state.
Plain PyTorch in float32.  Nothing here imports the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.common import Precision, cross_entropy, rms_norm

CHUNK = 32
HEAD = 64
LORA = 32


def dims(cfg: dict) -> dict:
    D = cfg["hidden_size"]
    return dict(D=D, H=D // cfg["head_size"], F=cfg["intermediate_size"], V=cfg["vocab_size"],
                L=cfg["num_hidden_layers"])


def param_specs(cfg: dict) -> list[tuple[str, tuple[int, ...], str, tuple]]:
    """(name, shape, served dtype, draw) of every parameter, by the
    program's names.  A draw is ("normal", std) or ("uniform", lo, hi)."""
    d = dims(cfg)
    D, H, F_, V = d["D"], d["H"], d["F"], d["V"]
    norm, dt = ("normal", cfg["norm_scale_std"]), cfg["dtype"]
    w0 = ("uniform", *cfg["decay_base_range"])
    specs = [("embed", (V, D), dt, ("normal", D**-0.5))]
    for i in range(d["L"]):
        p = f"layers.{i}."
        specs += [(p + "ln1.scale", (D,), "float32", norm), (p + "tm.mu", (5, D), "float32", ("uniform", 0.0, 1.0))]
        specs += [(p + f"tm.{n}", (D, D), dt, ("normal", D**-0.5)) for n in ("wr", "wk", "wv", "wg", "wo")]
        specs += [
            (p + "tm.w0", (D,), "float32", w0),
            (p + "tm.wa", (D, LORA), "float32", ("normal", D**-0.5)),
            (p + "tm.wb", (LORA, D), "float32", ("normal", LORA**-0.5)),
            (p + "tm.u", (H, HEAD), "float32", ("normal", 0.1)),
            (p + "tm.out_norm.scale", (D,), "float32", norm),
            (p + "ln2.scale", (D,), "float32", norm),
            (p + "cm.mu", (2, D), "float32", ("uniform", 0.0, 1.0)),
            (p + "cm.wk", (D, F_), dt, ("normal", D**-0.5)),
            (p + "cm.wv", (F_, D), dt, ("normal", F_**-0.5)),
            (p + "cm.wr", (D, D), dt, ("normal", D**-0.5)),
        ]
    specs += [("final_norm.scale", (D,), "float32", norm), ("lm_head", (D, V), dt, ("normal", D**-0.5))]
    return specs


def _shifted(x: torch.Tensor) -> torch.Tensor:
    return F.pad(x, (0, 0, 1, 0))[:, :-1]


def wkv(r, k, v, logw, u):
    """The recurrence from S_0 = 0: r, k, v, logw (B, T, H, n) -> (o (B, T,
    H, n), S (B, H, n, n)).  Within each chunk the pairs s < t weigh
    r_t k_s by the decay between them, as the product of r_t exp(decay
    through t - 1) and k_s exp(-decay through s) (at most 32 steps of at
    least -1.2 apart, so both stay inside float32's range); the state
    enters each chunk from the one before."""
    B, T, H, n = r.shape
    L = CHUNK
    pad = (-T) % L
    if pad:  # k = v = r = 0 and no decay: the state passes unchanged
        r, k, v, logw = (F.pad(a, (0, 0, 0, 0, 0, pad)) for a in (r, k, v, logw))
    C = (T + pad) // L
    rc, kc, vc, wc = (a.reshape(B, C, L, H, n).permute(0, 3, 1, 2, 4) for a in (r, k, v, logw))  # (B, H, C, L, n)
    cum = torch.cumsum(wc, dim=3)
    before = cum - wc
    qf, kf = rc * torch.exp(before), kc * torch.exp(-cum)
    strict = torch.tril(torch.ones((L, L), dtype=torch.bool, device=r.device), diagonal=-1)
    A = (qf @ kf.transpose(-1, -2)).masked_fill(~strict, 0.0)
    o = A @ vc + (rc * u[None, :, None, None] * kc).sum(-1, keepdim=True) * vc
    last = cum[..., -1:, :]
    inner = (kc * torch.exp(last - cum)).transpose(-1, -2) @ vc  # (B, H, C, n, n)
    across = torch.exp(last[..., 0, :])[..., None]  # (B, H, C, n, 1)
    S = r.new_zeros((B, H, n, n))
    entering = []
    for c in range(C):
        entering.append(S)
        S = across[:, :, c] * S + inner[:, :, c]
    o = o + qf @ torch.stack(entering, dim=2)
    return o.permute(0, 2, 3, 1, 4).reshape(B, C * L, H, n)[:, :T], S


def _time_mix(P: dict, p: str, x: torch.Tensor, cfg: dict, prec: Precision):
    B, T, D = x.shape
    H = dims(cfg)["H"]
    xs = _shifted(x)
    mu = P[p + "tm.mu"]
    xr, xk, xv, xg, xw = (x + (xs - x) * mu[i] for i in range(5))
    r = prec.mm(xr, P[p + "tm.wr"]).view(B, T, H, HEAD)
    k = prec.mm(xk, P[p + "tm.wk"]).view(B, T, H, HEAD)
    v = prec.mm(xv, P[p + "tm.wv"]).view(B, T, H, HEAD)
    g = F.silu(prec.mm(xg, P[p + "tm.wg"]))
    logw = -torch.exp(P[p + "tm.w0"] + prec.mm(torch.tanh(prec.mm(xw, P[p + "tm.wa"])), P[p + "tm.wb"]))
    logw = torch.clamp(logw, cfg["logw_min"], cfg["logw_max"]).view(B, T, H, HEAD)
    o, S = wkv(r, k, v, logw, P[p + "tm.u"])
    o = rms_norm(o.reshape(B, T, D), P[p + "tm.out_norm.scale"], cfg["norm_eps"])
    return prec.mm(o * g, P[p + "tm.wo"]), S


def _channel_mix(P: dict, p: str, x: torch.Tensor, prec: Precision):
    xs = _shifted(x)
    mu = P[p + "cm.mu"]
    xk, xr = x + (xs - x) * mu[0], x + (xs - x) * mu[1]
    kk = torch.square(F.relu(prec.mm(xk, P[p + "cm.wk"])))
    return torch.sigmoid(prec.mm(xr, P[p + "cm.wr"])) * prec.mm(kk, P[p + "cm.wv"])


def _layer(P: dict, i: int, x: torch.Tensor, cfg: dict, prec: Precision):
    p = f"layers.{i}."
    eps = cfg["norm_eps"]
    h = rms_norm(x, P[p + "ln1.scale"], eps)
    a, S = _time_mix(P, p, h, cfg, prec)
    x = x + a
    h2 = rms_norm(x, P[p + "ln2.scale"], eps)
    # the last rows copied: a view would hold the whole (B, T, D) input
    return x + _channel_mix(P, p, h2, prec), {"shift": h[:, -1].clone(), "wkv": S, "cm_shift": h2[:, -1].clone()}


def prefill(P: dict, tokens: torch.Tensor, cfg: dict, prec: Precision, cache_len: int):
    """tokens (B, T) -> (last-position logits (B, V), cache: one {shift,
    wkv, cm_shift} a layer).  ``cache_len`` is unused: the state has one
    size."""
    x = P["embed"][tokens]
    cache = []
    for i in range(dims(cfg)["L"]):
        x, c = _layer(P, i, x, cfg, prec)
        cache.append(c)
    h = rms_norm(x[:, -1], P["final_norm.scale"], cfg["norm_eps"])
    return prec.mm(h, P["lm_head"]), cache


def _layer_x(P, i, x, cfg, prec):
    return _layer(P, i, x, cfg, prec)[0]


def loss(P: dict, batch: dict, cfg: dict, prec: Precision) -> torch.Tensor:
    """Mean masked cross-entropy of a batch; each layer under ``checkpoint``
    where the configuration says ``remat``."""
    x = P["embed"][batch["tokens"]]
    for i in range(dims(cfg)["L"]):
        x = checkpoint(_layer_x, P, i, x, cfg, prec, use_reentrant=False) if cfg["remat"] else _layer_x(
            P, i, x, cfg, prec)
    h = rms_norm(x, P["final_norm.scale"], cfg["norm_eps"])
    D = h.shape[-1]
    return cross_entropy(h.reshape(-1, D), P["lm_head"], batch["labels"].reshape(-1).long(),
                         batch["mask"].reshape(-1).float(), prec)
