"""Recurrent sequence mixers: RWKV-6 ("Finch") and RG-LRU (Griffin /
RecurrentGemma).

Port of ``repro.models.recurrent``.  A parameter mapping ``p`` is anything
with ``p["name"]``, as in ``models.layers``; each mixer has an ``init_*``
that draws its tensors from an explicit ``torch.Generator`` at the
reference's shapes, dtypes and scales, and a state of its own
(``init_rwkv_state``, ``init_rglru_state``) that a decode step carries.

The recurrences go through ``kernels.ops``: ``rwkv_wkv`` (the WKV state of
a time mix, one launch a call on the card, prefill and decode alike) and
``rglru_scan`` (the affine recurrence of an RG-LRU block).  On the CPU they
are the reference's own arithmetic (``rwkv_wkv.wkv_plain``: its factored
chunk form over chunks of ``RWKV_CHUNK``, its single step at T = 1) and the
recurrence in token order (``rglru_scan.rglru_scan_plain``, which differs
from the reference's ``associative_scan`` tree by float32 rounding).  The
log-decay is clamped to [``LOGW_MIN``, ``LOGW_MAX``] as the reference
clamps it for its chunk form.  Both recurrences carry gradients on the card
too: where autograd records a call, ``ops`` runs it through an autograd
function whose backward is a kernel (``rwkv_wkv_bwd``, ``rglru_scan_bwd``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv_wkv import CHUNK as RWKV_CHUNK  # noqa: F401  (the plain version's chunk)
from repro_torch.models.layers import _normal, cdtype, rms_norm

LOGW_MIN = -1.2  # the reference's f32-safety clamp for its factored chunk form
LOGW_MAX = -1e-6
LORA_RANK = 32
RGLRU_C = 8.0


# ---------------------------------------------------------------------------
# RWKV-6 time mix
# ---------------------------------------------------------------------------


def rwkv_heads(cfg: ModelConfig) -> tuple[int, int]:
    """(heads, head size): RWKV-6's heads are 64 wide."""
    hd = 64
    if cfg.d_model % hd:
        raise ValueError(f"rwkv: d_model {cfg.d_model} is not a multiple of the head size {hd}")
    return cfg.d_model // hd, hd


def init_rwkv_time_mix(cfg: ModelConfig, gen: torch.Generator | None, device=None) -> dict[str, torch.Tensor]:
    """The time mix's tensors; its ``out_norm`` (an RMS norm over D) is the
    caller's (``models.model.TimeMix``)."""
    D = cfg.d_model
    H, hd = rwkv_heads(cfg)
    dt, f32 = cdtype(cfg), torch.float32
    s = D**-0.5
    return {
        "mu": torch.zeros((5, D), dtype=f32, device=device),  # token-shift lerp for r, k, v, g, w
        "wr": _normal(gen, (D, D), s, dt, device),
        "wk": _normal(gen, (D, D), s, dt, device),
        "wv": _normal(gen, (D, D), s, dt, device),
        "wg": _normal(gen, (D, D), s, dt, device),
        "wo": _normal(gen, (D, D), s, dt, device),
        # data-dependent decay: w = exp(-exp(w0 + tanh(x A) B))
        "w0": torch.full((D,), -1.0, dtype=f32, device=device),
        "wa": _normal(gen, (D, LORA_RANK), s, f32, device),
        "wb": _normal(gen, (LORA_RANK, D), LORA_RANK**-0.5, f32, device),
        "u": _normal(gen, (H, hd), 0.1, f32, device),  # bonus
    }


def _token_shift(x: torch.Tensor, mu: torch.Tensor, shift_state: torch.Tensor) -> torch.Tensor:
    """xm_i = x + (shift(x) - x) * mu_i for the rows of mu -> (len(mu), B, T, D)."""
    prev = torch.cat([shift_state[:, None, :].to(x.dtype), x[:, :-1, :]], dim=1)
    return x[None] + (prev - x)[None] * mu[:, None, None, :].to(x.dtype)


def rwkv_time_mix(p, x: torch.Tensor, cfg: ModelConfig, state: dict) -> tuple[torch.Tensor, dict]:
    """x (B, T, D); state {"shift": (B, D), "wkv": (B, H, hd, hd) f32} ->
    (out (B, T, D), new state).  r, k and v are cast to f32 after their
    products, the log-decay is computed in f32 and clamped, and the WKV
    output is cast to x's dtype before an RMS norm over the whole D."""
    B, T, D = x.shape
    H, hd = rwkv_heads(cfg)
    xm = _token_shift(x, p["mu"], state["shift"])
    r = (xm[0] @ p["wr"]).reshape(B, T, H, hd).float()
    k = (xm[1] @ p["wk"]).reshape(B, T, H, hd).float()
    v = (xm[2] @ p["wv"]).reshape(B, T, H, hd).float()
    g = F.silu(xm[3] @ p["wg"])
    logw = -torch.exp(p["w0"] + torch.tanh(xm[4].float() @ p["wa"]) @ p["wb"])
    logw = torch.clamp(logw, LOGW_MIN, LOGW_MAX).reshape(B, T, H, hd)
    o, S = ops.rwkv_wkv(r, k, v, logw, p["u"], state["wkv"].float())
    o = rms_norm(p["out_norm"], o.reshape(B, T, D).to(x.dtype), cfg.norm_eps)
    out = (o * g) @ p["wo"]
    return out, {"shift": x[:, -1, :], "wkv": S.to(state["wkv"].dtype)}


def init_rwkv_channel_mix(cfg: ModelConfig, gen: torch.Generator | None, device=None) -> dict[str, torch.Tensor]:
    D, F_ = cfg.d_model, cfg.d_ff
    dt = cdtype(cfg)
    return {
        "mu": torch.zeros((2, D), dtype=torch.float32, device=device),
        "wk": _normal(gen, (D, F_), D**-0.5, dt, device),
        "wv": _normal(gen, (F_, D), F_**-0.5, dt, device),
        "wr": _normal(gen, (D, D), D**-0.5, dt, device),
    }


def rwkv_channel_mix(p, x: torch.Tensor, cfg: ModelConfig, shift_state: torch.Tensor):
    """x (B, T, D), shift_state (B, D) -> (out (B, T, D), new shift state)."""
    xm = _token_shift(x, p["mu"], shift_state)  # (2, B, T, D)
    k = torch.square(F.relu(xm[0] @ p["wk"]))
    out = torch.sigmoid(xm[1] @ p["wr"]) * (k @ p["wv"])
    return out, x[:, -1, :]


def init_rwkv_state(cfg: ModelConfig, batch: int, device=None) -> dict[str, torch.Tensor]:
    H, hd = rwkv_heads(cfg)
    dt = cdtype(cfg)
    return {
        "shift": torch.zeros((batch, cfg.d_model), dtype=dt, device=device),
        "wkv": torch.zeros((batch, H, hd, hd), dtype=torch.float32, device=device),
        "cm_shift": torch.zeros((batch, cfg.d_model), dtype=dt, device=device),
    }


# ---------------------------------------------------------------------------
# RG-LRU recurrent block (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------


def init_rglru_block(cfg: ModelConfig, gen: torch.Generator | None, device=None) -> dict[str, torch.Tensor]:
    D = cfg.d_model
    R = cfg.rnn_width or D
    cw = cfg.conv_width
    dt, f32 = cdtype(cfg), torch.float32
    return {
        "w_branch": _normal(gen, (D, R), D**-0.5, dt, device),  # gate branch
        "w_rnn": _normal(gen, (D, R), D**-0.5, dt, device),  # rnn branch
        "conv_w": _normal(gen, (cw, R), cw**-0.5, dt, device),
        "conv_b": torch.zeros((R,), dtype=f32, device=device),
        "w_r": _normal(gen, (R, R), R**-0.5, dt, device),  # recurrence gate
        "w_i": _normal(gen, (R, R), R**-0.5, dt, device),  # input gate
        "lam": torch.full((R,), 4.0, dtype=f32, device=device),  # a = sigmoid(lam)^(c*r)
        "w_out": _normal(gen, (R, D), R**-0.5, dt, device),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, buf: torch.Tensor):
    """Depthwise causal conv1d.  x (B, T, R); buf (B, cw - 1, R), the carried
    history -> (out (B, T, R), new history).  Summed tap by tap from 0 in
    x's dtype, the bias last."""
    cw, T = w.shape[0], x.shape[1]
    ext = torch.cat([buf.to(x.dtype), x], dim=1)
    out = 0
    for i in range(cw):
        out = out + ext[:, i : i + T, :] * w[i]
    return out + b.to(x.dtype), ext[:, -(cw - 1) :, :]


def rglru_block(p, x: torch.Tensor, cfg: ModelConfig, state: dict) -> tuple[torch.Tensor, dict]:
    """Griffin's recurrent block: x (B, T, D); state {"h": (B, R) f32,
    "conv": (B, cw - 1, R)} -> (out (B, T, D), new state).  The gates, the
    decay and the input scale are f32."""
    gate = F.gelu(x @ p["w_branch"], approximate="tanh")  # jax.nn.gelu's default
    u, conv_state = _causal_conv(x @ p["w_rnn"], p["conv_w"], p["conv_b"], state["conv"])
    uf = u.float()
    r = torch.sigmoid(uf @ p["w_r"].float())
    i = torch.sigmoid(uf @ p["w_i"].float())
    log_a = -RGLRU_C * F.softplus(p["lam"]) * r  # (B, T, R), <= 0
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12)) * (i * uf)
    h_seq, h_last = ops.rglru_scan(a, b, state["h"].float())
    out = (h_seq.to(x.dtype) * gate) @ p["w_out"]
    return out, {"h": h_last, "conv": conv_state}


def init_rglru_state(cfg: ModelConfig, batch: int, device=None) -> dict[str, torch.Tensor]:
    R = cfg.rnn_width or cfg.d_model
    return {
        "h": torch.zeros((batch, R), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, cfg.conv_width - 1, R), dtype=cdtype(cfg), device=device),
    }
