"""Model layers of the port: plain tensor functions over parameter mappings.

Port of ``repro.models.layers``.  A parameter mapping
``p`` is anything with ``p["name"]`` (the modules of ``models.model``, or a
dict); each layer has an ``init_*`` that draws its tensors from an explicit
``torch.Generator`` and a matching apply function.

Conventions (the reference's): activations flow in the config's compute
dtype (bf16 by default); norms, softmax statistics and logits are f32.
Weights keep the reference's ``(in, out)`` layout, so ``x @ w`` means the
same in both packages.  Attention goes through ``kernels.ops.
flash_attention``: the hand-written kernel for CUDA tensors, its plain
version for CPU tensors; the routed experts of an MoE layer go through
``kernels.ops.moe_dispatch`` and ``moe_combine`` the same way, with the
expert products as ``torch.bmm``.  ``moe_shard_map`` and the mesh helpers
(``maybe_constrain``, ``constrain_act``) are not ported: the port runs on
one card, where they are the identity (ROADMAP Queue 1 item 7a).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops

NEG_INF = -1.0e30
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def _normal(gen: torch.Generator | None, shape: tuple[int, ...], std: float, dtype, device) -> torch.Tensor:
    """N(0, std^2) draws in ``dtype`` (uninitialised when ``gen`` is None,
    for tensors a loader fills)."""
    if gen is None:
        return torch.empty(shape, dtype=dtype, device=device)
    return (torch.randn(shape, generator=gen, dtype=torch.float32, device=device) * std).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_rmsnorm(d: int, device=None) -> dict[str, torch.Tensor]:
    return {"scale": torch.zeros((d,), dtype=torch.float32, device=device)}


def rms_norm(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * (1.0 + p["scale"])
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE / M-RoPE
# ---------------------------------------------------------------------------


def _rope_angles(positions: torch.Tensor, head_dim: int, theta: float, sections=None) -> torch.Tensor:
    """positions: (B, T), or (3, B, T) for M-RoPE.  Returns (B, T, head_dim/2)
    angles.  M-RoPE splits the frequency slots into (t, h, w) sections, each
    driven by its own position row.  The section ids are cut or padded to
    the ``head_dim // 2`` slots as ``jnp.repeat(..., total_repeat_length=
    half)`` does: a longer run of ids is cut, a shorter one repeats its last
    id."""
    half = head_dim // 2
    freq = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=positions.device) * 2.0 / head_dim))
    if sections is None:
        pos = positions if positions.dim() == 2 else positions[0]
        return pos[..., None].float() * freq
    if positions.dim() != 3:
        raise ValueError("M-RoPE needs (3, B, T) positions")
    sec_id = torch.repeat_interleave(torch.arange(3, device=positions.device),
                                     torch.as_tensor(sections, device=positions.device))
    sec_id = torch.cat([sec_id[:half], sec_id[-1:].expand(max(half - len(sec_id), 0))])
    pos = positions[sec_id]  # (half, B, T)
    return pos.movedim(0, -1).float() * freq


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, sections=None) -> torch.Tensor:
    """x: (B, T, N, head_dim) -> rotated, pairs interleaved as ``[::2]`` /
    ``[1::2]`` (the reference's form, not a rotate-half)."""
    ang = _rope_angles(positions, x.shape[-1], theta, sections)  # (B, T, half)
    cos, sin = torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    r1 = x1 * cos - x2 * sin
    r2 = x2 * cos + x1 * sin
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


# ---------------------------------------------------------------------------
# Flash attention
# ---------------------------------------------------------------------------


def flash_attention(q, k, v, q_pos, k_pos, *, causal: bool, window: int | None, softcap: float | None):
    """q: (B, T, H, hd); k, v: (B, S, KV, hd) with H % KV == 0; q_pos (B, T)
    (or broadcastable); k_pos (B, S), -1 marks invalid slots.  Returns
    (B, T, H, hd) in q.dtype."""
    B, T = q.shape[:2]
    q_pos = q_pos.to(torch.int32).expand(B, T).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()
    return ops.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), q_pos, k_pos,
                               causal=causal, window=window, softcap=softcap)


# ---------------------------------------------------------------------------
# GQA attention layer
# ---------------------------------------------------------------------------


def init_attention(cfg: ModelConfig, gen: torch.Generator | None, device=None) -> dict[str, torch.Tensor]:
    D, H, KV, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = D**-0.5
    dt = cdtype(cfg)
    return {
        "wq": _normal(gen, (D, H * hd), s, dt, device),
        "wk": _normal(gen, (D, KV * hd), s, dt, device),
        "wv": _normal(gen, (D, KV * hd), s, dt, device),
        "wo": _normal(gen, (H * hd, D), (H * hd) ** -0.5, dt, device),
    }


def attention(p, x: torch.Tensor, q_pos: torch.Tensor, cfg: ModelConfig, *, local: bool, cache=None,
              want_cache: bool = False, cache_len: int | None = None, mrope_positions=None):
    """Returns (out, cache).  Modes:
    * cache is None  - prefill over T tokens, q_pos (B, T); with
      ``want_cache`` it also builds the decode cache of ``cache_len`` slots
      from this pass's k and v (``cache_from_prefill``), else returns None;
    * cache is a dict - decode: x is (B, 1, D), q_pos (B,); the token's k, v
      and position are written into ``cache`` IN PLACE at slot
      ``q_pos % S_c`` (rolling for local windows), and the cache returned.
    """
    B, T, _ = x.shape
    H, KV, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    window = cfg.window_size if local else None
    causal = not cfg.is_encoder
    q = (x @ p["wq"]).reshape(B, T, H, hd)
    k = (x @ p["wk"]).reshape(B, T, KV, hd)
    v = (x @ p["wv"]).reshape(B, T, KV, hd)
    if cfg.qk_norm:
        q = rms_norm(p["q_norm"], q, cfg.norm_eps)
        k = rms_norm(p["k_norm"], k, cfg.norm_eps)
    sections = cfg.mrope_sections
    rope_pos = mrope_positions if sections is not None else q_pos
    if sections is None and rope_pos.dim() == 1:
        rope_pos = rope_pos[:, None]  # decode: (B,) -> (B, 1)
    q = apply_rope(q, rope_pos, cfg.rope_theta, sections)
    k = apply_rope(k, rope_pos, cfg.rope_theta, sections)
    if cache is None:
        out = flash_attention(q, k, v, q_pos, q_pos, causal=causal, window=window, softcap=cfg.attn_softcap)
        new_cache = cache_from_prefill(cfg, k, v, q_pos, local=local, max_len=cache_len) if want_cache else None
    else:
        S_c = cache["k"].shape[1]
        slot = (q_pos % S_c).long()
        bidx = torch.arange(B, device=x.device)
        cache["k"][bidx, slot] = k[:, 0]
        cache["v"][bidx, slot] = v[:, 0]
        cache["pos"][bidx, slot] = q_pos.to(torch.int32)
        out = flash_attention(q, cache["k"], cache["v"], q_pos[:, None], cache["pos"], causal=causal,
                              window=window, softcap=cfg.attn_softcap)
        new_cache = cache
    return out.reshape(B, T, -1) @ p["wo"], new_cache


def build_cache(cfg: ModelConfig, batch: int, seq_len: int, *, local: bool, device=None) -> dict[str, torch.Tensor]:
    """Empty KV cache for one attention layer (pos = -1 marks invalid)."""
    S_c = min(cfg.window_size, seq_len) if local else seq_len
    dt = cdtype(cfg)
    shape = (batch, S_c, cfg.num_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=dt, device=device),
        "v": torch.zeros(shape, dtype=dt, device=device),
        "pos": torch.full((batch, S_c), -1, dtype=torch.int32, device=device),
    }


def cache_from_prefill(cfg: ModelConfig, k, v, positions, *, local: bool, max_len: int | None = None):
    """Build a decode cache from prefill-computed k/v.

    Entries land at slot ``pos % S_c``, the mapping decode writes with, so
    prefill + decode agree for local windows, and global caches sized
    ``max_len > T`` leave room for decoded tokens."""
    B, T = positions.shape
    max_len = max_len or T
    S_c = min(cfg.window_size, max_len) if local else max_len
    if T > S_c:  # only the last window can matter
        k, v, positions = k[:, -S_c:], v[:, -S_c:], positions[:, -S_c:]
    cache = build_cache(cfg, B, max_len, local=local, device=k.device)
    bidx = torch.arange(B, device=k.device)[:, None]
    slot = (positions % S_c).long()
    cache["k"][bidx, slot] = k.to(cache["k"].dtype)
    cache["v"][bidx, slot] = v.to(cache["v"].dtype)
    cache["pos"][bidx, slot] = positions.to(torch.int32)
    return cache


# ---------------------------------------------------------------------------
# Dense MLP (SwiGLU / GeGLU)
# ---------------------------------------------------------------------------


def init_mlp(cfg: ModelConfig, gen: torch.Generator | None, device=None, d_ff: int | None = None):
    D, F_ = cfg.d_model, d_ff or cfg.d_ff
    dt = cdtype(cfg)
    return {
        "wi": _normal(gen, (D, F_), D**-0.5, dt, device),
        "wg": _normal(gen, (D, F_), D**-0.5, dt, device),
        "wo": _normal(gen, (F_, D), F_**-0.5, dt, device),
    }


def mlp(p, x: torch.Tensor, activation: str) -> torch.Tensor:
    # jax.nn.gelu defaults to the tanh approximation
    g = x @ p["wg"]
    act = F.gelu(g, approximate="tanh") if activation == "gelu" else F.silu(g)
    return (act * (x @ p["wi"])) @ p["wo"]


# ---------------------------------------------------------------------------
# Mixture of Experts (sort-based dispatch, capacity-bounded)
# ---------------------------------------------------------------------------


def init_moe(cfg: ModelConfig, gen: torch.Generator | None, device=None) -> dict[str, torch.Tensor]:
    """Router (D, E) float32; experts wi, wg (E, D, Fe) and wo (E, Fe, D) in
    the compute dtype, at the reference's scales."""
    D, E, Fe = cfg.d_model, cfg.num_experts, cfg.moe_d_ff
    dt = cdtype(cfg)
    return {
        "router": _normal(gen, (D, E), D**-0.5, torch.float32, device),
        "wi": _normal(gen, (E, D, Fe), D**-0.5, dt, device),
        "wg": _normal(gen, (E, D, Fe), D**-0.5, dt, device),
        "wo": _normal(gen, (E, Fe, D), Fe**-0.5, dt, device),
    }


def route(xf: torch.Tensor, router: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """xf (N, D), router (D, E) f32 -> (probs (N, E), weights (N, k) f32
    renormalised, ids (N, k) int32).  ``jax.lax.top_k`` puts the lower
    expert index first among equal probabilities; ``torch.topk`` promises no
    order among ties, so the top k come from a stable descending sort."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    weights, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    weights, ids = weights[:, :k], ids[:, :k]
    weights = weights / torch.clamp(weights.sum(-1, keepdim=True), min=1e-9)
    return probs, weights, ids.to(torch.int32)


def _moe_dispatch_compute(xf, router, wi, wg, wo, *, cfg: ModelConfig, e_offset: int, E_local: int, capacity: int):
    """The MoE math over a flat token block against the expert slice
    ``[e_offset, e_offset + E_local)``: xf (N, D); router (D, E); wi, wg
    (E_local, D, Fe); wo (E_local, Fe, D).  Returns (out (N, D), aux): the
    slice's part of the output and the load-balancing loss (Switch:
    ``E * sum_e density_e * mean_prob_e``, density from each token's first
    choice).  Assignments to experts outside the slice, and those past an
    expert's ``capacity`` in flat order, add nothing (GShard)."""
    N, _ = xf.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    probs, weights, ids = route(xf, router, k)
    local = ids - e_offset  # outside [0, E_local): another slice's assignment
    buf, pos = ops.moe_dispatch(xf, local, E_local, capacity)
    h = F.silu(torch.bmm(buf, wg)) * torch.bmm(buf, wi)
    out = ops.moe_combine(torch.bmm(h, wo), local, pos, weights)
    density = torch.bincount(ids[:, 0].long(), minlength=E).float() / N
    aux = E * torch.sum(density * probs.mean(dim=0))
    return out, aux


def moe(p, x: torch.Tensor, cfg: ModelConfig):
    """Top-k routed experts with capacity-bounded sort-based dispatch: x (B,
    T, D) -> (out (B, T, D), aux loss).  The capacity is the reference's,
    ``int(N * k / E * capacity_factor) + 1`` with N = B * T tokens of this
    call, so a decode step (N = B) and a prefill drop differently."""
    B, T, D = x.shape
    E, k = cfg.num_experts, cfg.experts_per_token
    N = B * T
    capacity = int(N * k / E * cfg.capacity_factor) + 1
    out, aux = _moe_dispatch_compute(x.reshape(N, D), p["router"], p["wi"], p["wg"], p["wo"], cfg=cfg, e_offset=0,
                                     E_local=E, capacity=capacity)
    return out.reshape(B, T, D), aux
