"""Plain reference of a decoder of attention and routed-expert layers, the
architecture of ``qwen3-moe-235b-a22b`` as the program defines it.

Each layer: RMS norm, grouped-query attention (q and k normed per head,
rotary angles on interleaved pairs, causal), residual; RMS norm, routed
experts (softmax router in f32, the top k by probability with the lower
expert first among equals, weights renormalised; each expert takes at most
``int(N k / E * capacity_factor) + 1`` assignments of a call's N tokens,
in token order; SwiGLU experts), residual.  Then the final norm and the
head.  The load-balancing loss is Switch's, ``E * sum_e density_e *
mean_prob_e`` over first choices, added to the cross-entropy times
``aux_loss_coef``.  The norms scale by ``1 + scale``.

Departures of the program (and so of this reference) from the published
Qwen3-MoE, noted in PERF.md: the norms' ``1 + scale``, rotary pairs
interleaved rather than split in halves, and the experts' capacity bound
(the published model drops no assignment).

Plain PyTorch in float32 (the weights are the served bfloat16 values, made
f32).  Nothing here imports the program under test.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from perfbench.reference.common import Precision, causal_attention, cross_entropy, rms_norm, rope


def dims(cfg: dict) -> dict:
    return dict(D=cfg["hidden_size"], H=cfg["num_attention_heads"], KV=cfg["num_key_value_heads"],
                hd=cfg["head_dim"], E=cfg["num_experts"], k=cfg["num_experts_per_tok"],
                Fe=cfg["moe_intermediate_size"], V=cfg["vocab_size"], L=cfg["num_hidden_layers"])


def param_specs(cfg: dict) -> list[tuple[str, tuple[int, ...], str, tuple]]:
    """(name, shape, served dtype, draw) of every parameter, by the
    program's names.  A draw is ("normal", std) or ("uniform", lo, hi)."""
    d = dims(cfg)
    D, H, KV, hd, E, Fe, V = d["D"], d["H"], d["KV"], d["hd"], d["E"], d["Fe"], d["V"]
    norm, dt = ("normal", cfg["norm_scale_std"]), cfg["dtype"]
    specs = [("embed", (V, D), dt, ("normal", D**-0.5))]
    for i in range(d["L"]):
        p = f"layers.{i}."
        specs += [
            (p + "ln1.scale", (D,), "float32", norm),
            (p + "attn.wq", (D, H * hd), dt, ("normal", D**-0.5)),
            (p + "attn.wk", (D, KV * hd), dt, ("normal", D**-0.5)),
            (p + "attn.wv", (D, KV * hd), dt, ("normal", D**-0.5)),
            (p + "attn.wo", (H * hd, D), dt, ("normal", (H * hd) ** -0.5)),
            (p + "attn.q_norm.scale", (hd,), "float32", norm),
            (p + "attn.k_norm.scale", (hd,), "float32", norm),
            (p + "ln2.scale", (D,), "float32", norm),
            (p + "moe.router", (D, E), "float32", ("normal", D**-0.5)),
            (p + "moe.wi", (E, D, Fe), dt, ("normal", D**-0.5)),
            (p + "moe.wg", (E, D, Fe), dt, ("normal", D**-0.5)),
            (p + "moe.wo", (E, Fe, D), dt, ("normal", Fe**-0.5)),
        ]
    specs += [("final_norm.scale", (D,), "float32", norm), ("lm_head", (D, V), dt, ("normal", D**-0.5))]
    return specs


def _attention(P: dict, p: str, h: torch.Tensor, cfg: dict, prec: Precision):
    d = dims(cfg)
    B, T, _ = h.shape
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    q = prec.mm(h, P[p + "attn.wq"]).view(B, T, d["H"], d["hd"])
    k = prec.mm(h, P[p + "attn.wk"]).view(B, T, d["KV"], d["hd"])
    v = prec.mm(h, P[p + "attn.wv"]).view(B, T, d["KV"], d["hd"])
    q = rope(rms_norm(q, P[p + "attn.q_norm.scale"], eps), theta)
    k = rope(rms_norm(k, P[p + "attn.k_norm.scale"], eps), theta)
    o = causal_attention(q, k, v, prec)
    return prec.mm(o.reshape(B, T, -1), P[p + "attn.wo"]), k, v


def _experts(P: dict, p: str, x: torch.Tensor, cfg: dict, prec: Precision):
    """x (N, D) -> (out (N, D), aux)."""
    d = dims(cfg)
    N = x.shape[0]
    E, k = d["E"], d["k"]
    probs = torch.softmax(prec.mm(x, P[p + "moe.router"]), dim=-1)
    w, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, ids = w[:, :k], ids[:, :k]
    w = w / w.sum(-1, keepdim=True).clamp(min=1e-9)
    cap = int(N * k / E * cfg["capacity_factor"]) + 1
    flat = ids.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat)
    rank[order] = torch.arange(flat.numel(), device=x.device) - starts[flat[order]]
    kept = rank < cap
    tok = torch.arange(N, device=x.device).repeat_interleave(k)
    out = torch.zeros_like(x)
    wf = w.reshape(-1)
    for e in range(E):
        sel = torch.nonzero((flat == e) & kept)[:, 0]
        if sel.numel() == 0:
            continue
        xe = x[tok[sel]]
        he = F.silu(prec.mm(xe, P[p + "moe.wg"][e])) * prec.mm(xe, P[p + "moe.wi"][e])
        out = out.index_add(0, tok[sel], prec.mm(he, P[p + "moe.wo"][e]) * wf[sel, None])
    density = torch.bincount(ids[:, 0], minlength=E).float() / N
    aux = E * torch.sum(density * probs.mean(dim=0))
    return out, aux


def _layer(P: dict, i: int, x: torch.Tensor, cfg: dict, prec: Precision):
    p = f"layers.{i}."
    eps = cfg["rms_norm_eps"]
    B, T, D = x.shape
    a, k, v = _attention(P, p, rms_norm(x, P[p + "ln1.scale"], eps), cfg, prec)
    x = x + a
    ff, aux = _experts(P, p, rms_norm(x, P[p + "ln2.scale"], eps).reshape(B * T, D), cfg, prec)
    return x + ff.view(B, T, D), aux, k, v


def prefill(P: dict, tokens: torch.Tensor, cfg: dict, prec: Precision, cache_len: int):
    """tokens (B, T) -> (last-position logits (B, V), cache: one {k, v, pos}
    a layer, ``cache_len`` slots, positions 0..T-1 filled, -1 after)."""
    x = P["embed"][tokens]
    B, T = tokens.shape
    cache = []
    for i in range(dims(cfg)["L"]):
        x, _, k, v = _layer(P, i, x, cfg, prec)
        kc = k.new_zeros((B, cache_len) + k.shape[2:])
        vc = v.new_zeros((B, cache_len) + v.shape[2:])
        kc[:, :T], vc[:, :T] = k, v
        pos = torch.full((B, cache_len), -1, dtype=torch.int32, device=x.device)
        pos[:, :T] = torch.arange(T, dtype=torch.int32, device=x.device)
        cache.append({"k": kc, "v": vc, "pos": pos})
    h = rms_norm(x[:, -1], P["final_norm.scale"], cfg["rms_norm_eps"])
    return prec.mm(h, P["lm_head"]), cache


def loss(P: dict, batch: dict, cfg: dict, prec: Precision) -> torch.Tensor:
    """The training loss of a batch: mean masked cross-entropy plus
    ``aux_loss_coef`` times the layers' summed aux loss; each layer under
    ``checkpoint`` where the configuration says ``remat``."""
    x = P["embed"][batch["tokens"]]
    aux = x.new_zeros(())
    for i in range(dims(cfg)["L"]):
        if cfg["remat"]:
            x, a, _, _ = checkpoint(_layer, P, i, x, cfg, prec, use_reentrant=False)
        else:
            x, a, _, _ = _layer(P, i, x, cfg, prec)
        aux = aux + a
    h = rms_norm(x, P["final_norm.scale"], cfg["rms_norm_eps"])
    D = h.shape[-1]
    ce = cross_entropy(h.reshape(-1, D), P["lm_head"], batch["labels"].reshape(-1).long(),
                       batch["mask"].reshape(-1).float(), prec)
    return ce + cfg["aux_loss_coef"] * aux
