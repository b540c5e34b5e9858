"""The yardstick's arithmetic: the card's peaks, the model FLOPs behind
``mfu``, and each kernel's least time (its roofline bound).

Peaks: NVIDIA's data sheet for one H100 SXM (dense, at 700 W), as the
program's ``launch/roofline.HW`` has them.

Model FLOPs.  N counts the parameters a token's forward touches as
products: attention's four projections, the router, the ``k`` routed
experts (not the capacity's padding), the recurrent mixers' products
(RWKV-6: r, k, v, g, output, the decay's two low-rank products, the
channel mix's three); never the embedding lookup, norms or mixes.
Training: 6 N per token with the head (every position's logits), plus
attention's score and value products, 6 H hd T_ctx per token at causal
context (half of PaLM's 12 L H hd T). Prefill: 2 N per token without the
head, the head's 2 D V for each sequence's last position, and attention's
4 hd per (query, key) pair at or before it, for each head.  The WKV
recurrence's products (about 0.4% of RWKV-6's) are not counted.

Bounds: the larger of operations at the peak of the unit the kernel runs
on and bytes at the HBM rate, counting each input read once and each
output written once.
* flash (forward): 4 hd operations a causal pair, bf16; q, k, v read, o
  written (bf16), positions read (int32).
* flash_bwd: 10 hd a pair (2.5 times the forward); q, k, v, o, dO read,
  dq, dk, dv written (bf16), lse read (f32), positions read.
* rwkv_wkv: the token form's 5 operations a (key, value) pair, TF32; r, k,
  v, logw read and o written, S0 read and S written (f32), u read.
* rwkv_wkv_bwd: 14 a pair, TF32; r, k, v, logw, dO read, dr, dk, dv,
  dlogw written, S0, dS read, dS0 written (f32), u read, du written.
"""

from __future__ import annotations

PEAK = {
    "bf16": 989e12,  # FLOP/s on the tensor cores
    "tf32": 495e12,
    "f32": 67e12,  # outside the tensor cores
    "hbm": 3.35e12,  # B/s
}


def bound_s(nbytes: float, nops: float, unit: str) -> float:
    """The least time: the larger of the bytes at the HBM rate and the
    operations at ``unit``'s peak."""
    return max(nbytes / PEAK["hbm"], nops / PEAK[unit])


def causal_pairs(T: int) -> int:
    return T * (T + 1) // 2


# ---------------------------------------------------------------------------
# Parameters touched as products, a token
# ---------------------------------------------------------------------------


def product_params(cfg: dict) -> dict[str, int]:
    """{"layers": N of the layers a token, "head": the head's D V}."""
    ref = cfg["reference"]
    if ref == "decoder":
        D, H, KV, hd = cfg["hidden_size"], cfg["num_attention_heads"], cfg["num_key_value_heads"], cfg["head_dim"]
        E, k, Fe = cfg["num_experts"], cfg["num_experts_per_tok"], cfg["moe_intermediate_size"]
        per = D * H * hd + 2 * D * KV * hd + H * hd * D + D * E + k * 3 * D * Fe
        return {"layers": cfg["num_hidden_layers"] * per, "head": D * cfg["vocab_size"]}
    if ref == "rwkv6":
        D, F = cfg["hidden_size"], cfg["intermediate_size"]
        per = 5 * D * D + 2 * D * 32 + 2 * D * F + D * D
        return {"layers": cfg["num_hidden_layers"] * per, "head": D * cfg["vocab_size"]}
    raise ValueError(f"no product count for reference {ref!r}")


def attention_layers(cfg: dict) -> int:
    return cfg["num_hidden_layers"] if cfg["reference"] == "decoder" else 0


def train_flops(cfg: dict, B: int, T: int) -> float:
    """Model FLOPs of one optimizer step over B rows of T tokens."""
    n = product_params(cfg)
    flops = 6.0 * (n["layers"] + n["head"]) * B * T
    L = attention_layers(cfg)
    if L:
        flops += 6.0 * L * cfg["num_attention_heads"] * cfg["head_dim"] * B * causal_pairs(T) * 2
    return flops


def prefill_flops(cfg: dict, B: int, T: int) -> float:
    """Model FLOPs of one prefill call of B prompts of T tokens (the head
    on the last position)."""
    n = product_params(cfg)
    flops = 2.0 * n["layers"] * B * T + 2.0 * n["head"] * B
    L = attention_layers(cfg)
    if L:
        flops += 4.0 * L * cfg["num_attention_heads"] * cfg["head_dim"] * B * causal_pairs(T)
    return flops


# ---------------------------------------------------------------------------
# Kernel bounds, a call
# ---------------------------------------------------------------------------


def flash_bound_s(B: int, T: int, H: int, KV: int, hd: int) -> float:
    pairs = B * H * causal_pairs(T)
    nbytes = 2 * (2 * B * T * H * hd + 2 * B * T * KV * hd) + 4 * 2 * B * T
    return bound_s(nbytes, 4.0 * hd * pairs, "bf16")


def flash_bwd_bound_s(B: int, T: int, H: int, KV: int, hd: int) -> float:
    pairs = B * H * causal_pairs(T)
    nbytes = 2 * (4 * B * T * H * hd + 4 * B * T * KV * hd + B * T * H * hd) + 4 * B * T * H + 4 * 2 * B * T
    return bound_s(nbytes, 10.0 * hd * pairs, "bf16")


def wkv_bound_s(B: int, T: int, H: int, n: int = 64) -> float:
    x = B * T * H * n
    nbytes = 4 * (5 * x + 2 * B * H * n * n + H * n)
    return bound_s(nbytes, 5.0 * x * n, "tf32")


def wkv_bwd_bound_s(B: int, T: int, H: int, n: int = 64) -> float:
    x = B * T * H * n
    nbytes = 4 * (9 * x + 3 * B * H * n * n + 2 * H * n)
    return bound_s(nbytes, 14.0 * x * n, "tf32")
