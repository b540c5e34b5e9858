"""Model/config system: every assigned architecture is a ``ModelConfig``;
every benchmark cell is a ``ShapeSpec``.

Port of ``repro.configs.base`` without ``input_specs``: the reference builds
``jax.ShapeDtypeStruct`` stand-ins there for XLA's dry-run, which the port
has no counterpart of (ROADMAP Queue 1 item 8).
"""

from __future__ import annotations

import dataclasses

# ---------------------------------------------------------------------------
# Architecture config
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # dense | ssm | moe | vlm | hybrid | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # layer pattern, cycled over num_layers (see models/model.py)
    # kinds: "dense" | "local" | "global" | "moe" | "rwkv" | "rglru"
    block_pattern: tuple[str, ...] = ("dense",)

    # attention details
    window_size: int = 4096  # for "local" layers
    attn_softcap: float | None = None
    final_softcap: float | None = None
    rope_theta: float = 10000.0
    mrope_sections: tuple[int, int, int] | None = None  # qwen2-vl M-RoPE (t, h, w)

    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    moe_sharding: str = "ep"  # "ep": experts over model axis; "tp": expert FFN over model axis
    capacity_factor: float = 1.25

    # recurrent (rwkv / rglru)
    rnn_width: int = 0  # RG-LRU recurrent width (recurrentgemma: d_model)
    conv_width: int = 4

    # encoder-only (no causal mask, no decode path)
    is_encoder: bool = False

    # modality frontend stub: None | "audio_frames" | "vision_patches"
    frontend: str | None = None
    frontend_dim: int = 0  # raw feature dim provided by the stub
    num_patches: int = 0  # vision: patch embeddings injected per sequence

    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    qk_norm: bool = False  # qwen3: rmsnorm on q/k heads
    use_post_norm: bool = False  # gemma2: pre+post norm sandwich
    mlp_activation: str = "silu"  # "silu" | "gelu"
    scale_embed: bool = False  # gemma: embeddings * sqrt(d_model)

    # distribution strategy
    # "tp":   params FSDP x tensor-parallel over "model" (heads/ff/vocab);
    #         requires num_heads % model_axis == 0 (the 6 large archs).
    # "fsdp": params fully sharded over every mesh axis, no tensor split;
    #         right for the <=3B archs where TP-16 would shard 24/10 heads.
    parallelism: str = "tp"
    # Megatron-style sequence parallelism: layer-boundary activations (and
    # the remat carries the backward saves) shard T over "model"; attention
    # gathers the sequence per layer.  Trades collective bytes for the
    # activation memory term — applied in the SPerf iterations.
    seq_shard: bool = False

    # training defaults
    dtype: str = "bfloat16"
    remat: bool = True

    def __post_init__(self):
        assert self.num_heads % max(self.num_kv_heads, 1) == 0
        assert self.num_layers >= len(self.block_pattern)

    @property
    def layer_kinds(self) -> tuple[str, ...]:
        """The per-layer kind sequence (pattern cycled to num_layers)."""
        p = self.block_pattern
        return tuple(p[i % len(p)] for i in range(self.num_layers))

    @property
    def has_decode(self) -> bool:
        return not self.is_encoder

    def param_count(self) -> int:
        """Analytic parameter count (used for 6*N*D model FLOPs)."""
        D, H, KV, hd, F, V, L = (
            self.d_model,
            self.num_heads,
            self.num_kv_heads,
            self.head_dim,
            self.d_ff,
            self.vocab_size,
            self.num_layers,
        )
        total = V * D  # embed
        if not self.tie_embeddings:
            total += D * V  # lm_head
        for kind in self.layer_kinds:
            if kind in ("dense", "local", "global", "moe"):
                total += D * H * hd + 2 * D * KV * hd + H * hd * D  # attention
                total += 2 * D  # norms
                if kind == "moe":
                    total += D * self.num_experts
                    total += self.num_experts * 3 * D * self.moe_d_ff
                else:
                    total += 3 * D * F  # swiglu
            elif kind == "rwkv":
                total += 2 * D  # norms
                total += 5 * D * D  # time mix: r,k,v,g + output
                total += 2 * D * 32 + 9 * D  # decay low-rank adapters + mixes/bonus/out_norm
                total += 2 * D * F + D * D  # channel mix: wk (D,F), wv (F,D), wr (D,D)
            elif kind == "rglru":
                R = self.rnn_width or D
                total += 2 * D
                total += 2 * D * R + R * D  # in/gate + out proj
                # the recurrence and input gates w_r, w_i (R, R): the
                # reference's count leaves them out (8% of recurrentgemma-2b)
                total += 2 * R * R
                total += self.conv_width * R + 2 * R  # conv + rg-lru params
                total += 3 * D * F  # mlp
        total += D  # final norm
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only routed experts)."""
        if self.num_experts == 0:
            return self.param_count()
        per_expert = 3 * self.d_model * self.moe_d_ff
        n_moe = sum(1 for k in self.layer_kinds if k == "moe")
        inactive = n_moe * (self.num_experts - self.experts_per_token) * per_expert
        return self.param_count() - inactive

    def reduced(self, vocab: int = 512) -> "ModelConfig":
        """Tiny same-family variant for CPU smoke tests."""
        pat = len(self.block_pattern)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            num_layers=max(2 * pat, pat),
            d_model=64,
            num_heads=4,
            num_kv_heads=max(1, 4 // max(self.num_heads // max(self.num_kv_heads, 1), 1)),
            head_dim=16,
            d_ff=128,
            vocab_size=vocab,
            num_experts=min(self.num_experts, 4) if self.num_experts else 0,
            experts_per_token=min(self.experts_per_token, 2) if self.num_experts else 0,
            moe_d_ff=32 if self.num_experts else 0,
            rnn_width=64 if self.rnn_width else 0,
            window_size=32,
            frontend_dim=16 if self.frontend_dim else 0,
            num_patches=8 if self.num_patches else 0,
            remat=False,
        )


# ---------------------------------------------------------------------------
# Benchmark shapes (assigned cells)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str  # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


TRAIN_4K = ShapeSpec("train_4k", "train", 4096, 256)
PREFILL_32K = ShapeSpec("prefill_32k", "prefill", 32768, 32)
DECODE_32K = ShapeSpec("decode_32k", "decode", 32768, 128)
LONG_500K = ShapeSpec("long_500k", "decode", 524288, 1)

SHAPES: dict[str, ShapeSpec] = {s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)}

# Archs allowed to run long_500k (sub-quadratic / bounded-state decode); the
# skip rationale for the rest is in DESIGN.md / EXPERIMENTS.md.
LONG_CONTEXT_OK = ("rwkv6-1.6b", "recurrentgemma-2b")


def shape_applicable(config: ModelConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable?, reason-if-not) for an (arch x shape) cell."""
    if config.is_encoder and shape.kind == "decode":
        return False, "encoder-only architecture has no decode step"
    if shape.name == "long_500k" and config.name not in LONG_CONTEXT_OK:
        return False, "pure full-attention KV cache at 524288 tokens (assignment: sub-quadratic archs only)"
    return True, ""
