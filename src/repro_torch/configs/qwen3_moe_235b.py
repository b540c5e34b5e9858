"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) expert
d_ff=1536 vocab=151936; MoE 128 experts top-8, q/k norm, head_dim 128.
Experts sharded over the model axis ("ep": 8 experts per device).
[hf:Qwen/Qwen3-235B-A22B]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    num_layers=94,
    d_model=4096,
    num_heads=64,
    num_kv_heads=4,
    head_dim=128,
    d_ff=1536,
    vocab_size=151936,
    block_pattern=("moe",),
    num_experts=128,
    experts_per_token=8,
    moe_d_ff=1536,
    moe_sharding="ep",
    qk_norm=True,
    rope_theta=1000000.0,
    seq_shard=True,  # SPerf: activations/remat carries shard T over model
)
