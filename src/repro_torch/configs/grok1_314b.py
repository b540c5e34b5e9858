"""grok-1-314b [moe] — 64L d_model=6144 48H (GQA kv=8) d_ff=32768
vocab=131072; MoE 8 experts top-2.  Expert FFNs tensor-sharded over the model
axis ("tp" MoE sharding: 8 experts don't divide the 16-way axis).
[hf:xai-org/grok-1]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="grok-1-314b",
    family="moe",
    num_layers=64,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=32768,
    vocab_size=131072,
    block_pattern=("moe",),
    num_experts=8,
    experts_per_token=2,
    moe_d_ff=32768,
    moe_sharding="tp",
    seq_shard=True,  # SPerf: activations/remat carries shard T over model
)
