"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536; Finch: data-dependent decay linear recurrence (64-dim heads).
[arXiv:2404.05892]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,  # d_model / 64 rwkv heads (informational; mixer derives it)
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    block_pattern=("rwkv",),
    parallelism="fsdp",  # attention-free 1.6B: FSDP-only
)
