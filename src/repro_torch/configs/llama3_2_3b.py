"""llama3.2-3b [dense] — 28L d_model=3072 24H (GQA kv=8) d_ff=8192
vocab=128256; llama3 rope theta 500000.  [hf:meta-llama/Llama-3.2-3B]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama3.2-3b",
    family="dense",
    num_layers=28,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=128256,
    block_pattern=("dense",),
    rope_theta=500000.0,
    tie_embeddings=True,
    parallelism="fsdp",  # 24 heads don't divide a 16-way TP axis; 3B fits FSDP-only
)
