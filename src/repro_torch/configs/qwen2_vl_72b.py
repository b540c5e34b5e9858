"""qwen2-vl-72b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=29568
vocab=152064; M-RoPE (temporal/height/width sections 16/24/24 of the 64
frequency slots), dynamic-resolution vision frontend STUBBED: input_specs
provides precomputed patch embeddings injected into the token stream.
[arXiv:2409.12191]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    num_layers=80,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=29568,
    vocab_size=152064,
    block_pattern=("dense",),
    rope_theta=1000000.0,
    mrope_sections=(16, 24, 24),
    frontend="vision_patches",
    num_patches=256,
)
