"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000; Griffin: RG-LRU recurrent blocks + local attention in a 2:1
pattern, window 2048, rnn width 2560.  [arXiv:2402.19427]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    head_dim=256,
    d_ff=7680,
    vocab_size=256000,
    block_pattern=("rglru", "rglru", "local"),
    window_size=2048,
    rnn_width=2560,
    conv_width=4,
    mlp_activation="gelu",
    scale_embed=True,
    tie_embeddings=True,
    parallelism="fsdp",  # 10 heads / 2.7B params: FSDP-only
)
