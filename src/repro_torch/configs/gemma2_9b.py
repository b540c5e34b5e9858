"""gemma2-9b [dense] — 42L d_model=3584 16H (GQA kv=8) head_dim=256
d_ff=14336 vocab=256000; local(4096)/global alternating attention, attention
logit softcap 50, final logit softcap 30, GeGLU, pre+post norms, scaled
embeddings.  [arXiv:2408.00118]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma2-9b",
    family="dense",
    num_layers=42,
    d_model=3584,
    num_heads=16,
    num_kv_heads=8,
    head_dim=256,
    d_ff=14336,
    vocab_size=256000,
    block_pattern=("local", "global"),
    window_size=4096,
    attn_softcap=50.0,
    final_softcap=30.0,
    rope_theta=10000.0,
    mlp_activation="gelu",
    use_post_norm=True,
    scale_embed=True,
    tie_embeddings=True,
)
