"""hubert-xlarge [audio] — 48L d_model=1280 16H (kv=16, full MHA) d_ff=5120
vocab=504; encoder-only (wav2vec2 architecture).  The conv waveform frontend
is STUBBED: input_specs provides precomputed 512-dim frame embeddings, the
model projects them to d_model.  No decode step.  [arXiv:2106.07447]"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="hubert-xlarge",
    family="audio",
    num_layers=48,
    d_model=1280,
    num_heads=16,
    num_kv_heads=16,
    head_dim=80,
    d_ff=5120,
    vocab_size=504,
    block_pattern=("dense",),
    is_encoder=True,
    frontend="audio_frames",
    frontend_dim=512,
    mlp_activation="gelu",
    parallelism="fsdp",  # 1B encoder: FSDP-only
)
