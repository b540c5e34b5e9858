"""Architecture registry: ``--arch <id>`` resolution for every launcher."""

from __future__ import annotations

from repro_torch.configs import (
    deepseek_67b,
    gemma2_9b,
    grok1_314b,
    hubert_xlarge,
    llama3_2_3b,
    mistral_large_123b,
    qwen2_vl_72b,
    qwen3_moe_235b,
    recurrentgemma_2b,
    rwkv6_1_6b,
)
from repro_torch.configs.base import ModelConfig

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in (
        gemma2_9b.CONFIG,
        llama3_2_3b.CONFIG,
        mistral_large_123b.CONFIG,
        deepseek_67b.CONFIG,
        rwkv6_1_6b.CONFIG,
        grok1_314b.CONFIG,
        qwen3_moe_235b.CONFIG,
        qwen2_vl_72b.CONFIG,
        recurrentgemma_2b.CONFIG,
        hubert_xlarge.CONFIG,
    )
}


def get_config(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]
