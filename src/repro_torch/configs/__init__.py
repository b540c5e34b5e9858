# Assigned-architecture registry: get_config("<arch-id>") returns the exact
# published configuration; get_config(id).reduced() the CPU smoke variant.
# Port of ``repro.configs`` (pure data; ``input_specs`` is not ported).
from repro_torch.configs.base import (
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    ModelConfig,
    ShapeSpec,
    shape_applicable,
)
from repro_torch.configs.registry import ARCHS, get_config

__all__ = [
    "ARCHS",
    "DECODE_32K",
    "LONG_500K",
    "PREFILL_32K",
    "SHAPES",
    "TRAIN_4K",
    "ModelConfig",
    "ShapeSpec",
    "get_config",
    "shape_applicable",
]
