"""Architecture config registry (``--arch <id>``), copied from
``repro/configs/__init__.py``."""
from __future__ import annotations

from repro_torch.configs.base import (
    ALL_SHAPES, ArchConfig, ShapeSpec, shapes_for,
    TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K,
)

from repro_torch.configs import (  # noqa: E402
    zamba2_7b, hubert_xlarge, llama32_vision_90b, mamba2_130m, phi35_moe,
    llama4_scout, gemma_7b, minitron_8b, gemma3_27b, qwen15_4b,
)

REGISTRY = {
    m.CONFIG.name: m.CONFIG
    for m in (
        zamba2_7b, hubert_xlarge, llama32_vision_90b, mamba2_130m, phi35_moe,
        llama4_scout, gemma_7b, minitron_8b, gemma3_27b, qwen15_4b,
    )
}

ARCH_IDS = tuple(sorted(REGISTRY))


def get_config(arch: str) -> ArchConfig:
    try:
        return REGISTRY[arch]
    except KeyError:
        raise KeyError(f"unknown arch {arch!r}; available: {', '.join(ARCH_IDS)}")


def get_shape(name: str) -> ShapeSpec:
    for s in ALL_SHAPES:
        if s.name == name:
            return s
    raise KeyError(f"unknown shape {name!r}")


__all__ = [
    "ArchConfig", "ShapeSpec", "REGISTRY", "ARCH_IDS", "get_config",
    "get_shape", "shapes_for", "ALL_SHAPES",
    "TRAIN_4K", "PREFILL_32K", "DECODE_32K", "LONG_500K",
]
