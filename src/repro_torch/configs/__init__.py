"""Architecture registry: ``get_config("<arch-id>")`` / ``--arch <id>``,
the reference's ten architectures."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    SHAPES, ArchConfig, MoEConfig, RGLRUConfig, ShapeConfig, SSMConfig,
    flops_per_step, input_specs, shape_applicable,
)

_MODULES = {
    "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
    "arctic-480b": "arctic_480b",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "musicgen-medium": "musicgen_medium",
    "paligemma-3b": "paligemma_3b",
    "qwen2-72b": "qwen2_72b",
    "granite-34b": "granite_34b",
    "gemma2-27b": "gemma2_27b",
    "gemma3-4b": "gemma3_4b",
    "falcon-mamba-7b": "falcon_mamba_7b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ArchConfig:
    arch = arch.replace("_", "-")
    if arch.endswith("-smoke"):
        return get_config(arch[: -len("-smoke")]).smoke()
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG
