"""Architecture registry: ``get_config(arch_id)`` / ``get_smoke(arch_id)``."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    LONG_500K,
    DECODE_32K,
    PREFILL_32K,
    SHAPES,
    SMOKE_SHAPE,
    TRAIN_4K,
    ModelConfig,
    ShapeConfig,
    reduce_config,
    shapes_for,
)

ARCH_IDS = (
    "qwen3-32b",
    "llama3.2-1b",
    "yi-9b",
    "stablelm-3b",
    "deepseek-v2-lite-16b",
    "dbrx-132b",
    "jamba-v0.1-52b",
    "falcon-mamba-7b",
    "internvl2-1b",
    "musicgen-large",
)


def _module(arch_id: str):
    mod = arch_id.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(arch_id: str) -> ModelConfig:
    if arch_id not in ARCH_IDS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {ARCH_IDS}")
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()
