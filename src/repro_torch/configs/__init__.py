"""Config registry of the port.

``get_config(arch_id)`` returns the full published config;
``get_reduced_config(arch_id)`` the CPU-testable variant of the same
family. Only qwen2.5-3b is registered so far; the other architectures of
``repro.configs`` are queued in ROADMAP.md.
"""

from __future__ import annotations

import importlib
from typing import List

from repro_torch.configs.base import ModelConfig, torch_dtype

ARCH_IDS: List[str] = ["qwen2_5_3b"]

# CLI ids with dashes/dots map onto module names.
_ALIASES = {"qwen2.5-3b": "qwen2_5_3b"}


def canonical_id(arch: str) -> str:
    return _ALIASES.get(arch, arch)


def _module(arch: str):
    arch_id = canonical_id(arch)
    if arch_id not in ARCH_IDS:
        raise ValueError(f"architecture {arch!r} is not ported (have {ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch: str) -> ModelConfig:
    cfg: ModelConfig = _module(arch).config()
    cfg.validate()
    return cfg


def get_reduced_config(arch: str) -> ModelConfig:
    cfg: ModelConfig = _module(arch).reduced_config()
    cfg.validate()
    if cfg.num_layers > 2 or cfg.d_model > 512 or cfg.num_experts > 4:
        raise ValueError(f"{cfg.name} is not a reduced config")
    return cfg


__all__ = [
    "ARCH_IDS",
    "ModelConfig",
    "canonical_id",
    "get_config",
    "get_reduced_config",
    "torch_dtype",
]
