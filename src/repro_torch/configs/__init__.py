"""Config registry of the port.

``get_config(arch_id)`` returns the full published config;
``get_reduced_config(arch_id)`` the CPU-testable variant of the same
family. Registered: qwen2.5-3b, nemotron-4-15b, codeqwen1.5-7b and
phi3-mini-3.8b (dense), mixtral-8x7b and arctic-480b (moe),
internvl2-76b (vlm), mamba2-1.3b (ssm), whisper-tiny (audio: the
encoder-decoder) and zamba2-7b (hybrid): every config of the reference's
registry (``ARCH_IDS``); and the port's own (``PORT_ARCH_IDS``), which
the reference has no model of: granite-4.0-h-small (hybrid_moe: Mamba2
and attention layers, each followed by experts and a shared expert).
Two ids name a one-card depth cut
(``one_chip_config``): ``mixtral-8x7b-16l`` and ``internvl2-76b-40l``.
arctic-480b's published config (960 GB of bf16 weights) serves counts
and plans only: the serving engine refuses it on the card before
anything is allocated. The shape configs and their helpers are
re-exported from :mod:`repro_torch.configs.base`, as the reference's
registry re-exports them.
"""

from __future__ import annotations

import importlib
from typing import Dict, List

from repro_torch.configs.base import (
    DECODE_32K,
    LONG_500K,
    PREFILL_32K,
    SHAPES,
    TRAIN_4K,
    ModelConfig,
    ShapeConfig,
    cache_specs,
    decoder_seq_len,
    effective_decode_window,
    input_specs,
    shape_applicable,
    torch_dtype,
)

# in the reference's ARCH_IDS order
ARCH_IDS: List[str] = ["qwen2_5_3b", "mixtral_8x7b", "nemotron_4_15b", "internvl2_76b",
                       "mamba2_1_3b", "arctic_480b", "codeqwen1_5_7b", "whisper_tiny",
                       "zamba2_7b", "phi3_mini_3_8b"]

# configs of the port alone: no counterpart in the reference's registry
PORT_ARCH_IDS: List[str] = ["granite_4_0_h_small"]

# CLI ids with dashes/dots map onto module names.
_ALIASES = {"qwen2.5-3b": "qwen2_5_3b", "mixtral-8x7b": "mixtral_8x7b",
            "mixtral-8x7b-16l": "mixtral_8x7b", "mamba2-1.3b": "mamba2_1_3b",
            "arctic-480b": "arctic_480b", "zamba2-7b": "zamba2_7b",
            "nemotron-4-15b": "nemotron_4_15b", "internvl2-76b": "internvl2_76b",
            "internvl2-76b-40l": "internvl2_76b", "codeqwen1.5-7b": "codeqwen1_5_7b",
            "phi3-mini-3.8b": "phi3_mini_3_8b", "whisper-tiny": "whisper_tiny",
            "granite-4.0-h-small": "granite_4_0_h_small"}

# ids that name a config other than the module's published ``config()``
_VARIANTS = {"mixtral-8x7b-16l": "one_chip_config",
             "internvl2-76b-40l": "one_chip_config"}


def canonical_id(arch: str) -> str:
    return _ALIASES.get(arch, arch)


def _module(arch: str):
    arch_id = canonical_id(arch)
    if arch_id not in ARCH_IDS + PORT_ARCH_IDS:
        raise ValueError(f"architecture {arch!r} is not ported "
                         f"(have {ARCH_IDS + PORT_ARCH_IDS})")
    return importlib.import_module(f"repro_torch.configs.{arch_id}")


def get_config(arch: str) -> ModelConfig:
    cfg: ModelConfig = getattr(_module(arch), _VARIANTS.get(arch, "config"))()
    cfg.validate()
    return cfg


def one_chip_ids(arch: str) -> List[str]:
    """The ids of ``arch``'s depth cuts that fit one card."""
    return [a for a in _VARIANTS if canonical_id(a) == canonical_id(arch)]


def get_reduced_config(arch: str) -> ModelConfig:
    cfg: ModelConfig = _module(arch).reduced_config()
    cfg.validate()
    if cfg.num_layers > 2 or cfg.d_model > 512 or cfg.num_experts > 4:
        raise ValueError(f"{cfg.name} is not a reduced config")
    return cfg


def all_configs() -> Dict[str, ModelConfig]:
    """Every published config of the reference's registry, keyed by module
    id in ``ARCH_IDS`` order."""
    return {a: get_config(a) for a in ARCH_IDS}


__all__ = [
    "ARCH_IDS",
    "PORT_ARCH_IDS",
    "ModelConfig",
    "ShapeConfig",
    "SHAPES",
    "TRAIN_4K",
    "PREFILL_32K",
    "DECODE_32K",
    "LONG_500K",
    "get_config",
    "get_reduced_config",
    "all_configs",
    "canonical_id",
    "input_specs",
    "cache_specs",
    "shape_applicable",
    "effective_decode_window",
    "decoder_seq_len",
    "one_chip_ids",
    "torch_dtype",
]
