"""Mixtral-8x7B -- sparse MoE decoder, 8 experts top-2, sliding-window attn.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000, the widths of
``repro/configs/mixtral_8x7b.py``. [arXiv:2401.04088]
"""

import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b",
        family="moe",
        source="arXiv:2401.04088 (Mixtral of Experts)",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab_size=32000,
        mlp_type="swiglu",
        num_experts=8,
        experts_per_token=2,
        sliding_window=4096,
        rope_theta=1_000_000.0,
    )


def one_chip_config() -> ModelConfig:
    """The published widths at 16 of the 32 layers, for one 80 GB card.

    The whole model holds 46.70 B parameters, 93.4 GB in bfloat16, more
    than the card's 80 GB. Its layer pattern repeats every layer
    (attention + 8-expert MoE), so the cut is depth: 16 layers hold
    23.48 B parameters, 46.96 GB. The other 16 layers would be a second
    pipeline stage on a second card. Every width is as published.
    """
    return dataclasses.replace(config(), name="mixtral-8x7b-16l", num_layers=16)


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="mixtral-8x7b-reduced",
        family="moe",
        source="reduced smoke variant",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=1024,
        mlp_type="swiglu",
        num_experts=4,
        experts_per_token=2,
        sliding_window=128,
        rope_theta=1_000_000.0,
    )
