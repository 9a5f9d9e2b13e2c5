"""Qwen2.5-3B — dense GQA decoder with QKV bias.

36L d_model=2048 16H (GQA kv=2) d_ff=11008 vocab=151936, the widths of
``repro/configs/qwen2_5_3b.py``.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b",
        family="dense",
        source="hf:Qwen/Qwen2.5-0.5B (family); Qwen2.5 tech report",
        num_layers=36,
        d_model=2048,
        num_heads=16,
        num_kv_heads=2,
        head_dim=128,
        d_ff=11008,
        vocab_size=151936,
        mlp_type="swiglu",
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b-reduced",
        family="dense",
        source="reduced smoke variant",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=1024,
        mlp_type="swiglu",
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )
