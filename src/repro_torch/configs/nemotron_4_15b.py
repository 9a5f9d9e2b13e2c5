"""Nemotron-4-15B — dense GQA decoder with squared-ReLU MLP.

32L d_model=6144 48H (GQA kv=8) d_ff=24576 vocab=256000, the widths of
``repro/configs/nemotron_4_15b.py``. [arXiv:2402.16819]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b",
        family="dense",
        source="arXiv:2402.16819 (Nemotron-4 15B)",
        num_layers=32,
        d_model=6144,
        num_heads=48,
        num_kv_heads=8,
        head_dim=128,
        d_ff=24576,
        vocab_size=256000,
        mlp_type="squared_relu",
        rope_theta=10_000.0,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="nemotron-4-15b-reduced",
        family="dense",
        source="reduced smoke variant",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=1024,
        vocab_size=1024,
        mlp_type="squared_relu",
        rope_theta=10_000.0,
    )
