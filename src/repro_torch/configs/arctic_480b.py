"""Snowflake Arctic-480B -- 128-expert top-2 MoE with a dense residual path.

35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2.
The published config is for counts, sharding plans and the dry run: its
960 GB of bf16 weights need its experts shared across several cards, and
the serving engine refuses it on one card before allocating anything.
The reduced variant runs the ``dense_residual`` branch on the CPU.
[hf:Snowflake/snowflake-arctic-base]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b",
        family="moe",
        source="hf:Snowflake/snowflake-arctic-base",
        num_layers=35,
        d_model=7168,
        num_heads=56,
        num_kv_heads=8,
        head_dim=128,
        d_ff=4864,
        vocab_size=32000,
        mlp_type="swiglu",
        num_experts=128,
        experts_per_token=2,
        dense_residual=True,  # dense FFN residual in parallel with MoE
        rope_theta=10_000.0,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="arctic-480b-reduced",
        family="moe",
        source="reduced smoke variant",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=256,
        vocab_size=1024,
        mlp_type="swiglu",
        num_experts=4,
        experts_per_token=2,
        dense_residual=True,  # dense FFN residual in parallel with MoE
        rope_theta=10_000.0,
    )
