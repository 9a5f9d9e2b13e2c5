"""Snowflake Arctic-480B -- 128-expert top-2 MoE with a dense residual path.

Only the reduced variant is ported: it runs the ``dense_residual``
branch on the CPU. The published config (35 layers x 128 experts,
d_model 7168, ``repro/configs/arctic_480b.py``) needs its experts shared
across several cards, which is queued in ROADMAP.md.
[hf:Snowflake/snowflake-arctic-base]
"""

from repro_torch.configs.base import ModelConfig


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
