"""CodeQwen1.5-7B — dense MHA-style decoder (kv=32), qwen1.5 architecture.

32L d_model=4096 32H (GQA kv=32) d_ff=13440 vocab=92416, the widths of
``repro/configs/codeqwen1_5_7b.py``.
[hf:Qwen/CodeQwen1.5-7B]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b",
        family="dense",
        source="hf:Qwen/CodeQwen1.5-7B",
        num_layers=32,
        d_model=4096,
        num_heads=32,
        num_kv_heads=32,
        head_dim=128,
        d_ff=13440,
        vocab_size=92416,
        mlp_type="swiglu",
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="codeqwen1.5-7b-reduced",
        family="dense",
        source="reduced smoke variant",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=1024,
        mlp_type="swiglu",
        qkv_bias=True,
        rope_theta=1_000_000.0,
    )
