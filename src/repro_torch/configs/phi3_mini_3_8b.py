"""Phi-3-mini-3.8B — dense decoder, RoPE + SwiGLU + GQA(kv=32 ~ MHA).

32L d_model=3072 32H (GQA kv=32) d_ff=8192 vocab=32064, the widths of
``repro/configs/phi3_mini_3_8b.py``. [arXiv:2404.14219]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b",
        family="dense",
        source="arXiv:2404.14219 (Phi-3)",
        num_layers=32,
        d_model=3072,
        num_heads=32,
        num_kv_heads=32,
        head_dim=96,
        d_ff=8192,
        vocab_size=32064,
        mlp_type="swiglu",
        rope_theta=10_000.0,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="phi3-mini-3.8b-reduced",
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
        rope_theta=10_000.0,
    )
