"""Mamba2-1.3B — attention-free SSM with SSD (state-space duality).

48L d_model=2048 (attn-free) vocab=50280, ssm_state=128, the widths of
``repro/configs/mamba2_1_3b.py``. [arXiv:2405.21060]
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b",
        family="ssm",
        source="arXiv:2405.21060 (Mamba-2 / SSD)",
        num_layers=48,
        d_model=2048,
        vocab_size=50280,
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,   # 64 heads at d_inner=4096
        ssm_chunk=256,
        conv_width=4,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-1.3b-reduced",
        family="ssm",
        source="reduced smoke variant",
        num_layers=2,
        d_model=256,
        vocab_size=1024,
        ssm_state=32,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=64,
        conv_width=4,
    )
