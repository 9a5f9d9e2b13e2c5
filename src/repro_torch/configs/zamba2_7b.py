"""Zamba2-7B — hybrid: a Mamba2 backbone and one shared attention block.

81L d_model=3584 32H (kv=32) head_dim=112 d_ff=14336 vocab=32000,
ssm_state=64, the widths of ``repro/configs/zamba2_7b.py``.
[arXiv:2411.15242]

The backbone is Mamba2 blocks; a single SHARED attention + MLP block (one
parameter set) is applied before every ``attn_every``-th of them. As in
the reference's code, the shared block takes the residual stream ``h``
alone (the reference's docstring speaks of a concatenated stream; its
code does not concatenate).
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b",
        family="hybrid",
        source="arXiv:2411.15242 (Zamba2)",
        num_layers=81,
        d_model=3584,
        num_heads=32,
        num_kv_heads=32,
        head_dim=112,
        d_ff=14336,
        vocab_size=32000,
        mlp_type="swiglu",
        ssm_state=64,
        ssm_expand=2,
        ssm_head_dim=64,   # 112 heads at d_inner=7168
        ssm_chunk=256,
        conv_width=4,
        attn_every=6,      # the shared block fires at layers 0, 6, ..., 78: 14 times
        rope_theta=10_000.0,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="zamba2-7b-reduced",
        family="hybrid",
        source="reduced smoke variant",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=4,
        head_dim=64,
        d_ff=512,
        vocab_size=1024,
        mlp_type="swiglu",
        ssm_state=32,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=64,
        conv_width=4,
        attn_every=2,
        rope_theta=10_000.0,
    )
