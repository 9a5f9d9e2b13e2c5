"""InternVL2-76B — VLM: InternViT frontend (stub) + Llama3-70B-class backbone.

80L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256, the widths of
``repro/configs/internvl2_76b.py``. [arXiv:2404.16821]

The vision encoder and projector are a stub, as in the reference: the
caller hands precomputed patch embeddings (frontend_tokens x d_model),
which the language model prepends to the token embeddings.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b",
        family="vlm",
        source="arXiv:2404.16821 (InternVL2; InternViT + LLM backbone)",
        num_layers=80,
        d_model=8192,
        num_heads=64,
        num_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab_size=128256,
        mlp_type="swiglu",
        rope_theta=500_000.0,
        frontend_tokens=256,  # one image tile -> 256 visual tokens
    )


def one_chip_config() -> ModelConfig:
    """The published widths at 40 of the 80 layers, for one 80 GB card.

    The whole language model holds 70.55 B parameters, 141.1 GB in
    bfloat16, more than the card's 80 GB. Every layer is the same
    attention + SwiGLU block (0.8557 B parameters), so the cut is depth:
    40 layers hold 34.23 B, and with the embedding and lm_head (2.10 B)
    the model holds 36.33 B parameters, 72.66 GB. The other 40 layers
    would be a second pipeline stage on a second card. Every width, and
    the 256-token patch prefix, is as published.
    """
    return dataclasses.replace(config(), name="internvl2-76b-40l", num_layers=40)


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="internvl2-76b-reduced",
        family="vlm",
        source="reduced smoke variant",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=1024,
        mlp_type="swiglu",
        rope_theta=500_000.0,
        frontend_tokens=16,
    )
