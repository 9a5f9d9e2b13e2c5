"""Whisper-tiny — encoder-decoder audio transformer, conv frontend stubbed.

4 encoder + 4 decoder layers, d_model=384, 6H (kv=6) x 64, d_ff=1536
SwiGLU, vocab=51865, the widths of ``repro/configs/whisper_tiny.py``
[arXiv:2212.04356].

The mel-spectrogram + conv feature extractor is a stub, as in the
reference: the caller gives precomputed frame embeddings (1500 x d_model).
The decoder's learned positions cap the target length at 448 tokens.
"""

from repro_torch.configs.base import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny",
        family="audio",
        source="arXiv:2212.04356 (Whisper)",
        num_layers=4,          # decoder layers
        d_model=384,
        num_heads=6,
        num_kv_heads=6,
        head_dim=64,
        d_ff=1536,
        vocab_size=51865,
        mlp_type="swiglu",
        is_encoder_decoder=True,
        encoder_layers=4,
        encoder_seq=1500,      # 30 s audio -> 1500 frames post-conv
        max_target_positions=448,
        supports_long_context=False,
        rope_theta=10_000.0,
    )


def reduced_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-tiny-reduced",
        family="audio",
        source="reduced smoke variant",
        num_layers=2,
        d_model=128,
        num_heads=2,
        num_kv_heads=2,
        head_dim=64,
        d_ff=256,
        vocab_size=1024,
        mlp_type="swiglu",
        is_encoder_decoder=True,
        encoder_layers=2,
        encoder_seq=64,
        max_target_positions=448,
        supports_long_context=False,
        rope_theta=10_000.0,
    )
