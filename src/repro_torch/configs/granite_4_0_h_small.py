"""IBM Granite-4.0-H-Small (32B-A9B) -- a hybrid of Mamba2 and attention
layers, every one followed by sparse experts and a shared expert.

40L d_model=4096 vocab=100352, the head tied to the embedding;
``layer_types``: attention at layers 5, 15, 25 and 35, Mamba2 in the other
36. Mamba2: 128 heads x 64 (d_inner 8192), d_state 128, n_groups 1, conv
4 with bias, chunk 256. Attention: GQA 32 / 8 heads of 128, no positional
embedding ("nope"), softmax scale ``attention_multiplier`` 1/128. Every
layer's FFN: 72 SwiGLU experts of width 768, top-10, softmax gates over
the top 10, plus one shared SwiGLU expert of width 1536.
[hf:ibm-granite/granite-4.0-h-small, config.json, model_type granitemoehybrid]

The layer equations (transformers' ``granitemoehybrid``), with r the
``residual_multiplier`` 0.22:

    x = embed[tokens] * 12
    layer i:  h = rms_norm(x)                        (eps 1e-5)
              h = mamba2(h) if layer_types[i] == "mamba" else attn(h)
              x = x + r * h
              g = rms_norm(x)
              x = x + r * (moe(g) + shared(g))
    logits = rms_norm(x) @ embed^T / 16

    mamba2:  in_proj -> z (8192), xBC (8448), dt (128); causal depthwise
             conv 4 with bias, SiLU over x, B and C; dt = softplus(dt +
             dt_bias), A = -exp(A_log); the SSD, + D x; gated RMSNorm of
             y * silu(z) over all 8192 channels; out_proj
    attn:    q, k, v without bias or rotation; softmax(q k^T / 128) v; o_proj
    moe:     float32 router logits, softmax, top-10, gates renormalised
             over the 10 (``models.moe.route``); dropless SwiGLU experts
    shared:  SwiGLU of width 1536 on the same g

32.21 B parameters, 64.4 GB in bfloat16: one H100 80GB holds the whole
model. Its Mamba2 width, ``mamba_n_heads`` x ``mamba_d_head`` = 128 x 64 =
8192, is ``mamba_expand`` x d_model, the port's ``d_inner``.
"""

import dataclasses

from repro_torch.configs.base import ModelConfig

ATTENTION_LAYERS = (5, 15, 25, 35)


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-4.0-h-small",
        family="hybrid_moe",
        source="hf:ibm-granite/granite-4.0-h-small (config.json)",
        num_layers=40,
        d_model=4096,
        num_heads=32,
        num_kv_heads=8,
        head_dim=128,  # hidden_size / num_attention_heads (config.json gives no key)
        d_ff=768,  # intermediate_size: one routed expert's width
        vocab_size=100352,
        mlp_type="swiglu",
        num_experts=72,
        experts_per_token=10,
        moe_capacity_factor=None,  # dropless, as the published block routes
        ssm_state=128,
        ssm_expand=2,
        ssm_head_dim=64,
        ssm_chunk=256,
        conv_width=4,
        layer_types=tuple("attention" if i in ATTENTION_LAYERS else "mamba"
                          for i in range(40)),
        shared_d_ff=1536,
        embedding_multiplier=12.0,
        residual_multiplier=0.22,
        attention_multiplier=0.0078125,
        logits_scaling=16.0,
        use_rope=False,
        tie_embeddings=True,
        rope_theta=10_000.0,  # published, unused: no layer rotates
        norm_eps=1e-5,
    )


def reduced_config() -> ModelConfig:
    """Two layers, one of each mixer kind (Mamba2, then attention), 4
    experts top-2 and a shared expert: every mechanism at a CPU size."""
    return dataclasses.replace(
        config(),
        name="granite-4.0-h-small-reduced",
        source="reduced smoke variant",
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=128,
        vocab_size=1024,
        num_experts=4,
        experts_per_token=2,
        ssm_state=32,
        ssm_head_dim=32,
        ssm_expand=1,  # d_inner 256: 8 heads of 32
        ssm_chunk=32,
        layer_types=("mamba", "attention"),
        shared_d_ff=256,
        attention_multiplier=1.0 / 64,
    )
