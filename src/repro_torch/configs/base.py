"""Configuration of the port (mirrors ``repro/configs/base.py``).

Two families of config live here:

* :class:`ModelConfig` keeps the reference's fields and helpers, so a
  config built for one package reads the same in the other.
  ``torch_dtype`` maps the config's dtype string onto a ``torch.dtype``.
  Some fields are the port's own (:data:`PORT_ONLY_FIELDS`):
  ``moe_capacity_factor``, the reference's fixed 1.25 by default, or
  None for dropless routing (``models/moe.py``); and those of the
  ``hybrid_moe`` family (Granite 4.0-H), which the reference has no
  model of: ``layer_types`` (each layer's mixer, ``"mamba"`` or
  ``"attention"``), ``shared_d_ff`` (the shared expert's width beside the
  routed ones), the four multipliers of the embedding, the residual
  branches, the attention scores and the logits, ``use_rope`` (False:
  attention without positions) and ``tie_embeddings``. :func:`shared_fields` is a config's fields without
  them, for comparing with the reference.
* :class:`ShapeConfig` is one of the reference's four assigned input
  shapes (train_4k / prefill_32k / decode_32k / long_500k).

``input_specs(model_cfg, shape_cfg)`` gives a ``device="meta"`` tensor
(shape and dtype, nothing allocated) for every input of the step the
shape runs, under the reference's keys; ``cache_specs`` the same for the
decode cache.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch

TORCH_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
}


def torch_dtype(name: str) -> torch.dtype:
    try:
        return TORCH_DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}") from None


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per assigned architecture."""

    name: str
    family: str  # dense | moe | ssm | hybrid | hybrid_moe | vlm | audio
    source: str  # citation for the config (paper / model card)

    num_layers: int = 0
    d_model: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    d_ff: int = 0
    vocab_size: int = 0

    # --- MLP / activation ---------------------------------------------------
    mlp_type: str = "swiglu"  # swiglu | squared_relu
    # --- attention ----------------------------------------------------------
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: Optional[int] = None  # native SWA (mixtral)
    long_context_window: int = 8192
    supports_long_context: bool = True
    # --- MoE ----------------------------------------------------------------
    num_experts: int = 0
    experts_per_token: int = 0
    dense_residual: bool = False
    router_aux_weight: float = 0.01
    # expert capacity: 1.25 x tokens x k / experts slots an expert, past
    # which assignments are dropped (Switch / GShard); None keeps them all
    moe_capacity_factor: Optional[float] = 1.25
    # --- SSM (mamba2 / zamba2) ----------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    # --- hybrid (zamba2) ------------------------------------------------------
    attn_every: int = 0
    # --- hybrid_moe (granite 4.0-H) -------------------------------------------
    layer_types: Tuple[str, ...] = ()  # each layer's mixer: "mamba" | "attention"
    shared_d_ff: int = 0  # the shared SwiGLU expert beside the routed ones
    embedding_multiplier: float = 1.0
    residual_multiplier: float = 1.0  # x + r * branch
    attention_multiplier: Optional[float] = None  # softmax scale; None: head_dim ** -0.5
    logits_scaling: float = 1.0  # logits = head(x) / logits_scaling
    use_rope: bool = True
    tie_embeddings: bool = False
    # --- encoder-decoder (whisper) --------------------------------------------
    is_encoder_decoder: bool = False
    encoder_layers: int = 0
    encoder_seq: int = 0
    max_target_positions: int = 0
    # --- vlm frontend stub ----------------------------------------------------
    frontend_tokens: int = 0
    # --- numerics -------------------------------------------------------------
    dtype: str = "bfloat16"
    norm_eps: float = 1e-5

    def __post_init__(self):
        # a list from a JSON file becomes a tuple: the config stays hashable
        object.__setattr__(self, "layer_types", tuple(self.layer_types))

    # ----------------------------------------------------------------- helpers
    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def d_inner(self) -> int:
        """Mamba2 inner width."""
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim if self.ssm_head_dim else 0

    @property
    def uses_attention(self) -> bool:
        return self.family != "ssm"

    @property
    def uses_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid", "hybrid_moe")

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def param_count(self) -> int:
        """Analytic parameter count (exact for every family of the port)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)

    def active_param_count(self) -> int:
        """Parameters a token runs through (a moe layer counts
        ``experts_per_token`` of its experts)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self, active_only=True)

    def validate(self) -> None:
        if self.family in ("dense", "moe", "vlm", "audio", "hybrid", "hybrid_moe"):
            if not (self.num_heads > 0 and self.head_dim > 0):
                raise ValueError(f"{self.name}: attention needs heads")
            if self.num_heads % self.num_kv_heads:
                raise ValueError(f"{self.name}: num_heads % num_kv_heads != 0")
        if self.family in ("moe", "hybrid_moe") and not (
                self.num_experts > 1 and self.experts_per_token >= 1):
            raise ValueError(f"{self.name}: moe needs experts")
        if self.moe_capacity_factor is not None and not self.moe_capacity_factor > 0:
            raise ValueError(f"{self.name}: moe_capacity_factor must be positive or None")
        if self.family == "hybrid_moe" and not (
                len(self.layer_types) == self.num_layers and self.shared_d_ff > 0
                and set(self.layer_types) <= {"mamba", "attention"}):
            raise ValueError(f"{self.name}: hybrid_moe needs a mixer kind a layer "
                             "and a shared expert")
        if self.family in ("ssm", "hybrid", "hybrid_moe") and not (
                self.ssm_state > 0 and self.d_inner % self.ssm_head_dim == 0):
            raise ValueError(f"{self.name}: bad ssm shape")
        if self.family == "audio" and not self.is_encoder_decoder:
            raise ValueError(f"{self.name}: audio is encoder-decoder")


PORT_ONLY_FIELDS = ("moe_capacity_factor", "layer_types", "shared_d_ff",
                    "embedding_multiplier", "residual_multiplier", "attention_multiplier",
                    "logits_scaling", "use_rope", "tie_embeddings")


def shared_fields(cfg: ModelConfig) -> Dict[str, Any]:
    """The config's fields that the reference's ModelConfig has too."""
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k not in PORT_ONLY_FIELDS}


# ---------------------------------------------------------------------------
# Input shapes
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One of the four assigned (seq_len, global_batch) input shapes."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


TRAIN_4K = ShapeConfig("train_4k", 4_096, 256, "train")
PREFILL_32K = ShapeConfig("prefill_32k", 32_768, 32, "prefill")
DECODE_32K = ShapeConfig("decode_32k", 32_768, 128, "decode")
LONG_500K = ShapeConfig("long_500k", 524_288, 1, "decode")

SHAPES: Dict[str, ShapeConfig] = {
    s.name: s for s in (TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K)
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """Whether (arch, shape) is runnable: long_500k needs sub-quadratic
    attention (SSM and hybrid natively, SWA archs natively, dense archs
    through the long-context window); whisper opts out (448-position cap)."""
    if shape.name == "long_500k":
        return cfg.supports_long_context
    return True


def effective_decode_window(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """KV entries cached at decode time for (arch, shape): the whole
    context for decode_32k's full-attention archs, the native sliding
    window or (long_500k) the long-context window otherwise, whisper's
    positional cap; 0 for a model without attention."""
    if not cfg.uses_attention:
        return 0
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, shape.seq_len)
    if shape.name == "long_500k":
        return min(cfg.long_context_window, shape.seq_len)
    if cfg.is_encoder_decoder and cfg.max_target_positions:
        return min(cfg.max_target_positions, shape.seq_len)
    return shape.seq_len


def decoder_seq_len(cfg: ModelConfig, shape: ShapeConfig) -> int:
    """Sequence length seen by the decoder (whisper caps it at 448)."""
    if cfg.is_encoder_decoder and cfg.max_target_positions:
        return min(cfg.max_target_positions, shape.seq_len)
    return shape.seq_len


# ---------------------------------------------------------------------------
# Meta-tensor input specs for the dry run
# ---------------------------------------------------------------------------


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype, device="meta")


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """``device="meta"`` stand-ins for every model input of the step the
    shape runs, keyed as the step functions of ``repro_torch.launch.steps``
    take them. Nothing is allocated."""
    B = shape.global_batch
    S = decoder_seq_len(cfg, shape)
    dt = cfg.torch_dtype
    i32 = torch.int32
    specs: Dict[str, Any] = {}
    if shape.kind in ("train", "prefill"):
        text = S - cfg.frontend_tokens if cfg.family == "vlm" else S
        specs["tokens"] = _meta((B, text), i32)
        if shape.kind == "train":
            specs["labels"] = _meta((B, text), i32)
        if cfg.family == "vlm":
            specs["patch_embeds"] = _meta((B, cfg.frontend_tokens, cfg.d_model), dt)
        if cfg.is_encoder_decoder:
            specs["frame_embeds"] = _meta((B, cfg.encoder_seq, cfg.d_model), dt)
    elif shape.kind == "decode":
        specs["token"] = _meta((B,), i32)
        specs["cache"] = cache_specs(cfg, shape)
    else:
        raise ValueError(f"unknown shape kind {shape.kind!r}")
    return specs


def cache_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, torch.Tensor]:
    """Meta tensors of the decode cache (KV and / or SSM state), under the
    reference's keys (``models.kv_cache.cache_shapes``)."""
    from repro_torch.models.kv_cache import cache_shapes

    return {name: _meta(shp, dtype) for name, (shp, dtype) in cache_shapes(cfg, shape).items()}
