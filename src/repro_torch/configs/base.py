"""Model configuration for the port (mirrors ``repro/configs/base.py``).

:class:`ModelConfig` keeps the reference's fields and helpers so a config
built for one package reads the same in the other. ``torch_dtype`` maps
the config's dtype string onto a ``torch.dtype``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
    family: str  # dense | moe | ssm | hybrid | vlm | audio
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
    # --- SSM (mamba2 / zamba2) ----------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_chunk: int = 256
    conv_width: int = 4
    # --- hybrid (zamba2) ------------------------------------------------------
    attn_every: int = 0
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
        return self.family in ("ssm", "hybrid")

    @property
    def torch_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    def param_count(self) -> int:
        """Analytic parameter count (exact for the port's dense model)."""
        from repro_torch.models.model import count_params_analytic

        return count_params_analytic(self)

    def validate(self) -> None:
        if self.family in ("dense", "moe", "vlm", "audio", "hybrid"):
            if not (self.num_heads > 0 and self.head_dim > 0):
                raise ValueError(f"{self.name}: attention needs heads")
            if self.num_heads % self.num_kv_heads:
                raise ValueError(f"{self.name}: num_heads % num_kv_heads != 0")
        if self.family == "moe" and not (
                self.num_experts > 1 and self.experts_per_token >= 1):
            raise ValueError(f"{self.name}: moe needs experts")
        if self.family in ("ssm", "hybrid") and not (
                self.ssm_state > 0 and self.d_inner % self.ssm_head_dim == 0):
            raise ValueError(f"{self.name}: bad ssm shape")
        if self.family == "audio" and not self.is_encoder_decoder:
            raise ValueError(f"{self.name}: audio is encoder-decoder")
