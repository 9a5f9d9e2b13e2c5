"""Step functions that the dry run plans and runs (port of
``repro/launch/steps.py``).

* ``train_step``   -- loss, gradients, AdamW update (params and moments
  updated in place; ``training.train_loop.train_step`` with ``remat=True``,
  as the reference passes).
* ``prefill_step`` -- full-sequence forward building the decode cache.
* ``serve_step``   -- ONE new token against the cache (what the
  decode_32k / long_500k shapes run).

The prefill and serve steps launch the hand-written kernels on CUDA
tensors (``use_kernels``, on by default); training runs the plain path,
as the reference's does. The reference's ``make_constrain`` (sharding
constraints on activations) has nothing to constrain in a one-device
eager program and is not ported. :func:`eval_param_shapes` and
:func:`eval_opt_shapes` give the reference's trees as ``device="meta"``
tensors: paths, shapes and dtypes, nothing allocated.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, effective_decode_window
from repro_torch.models.model import forward_decode, forward_prefill, init_params
from repro_torch.training.optimizer import AdamWConfig, init_opt_state
from repro_torch.training.train_loop import train_step as _train_step

# bf16 moments for the >= 76B-param archs
BF16_MOMENT_ARCHS = {"internvl2-76b", "arctic-480b"}


def adamw_config_for(cfg: ModelConfig) -> AdamWConfig:
    mdt = "bfloat16" if cfg.name in BF16_MOMENT_ARCHS else "float32"
    return AdamWConfig(moment_dtype=mdt)


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None) -> Callable:
    opt_cfg = opt_cfg or adamw_config_for(cfg)

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        return _train_step(params, opt_state, batch, cfg=cfg, opt_cfg=opt_cfg, remat=True)

    return train_step


def make_prefill_step(cfg: ModelConfig, shape: ShapeConfig,
                      use_kernels: bool = True) -> Callable:
    """The cache keeps the shape's effective window; long_500k runs the
    long-context variant."""
    W = effective_decode_window(cfg, shape)
    long_ctx = shape.name == "long_500k"

    def prefill_step(params, batch: Dict[str, torch.Tensor]):
        return forward_prefill(params, cfg, batch["tokens"],
                               patch_embeds=batch.get("patch_embeds"),
                               frame_embeds=batch.get("frame_embeds"),
                               cache_window=W or None, long_context=long_ctx,
                               use_kernels=use_kernels)

    return prefill_step


def make_serve_step(cfg: ModelConfig, use_kernels: bool = True) -> Callable:
    def serve_step(params, cache, token):
        return forward_decode(params, cfg, token, cache, use_kernels=use_kernels)

    return serve_step


def eval_param_shapes(cfg: ModelConfig):
    """Parameter meta tensors, without allocating (for the dry run)."""
    return init_params(torch.Generator().manual_seed(0), cfg, device="meta")


def eval_opt_shapes(cfg: ModelConfig, param_shapes, opt_cfg: Optional[AdamWConfig] = None):
    return init_opt_state(opt_cfg or adamw_config_for(cfg), param_shapes)
