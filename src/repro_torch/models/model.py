"""Model assembly for the dense family: init, full-sequence forward,
prefill and single-token decode (port of ``repro/models/model.py``).

Per-layer parameters are stacked on a leading layer axis, as in the
reference; its ``jax.lax.scan`` over layers is a Python loop here.
``use_kernels`` is the counterpart of ``use_pallas``: attention goes
through :mod:`repro_torch.kernels.ops`, which launches the hand-written
CUDA kernels for CUDA tensors. It defaults to on.

Two quirks of the reference are kept on purpose: positions start at 0
for every row of a batch, and left-pad tokens are not masked.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import layers as L
from repro_torch.models.kv_cache import (
    ring_positions,
    ring_valid,
    ring_write,
    write_prefill,
)

Params = Dict[str, Any]


def _check_dense(cfg: ModelConfig) -> None:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"{cfg.name}: only the dense family is ported (got {cfg.family})")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------


def init_params(gen: torch.Generator, cfg: ModelConfig) -> Params:
    """Random parameters on ``gen.device``, with the reference's keys,
    shapes and scales (the values differ: another generator)."""
    _check_dense(cfg)
    dt = cfg.torch_dtype
    lead = (cfg.num_layers,)

    def ones(*shape):
        return torch.ones(shape, dtype=dt, device=gen.device)

    return {
        "embed": L.embed_init(gen, cfg.vocab_size, cfg.d_model, dt),
        "blocks": {
            "norm1": ones(cfg.num_layers, cfg.d_model),
            "attn": L.init_attention(gen, cfg, lead=lead),
            "norm2": ones(cfg.num_layers, cfg.d_model),
            "mlp": L.init_mlp(gen, cfg, lead=lead),
        },
        "final_norm": ones(cfg.d_model),
        "lm_head": L.dense_init(gen, cfg.d_model, cfg.vocab_size, dt),
    }


def _layer(blocks: Params, i: int) -> Params:
    """Layer ``i``'s view of the stacked block parameters."""
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


# ---------------------------------------------------------------------------
# Full sequence (prefill)
# ---------------------------------------------------------------------------


def _attn_full(
    bp: Params,
    cfg: ModelConfig,
    x: torch.Tensor,
    positions: torch.Tensor,
    window: Optional[int],
    use_kernels: bool,
):
    """One attention + MLP block over a full sequence.

    Returns (x, (k_rope, v)) -- the RoPE'd K and V for cache writing.
    """
    h = L.rms_norm(x, bp["norm1"], cfg.norm_eps)
    q, k, v = L.attn_qkv(bp["attn"], cfg, h)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    if use_kernels:
        o = ops.flash_attention(q, k, v, causal=True, window=window)
    else:
        o = L.sdpa(q, k, v, causal=True, q_positions=positions,
                   kv_positions=positions, window=window)
    x = x + L.attn_out(bp["attn"], cfg, o)
    h2 = L.rms_norm(x, bp["norm2"], cfg.norm_eps)
    return x + L.mlp(bp["mlp"], cfg, h2), (k, v)


def _embed_inputs(params: Params, cfg: ModelConfig, tokens: torch.Tensor) -> torch.Tensor:
    return params["embed"][tokens]


def forward_seq(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    want_cache: bool = False,
    cache_window: Optional[int] = None,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full-sequence forward. Returns (logits, cache|None).

    With ``want_cache`` the per-layer RoPE'd K/V (last ``cache_window``
    entries, in ring layout) are collected for subsequent decode.
    """
    _check_dense(cfg)
    x = _embed_inputs(params, cfg, tokens)
    Bsz, S, _ = x.shape
    positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(Bsz, S)
    W = cache_window or S
    cache: Optional[Dict[str, torch.Tensor]] = None
    if want_cache:
        shape = (cfg.num_layers, Bsz, W, cfg.num_kv_heads, cfg.head_dim)
        cache = {"k": torch.zeros(shape, dtype=x.dtype, device=x.device),
                 "v": torch.zeros(shape, dtype=x.dtype, device=x.device)}
    for i in range(cfg.num_layers):
        x, (k, v) = _attn_full(_layer(params["blocks"], i), cfg, x, positions,
                               cfg.sliding_window, use_kernels)
        if cache is not None:
            write_prefill(cache["k"][i], k)
            write_prefill(cache["v"][i], v)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["lm_head"]
    if cache is not None:
        cache["pos"] = torch.full((Bsz,), S, dtype=torch.int32, device=x.device)
    return logits, cache


def forward_prefill(
    params: Params,
    cfg: ModelConfig,
    tokens: torch.Tensor,
    *,
    cache_window: Optional[int] = None,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Returns (last-position logits: (B, V), cache)."""
    logits, cache = forward_seq(params, cfg, tokens, want_cache=True,
                                cache_window=cache_window,
                                use_kernels=use_kernels)
    return logits[:, -1], cache


# ---------------------------------------------------------------------------
# Decode (one token against the cache)
# ---------------------------------------------------------------------------


def _attn_decode(
    bp: Params,
    cfg: ModelConfig,
    x_t: torch.Tensor,  # (B, D)
    k_buf: torch.Tensor,  # (B, W, Hkv, hd)
    v_buf: torch.Tensor,
    pos: torch.Tensor,  # (B,)
    use_kernels: bool,
):
    """Single-token attention against a ring-buffer cache, in the
    reference's default ``"concat"`` mode: the current token's K/V join
    the window as slot W before attending.

    Returns (out: (B,D), new_k: (B,Hkv,hd), new_v).
    """
    W = k_buf.shape[1]
    q, k, v = L.attn_qkv(bp["attn"], cfg, x_t[:, None])
    q = L.rope(q, pos[:, None], cfg.rope_theta)
    k = L.rope(k, pos[:, None], cfg.rope_theta)
    kv_pos = torch.cat([ring_positions(pos, W), pos[:, None]], dim=1)
    valid = torch.cat(
        [ring_valid(pos, W), torch.ones((pos.shape[0], 1), dtype=torch.bool,
                                        device=pos.device)], dim=1)
    k_all = torch.cat([k_buf, k], dim=1)
    v_all = torch.cat([v_buf, v], dim=1)
    if use_kernels:
        o = ops.decode_attention(q, k_all, v_all, kv_pos, valid, pos)
    else:
        o = L.sdpa(q, k_all, v_all, causal=True, q_positions=pos[:, None],
                   kv_positions=kv_pos, kv_valid=valid)
    out = L.attn_out(bp["attn"], cfg, o)[:, 0]
    return out, k[:, 0], v[:, 0]


def forward_decode(
    params: Params,
    cfg: ModelConfig,
    token: torch.Tensor,  # (B,) int32
    cache: Dict[str, torch.Tensor],
    *,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step. Returns (logits: (B, V), cache). The K/V buffers
    are updated in place; ``pos`` is replaced by ``pos + 1``."""
    _check_dense(cfg)
    pos = cache["pos"]
    x = params["embed"][token]  # (B, D)
    for i in range(cfg.num_layers):
        bp = _layer(params["blocks"], i)
        a = L.rms_norm(x, bp["norm1"], cfg.norm_eps)
        o, nk, nv = _attn_decode(bp, cfg, a, cache["k"][i], cache["v"][i], pos,
                                 use_kernels)
        # layer i's buffers are read only by layer i, so writing them right
        # after its attention equals the reference's write after the scan
        ring_write(cache["k"][i], nk, pos)
        ring_write(cache["v"][i], nv, pos)
        x = x + o
        h2 = L.rms_norm(x, bp["norm2"], cfg.norm_eps)
        x = x + L.mlp(bp["mlp"], cfg, h2)
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x @ params["lm_head"]
    cache["pos"] = pos + 1
    return logits, cache


# ---------------------------------------------------------------------------
# Parameter counting
# ---------------------------------------------------------------------------


def count_params(params) -> int:
    if isinstance(params, dict):
        return sum(count_params(v) for v in params.values())
    return params.numel()


def count_params_analytic(cfg: ModelConfig) -> int:
    _check_dense(cfg)
    D = cfg.d_model
    per = 2 * D + L.attn_param_count(cfg) + L.mlp_param_count(cfg)
    return cfg.vocab_size * D * 2 + D + cfg.num_layers * per
