"""Shared building blocks: norms (plain and gated), RoPE, GQA attention, MLPs
(SwiGLU and squared ReLU).

Port of ``repro/models/layers.py``: plain functions over parameter dicts
of tensors, with the same keys and the same ``(in, out)`` weight layout
(``x @ w``). The float32 upcasts sit where the reference has them, and a
contraction the reference asks for with ``preferred_element_type=f32``
runs on float32 operands here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


# float32 values drawn per call of torch.randn while a weight is made: its
# temporary stays at 256 MB however large the weight (internvl2-76b-40l's
# stacked MLP matrices would be a 37.6 GB float32 temporary, its lm_head 4.2 GB)
_DRAW = 1 << 26


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """Normal values times ``scale`` of ``shape`` in ``dtype``, drawn in
    float32 on the generator's device, a block of rows at a time."""
    w = torch.empty(tuple(shape), dtype=dtype, device=gen.device)
    rows = w.view(-1, shape[-1])
    step = max(1, _DRAW // shape[-1])
    for r in range(0, rows.shape[0], step):
        block = torch.randn((min(step, rows.shape[0] - r), shape[-1]), generator=gen,
                            dtype=torch.float32, device=gen.device)
        rows[r:r + step] = block.mul_(scale)
    return w


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               *, lead=()) -> torch.Tensor:
    """Normal weights of shape ``lead + (in_dim, out_dim)`` scaled by
    ``in_dim ** -0.5``."""
    return _normal(gen, tuple(lead) + (in_dim, out_dim), in_dim ** -0.5, dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype) -> torch.Tensor:
    return _normal(gen, (vocab, dim), 0.02, dtype)


# ---------------------------------------------------------------------------
# Norms and RoPE
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dtype = x.dtype
    x = x.float()
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def gated_rms_norm(x: torch.Tensor, z: torch.Tensor, weight: torch.Tensor,
                   eps: float = 1e-5) -> torch.Tensor:
    """Mamba2's RMSNorm(x * silu(z)) fused gate-norm: float32 inside, one
    cast back to x's dtype."""
    dtype = x.dtype
    x = x.float() * F.silu(z.float())
    var = torch.mean(x * x, dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * weight.float()).to(dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: (..., S) int32."""
    half = x.shape[-1] // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    # a Python-scalar base: a tensor made from theta on the card would be a
    # host-to-device copy, and a stall, at every call
    freq = torch.pow(theta, exponent)
    angles = positions[..., None].float() * freq  # (..., S, half)
    cos = torch.cos(angles)[..., None, :]  # (..., S, 1, half)
    sin = torch.sin(angles)[..., None, :]
    x1f, x2f = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA) -- plain paths
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, *, lead=()) -> Params:
    dt = cfg.torch_dtype
    p: Params = {
        "wq": dense_init(gen, cfg.d_model, cfg.q_dim, dt, lead=lead),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, dt, lead=lead),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, dt, lead=lead),
        "wo": dense_init(gen, cfg.q_dim, cfg.d_model, dt, lead=lead),
    }
    if cfg.qkv_bias:
        for name, dim in (("bq", cfg.q_dim), ("bk", cfg.kv_dim), ("bv", cfg.kv_dim)):
            p[name] = torch.zeros(tuple(lead) + (dim,), dtype=dt, device=gen.device)
    return p


def _project(p: Params, cfg: ModelConfig, x: torch.Tensor, name: str, heads: int):
    y = x @ p[f"w{name}"]
    if cfg.qkv_bias:
        y = y + p[f"b{name}"]
    return y.reshape(x.shape[0], x.shape[1], heads, cfg.head_dim)


def attn_q(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    """Project x:(B,S,D) -> q:(B,S,H,hd) (a cross-attention's query side)."""
    return _project(p, cfg, x, "q", cfg.num_heads)


def attn_kv(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """Project x:(B,S,D) -> k/v:(B,S,Hkv,hd) (a cross-attention's memory side)."""
    return (_project(p, cfg, x, "k", cfg.num_kv_heads),
            _project(p, cfg, x, "v", cfg.num_kv_heads))


def attn_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """Project x:(B,S,D) -> q:(B,S,H,hd), k/v:(B,S,Hkv,hd)."""
    return (attn_q(p, cfg, x),) + attn_kv(p, cfg, x)


def attn_out(p: Params, cfg: ModelConfig, o: torch.Tensor) -> torch.Tensor:
    B, S = o.shape[:2]
    return o.reshape(B, S, cfg.q_dim) @ p["wo"]


def _expand_kv(k: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Broadcast kv heads to q heads: (B,S,Hkv,D) -> (B,S,H,D); q head h
    reads kv head h // (H // Hkv)."""
    rep = num_heads // k.shape[2]
    if rep == 1:
        return k
    return torch.repeat_interleave(k, rep, dim=2)


def sdpa(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_positions: Optional[torch.Tensor] = None,
    kv_positions: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    kv_valid: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain scaled-dot-product attention with GQA broadcast (the
    reference's ``"repeat"`` mode).

    q: (B,Sq,H,D); k,v: (B,Skv,Hkv,D). Masking uses absolute positions so
    the same code covers prefill and ring-buffer decode. A row with no
    live key returns 0.
    """
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if q_positions is None:
        q_positions = torch.arange(Sq, dtype=torch.int32, device=q.device)[None, :]
    if kv_positions is None:
        kv_positions = torch.arange(Skv, dtype=torch.int32, device=q.device)[None, :]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D ** -0.5
    qp = q_positions[:, None, :, None]  # (B,1,Sq,1)
    kp = kv_positions[:, None, None, :]  # (B,1,1,Skv)
    mask = torch.ones((B, 1, Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    if kv_valid is not None:
        mask = mask & kv_valid[:, None, None, :]
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    # rows that are fully masked give NaN from softmax(-inf); zero them
    probs = torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


# The reference's two MLPs: SwiGLU (wg, wu, wd) and squared ReLU (wu, wd;
# nemotron). Any other mlp_type raises, as the reference's does.
_MLP_KEYS = {"swiglu": ("wg", "wu", "wd"), "squared_relu": ("wu", "wd")}


def _mlp_keys(cfg: ModelConfig):
    try:
        return _MLP_KEYS[cfg.mlp_type]
    except KeyError:
        raise ValueError(f"{cfg.name}: unknown mlp_type {cfg.mlp_type!r}") from None


def init_mlp(gen: torch.Generator, cfg: ModelConfig, *, lead=()) -> Params:
    dims = {"wg": (cfg.d_model, cfg.d_ff), "wu": (cfg.d_model, cfg.d_ff),
            "wd": (cfg.d_ff, cfg.d_model)}
    return {k: dense_init(gen, *dims[k], cfg.torch_dtype, lead=lead) for k in _mlp_keys(cfg)}


def mlp(p: Params, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    if cfg.mlp_type == "swiglu":
        return (F.silu(x @ p["wg"]) * (x @ p["wu"])) @ p["wd"]
    if cfg.mlp_type == "squared_relu":
        h = torch.relu(x @ p["wu"])
        return (h * h) @ p["wd"]  # squared in the model's dtype, as the reference does
    raise ValueError(f"{cfg.name}: unknown mlp_type {cfg.mlp_type!r}")


def mlp_param_count(cfg: ModelConfig) -> int:
    return len(_mlp_keys(cfg)) * cfg.d_model * cfg.d_ff


def attn_param_count(cfg: ModelConfig) -> int:
    n = 2 * cfg.d_model * cfg.q_dim + 2 * cfg.d_model * cfg.kv_dim
    if cfg.qkv_bias:
        n += cfg.q_dim + 2 * cfg.kv_dim
    return n
