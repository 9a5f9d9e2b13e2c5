"""Mamba2 (SSD — state-space duality) blocks (port of ``repro/models/ssm.py``).

Follows arXiv:2405.21060: the block projects the residual stream into
(z, x, B, C, dt), applies a short causal depthwise conv to (x, B, C),
then runs the SSD recurrence

    S_t = exp(dt_t * A_h) * S_{t-1} + dt_t * B_t x_t^T        (per head h)
    y_t = C_t . S_t + D_h * x_t

in the chunked dual form for prefill and as a one-step recurrence for
decode. ``mamba_block`` runs the prefill scan through
:func:`repro_torch.kernels.ops.ssd_scan`, which picks the hand-written
CUDA kernel (:mod:`repro_torch.kernels.ssd_scan`) or its plain version,
the chunked form :func:`repro_torch.kernels.ref.ssd_chunked`.

The float32 upcasts and the casts back sit where the reference has
them. Unlike the reference's functional updates, the decode step
updates the conv window and the SSD state it is given in place, as the
ring KV cache is: a step then writes the (B, H, P, N) state once instead
of allocating a new one per layer.

n_groups = 1: B and C are shared across heads.

The prefill takes any sequence length: :func:`repro_torch.kernels.ops.ssd_scan`
pads the scan's tail to a whole chunk with rows that leave the state as
it was, and a prompt shorter than the conv window keeps zeros before it
in the conv tail, as the causal conv reads them. The counter
``ssm.state_bytes`` adds the SSD and conv state bytes each decode step
reads and writes (both states read once and written once, every Mamba2
layer; a CUDA graph's replay adds its recorded count again).
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import tracing
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.kv_cache import conv_dim
from repro_torch.models.layers import dense_init, gated_rms_norm

Params = Dict[str, Any]


def init_mamba_block(gen: torch.Generator, cfg: ModelConfig, *, lead=(),
                     device=None) -> Params:
    """Random parameters with the reference's keys, shapes, scales and
    types: ``A_log``, ``dt_bias`` and ``D`` are float32 in any model
    dtype. ``lead`` stacks layers on leading axes."""
    dt = cfg.torch_dtype
    f32 = torch.float32
    dev = device or gen.device
    lead = tuple(lead)
    H, N = cfg.ssm_heads, cfg.ssm_state
    d_in = cfg.d_inner
    proj_out = 2 * d_in + 2 * N + H  # z, x, B, C, dt
    u = torch.rand(lead + (H,), generator=gen, dtype=f32, device=dev)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    conv_w = torch.randn(lead + (cfg.conv_width, conv_dim(cfg)), generator=gen,
                         dtype=f32, device=dev)
    a_log = torch.log(torch.arange(1, H + 1, dtype=f32, device=dev))
    return {
        "in_proj": dense_init(gen, cfg.d_model, proj_out, dt, lead=lead, device=dev),
        "conv_w": conv_w.mul_(0.1).to(dt),
        "conv_b": torch.zeros(lead + (conv_dim(cfg),), dtype=dt, device=dev),
        "A_log": a_log.expand(lead + (H,)).clone(),
        "dt_bias": torch.log(torch.expm1(dt_init)),  # inverse softplus
        "D": torch.ones(lead + (H,), dtype=f32, device=dev),
        "norm_w": torch.ones(lead + (d_in,), dtype=dt, device=dev),
        "out_proj": dense_init(gen, d_in, cfg.d_model, dt, lead=lead, device=dev),
    }


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_in, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in: 2 * d_in + 2 * N]
    dt_raw = zxbcdt[..., 2 * d_in + 2 * N:]
    assert dt_raw.shape[-1] == H
    return z, xbc, dt_raw


def causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv over (B, S, C) with window len(w), then SiLU."""
    K, S = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, K - 1, 0))
    out = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(K):  # K is tiny (4)
        out = out + pad[:, i: i + S].float() * w[i].float()
    out = out + b.float()
    return F.silu(out).to(xbc.dtype)


def conv_decode_step(
    xbc_t: torch.Tensor, conv_state: torch.Tensor, w: torch.Tensor, b: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One conv step. xbc_t: (B, C); conv_state: (B, K-1, C), the raw
    inputs of the last K-1 tokens, shifted in place to take xbc_t."""
    window = torch.cat([conv_state, xbc_t[:, None]], dim=1)  # (B, K, C)
    out = (window.float() * w.float()).sum(dim=1)
    out = F.silu(out + b.float()).to(xbc_t.dtype)
    conv_state.copy_(window[:, 1:])
    return out, conv_state


def ssd_decode_step(
    x_t: torch.Tensor,  # (B, H, P)
    dt_t: torch.Tensor,  # (B, H)
    A: torch.Tensor,  # (H,)
    B_t: torch.Tensor,  # (B, N)
    C_t: torch.Tensor,  # (B, N)
    state: torch.Tensor,  # (B, H, P, N) fp32, updated in place
) -> Tuple[torch.Tensor, torch.Tensor]:
    decay = torch.exp(dt_t.float() * A.float())  # (B,H)
    xw = x_t.float() * dt_t.float()[..., None]  # (B,H,P)
    state.mul_(decay[..., None, None]).add_(xw[..., None] * B_t.float()[:, None, None, :])
    y = torch.einsum("bhpn,bn->bhp", state, C_t.float())
    return y.to(x_t.dtype), state


# ---------------------------------------------------------------------------
# Full Mamba2 block
# ---------------------------------------------------------------------------


def mamba_block(
    p: Params,
    cfg: ModelConfig,
    u: torch.Tensor,  # (B, S, d_model) — already normed residual stream
    init_state: Optional[torch.Tensor] = None,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Prefill path.

    Returns (out: (B,S,d_model), final ssd state: (B,H,P,N),
    conv tail: (B, conv_width-1, conv_dim) — raw inputs for decode).
    x, B and C reach the scan as strided views of the conv output; the
    kernel takes their row strides, so no copy is made.
    """
    Bsz, S, _ = u.shape
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    zxbcdt = u @ p["in_proj"]
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    K1 = cfg.conv_width - 1
    conv_tail = xbc[:, S - K1:, :] if S >= K1 else F.pad(xbc, (0, 0, K1 - S, 0))
    xbc = causal_conv(xbc, p["conv_w"], p["conv_b"])
    x = xbc[..., : cfg.d_inner].reshape(Bsz, S, H, P)
    B_ = xbc[..., cfg.d_inner: cfg.d_inner + N]
    C_ = xbc[..., cfg.d_inner + N:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, final_state = ops.ssd_scan(x, dt, A, B_, C_, cfg.ssm_chunk, init_state,
                                  use_kernels=use_kernels)
    y = y + x * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(Bsz, S, cfg.d_inner)
    y = gated_rms_norm(y, z, p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], final_state, conv_tail


def mamba_decode(
    p: Params,
    cfg: ModelConfig,
    u_t: torch.Tensor,  # (B, d_model)
    conv_state: torch.Tensor,
    ssd_state: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One decode step. Returns (out: (B,d_model), conv_state, ssd_state);
    both states are the tensors given, updated in place."""
    Bsz = u_t.shape[0]
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    tracing.count("ssm.state_bytes", 2 * (ssd_state.numel() * ssd_state.element_size()
                                          + conv_state.numel() * conv_state.element_size()))
    zxbcdt = u_t @ p["in_proj"]
    z, xbc, dt_raw = _split_proj(cfg, zxbcdt)
    xbc, conv_state = conv_decode_step(xbc, conv_state, p["conv_w"], p["conv_b"])
    x = xbc[..., : cfg.d_inner].reshape(Bsz, H, P)
    B_t = xbc[..., cfg.d_inner: cfg.d_inner + N]
    C_t = xbc[..., cfg.d_inner + N:]
    dt = F.softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, ssd_state = ssd_decode_step(x, dt, A, B_t, C_t, ssd_state)
    y = y + x * p["D"].to(y.dtype)[None, :, None]
    y = y.reshape(Bsz, cfg.d_inner)
    y = gated_rms_norm(y, z, p["norm_w"], cfg.norm_eps)
    return y @ p["out_proj"], conv_state, ssd_state


def mamba_param_count(cfg: ModelConfig) -> int:
    H, N = cfg.ssm_heads, cfg.ssm_state
    d_in = cfg.d_inner
    proj_out = 2 * d_in + 2 * N + H
    n = cfg.d_model * proj_out
    n += cfg.conv_width * conv_dim(cfg) + conv_dim(cfg)
    n += H * 3  # A_log, dt_bias, D
    n += d_in  # norm
    n += d_in * cfg.d_model
    return n
