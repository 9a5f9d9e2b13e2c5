"""Shared building blocks: norms (plain and gated), RoPE, GQA attention, MLPs
(SwiGLU and squared ReLU).

Port of ``repro/models/layers.py``: plain functions over parameter dicts
of tensors, with the same keys and the same ``(in, out)`` weight layout
(``x @ w``). The float32 upcasts sit where the reference has them, and a
contraction the reference asks for with ``preferred_element_type=f32``
runs on float32 operands here.

The plain attention the kernels are held to, :func:`sdpa` and
:func:`sdpa_qtiled`, lives with them in :mod:`repro_torch.kernels.ref`
and is reached through this module too. The reference's other plain-path variants
are here as functions, each holding the same values as :func:`sdpa` with
its memory elsewhere: :func:`sdpa_grouped` (the reference's
``set_gqa_mode("grouped")``: the kv-head axis kept instead of K/V
repeated) and :func:`sdpa_decode_split` (its ``set_decode_mode("split")``).
Only the query tiling is a switch, ``set_attn_qtile(n)`` (kept in
``kernels/ref.py``: the plain prefill attention, ``ref.flash_attention_ref``,
runs over tiles of ``n`` query rows, so live scores are (B, H, n, S)
rather than (B, H, S, S); 0 is off), because the full-width float32 plain
path at S = 32768 needs it; it never touches a kernel's path. The grouped
and split forms are not switches here: no path of the port picks them
yet (the reference picks split decode only for a cache sharded across a
production mesh).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels.ref import (  # noqa: F401 (sdpa_qtiled, set_attn_qtile: reached here)
    _expand_kv,
    _mask,
    _probs,
    sdpa,
    sdpa_qtiled,
    set_attn_qtile,
)

Params = Dict[str, Any]


# ---------------------------------------------------------------------------
# Initializers
# ---------------------------------------------------------------------------


# float32 values drawn per call of torch.randn while a weight is made: its
# temporary stays at 256 MB however large the weight (internvl2-76b-40l's
# stacked MLP matrices would be a 37.6 GB float32 temporary, its lm_head 4.2 GB)
_DRAW = 1 << 26


def _normal(gen: torch.Generator, shape, scale: float, dtype, device=None) -> torch.Tensor:
    """Normal values times ``scale`` of ``shape`` in ``dtype``, drawn in
    float32 on ``device`` (the generator's by default), a block of rows
    at a time. On ``"meta"`` nothing is drawn: the result has the shape
    and dtype alone."""
    w = torch.empty(tuple(shape), dtype=dtype, device=device or gen.device)
    if w.device.type == "meta":
        return w
    rows = w.view(-1, shape[-1])
    step = max(1, _DRAW // shape[-1])
    for r in range(0, rows.shape[0], step):
        block = torch.randn((min(step, rows.shape[0] - r), shape[-1]), generator=gen,
                            dtype=torch.float32, device=w.device)
        rows[r:r + step] = block.mul_(scale)
    return w


def dense_init(gen: torch.Generator, in_dim: int, out_dim: int, dtype,
               *, lead=(), device=None) -> torch.Tensor:
    """Normal weights of shape ``lead + (in_dim, out_dim)`` scaled by
    ``in_dim ** -0.5``."""
    return _normal(gen, tuple(lead) + (in_dim, out_dim), in_dim ** -0.5, dtype, device)


def embed_init(gen: torch.Generator, vocab: int, dim: int, dtype, device=None) -> torch.Tensor:
    return _normal(gen, (vocab, dim), 0.02, dtype, device)


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


def rope_table(positions: torch.Tensor, head_dim: int,
               theta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE's (cos, sin) at ``positions`` (..., S) int32 for :func:`apply_rope`,
    each (..., S, 1, head_dim) float32: cos over both halves, sin negated
    over the first. A forward builds it once and every layer reads it."""
    half = head_dim // 2
    exponent = -torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    # a Python-scalar base: a tensor made from theta on the card would be a
    # host-to-device copy, and a stall, at every call. The power is taken in
    # float64 and rounded once, as XLA's float32 pow rounds (bit-equal to the
    # reference's frequencies): float32 pow differs from it by an ulp in some
    # entries, which at position 524287 moves an angle by up to 0.05 rad
    freq = torch.pow(theta, exponent.double()).float()
    angles = positions[..., None].float() * freq  # (..., S, half)
    cos, sin = torch.cos(angles), torch.sin(angles)
    return (torch.cat([cos, cos], dim=-1)[..., None, :],
            torch.cat([-sin, sin], dim=-1)[..., None, :])


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """Rotate x: (..., S, H, D) by a :func:`rope_table`: (x1, x2) becomes
    (x1 cos - x2 sin, x2 cos + x1 sin) in float32, the first half's
    difference taken as the sum with the negated sine (the same bits)."""
    half = x.shape[-1] // 2
    xf = x.float()
    swapped = torch.cat([xf[..., half:], xf[..., :half]], dim=-1)
    return (xf * cos + swapped * sin).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: (..., S) int32."""
    return apply_rope(x, *rope_table(positions, x.shape[-1], theta))


# ---------------------------------------------------------------------------
# Attention (GQA) -- plain paths
# ---------------------------------------------------------------------------


def init_attention(gen: torch.Generator, cfg: ModelConfig, *, lead=(),
                   device=None) -> Params:
    dt = cfg.torch_dtype
    kw = dict(lead=lead, device=device)
    p: Params = {
        "wq": dense_init(gen, cfg.d_model, cfg.q_dim, dt, **kw),
        "wk": dense_init(gen, cfg.d_model, cfg.kv_dim, dt, **kw),
        "wv": dense_init(gen, cfg.d_model, cfg.kv_dim, dt, **kw),
        "wo": dense_init(gen, cfg.q_dim, cfg.d_model, dt, **kw),
    }
    if cfg.qkv_bias:
        for name, dim in (("bq", cfg.q_dim), ("bk", cfg.kv_dim), ("bv", cfg.kv_dim)):
            p[name] = torch.zeros(tuple(lead) + (dim,), dtype=dt, device=device or gen.device)
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


def sdpa_grouped(
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
    """:func:`sdpa` with the kv-head axis kept and the q-head group folded
    into the contraction instead of K/V repeated to H heads (the
    reference's ``"grouped"`` GQA mode, its layers.py:126-165). The same
    values; the scores are (B, Hkv, H/Hkv, Sq, Skv)."""
    B, Sq, H, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    if q_positions is None:
        q_positions = torch.arange(Sq, dtype=torch.int32, device=q.device)[None, :]
    if kv_positions is None:
        kv_positions = torch.arange(Skv, dtype=torch.int32, device=q.device)[None, :]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, D)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float()) * D ** -0.5
    mask = _mask(B, q_positions[:, None, None, :, None], kv_positions[:, None, None, None, :],
                 causal, window,
                 None if kv_valid is None else kv_valid[:, None, None, None, :])
    o = torch.einsum("bhgqk,bkhd->bqhgd", _probs(logits, mask).to(v.dtype), v)
    return o.reshape(B, Sq, H, D)


def sdpa_decode_split(
    q: torch.Tensor,  # (B, 1, H, D): the current token's query
    k_self: torch.Tensor,  # (B, 1, Hkv, D)
    v_self: torch.Tensor,
    k_buf: torch.Tensor,  # (B, W, Hkv, D): the ring cache
    v_buf: torch.Tensor,
    *,
    kv_positions: torch.Tensor,  # (B, W)
    kv_valid: torch.Tensor,  # (B, W)
    q_pos: torch.Tensor,  # (B,)
) -> torch.Tensor:
    """One token's attention to the cache and to itself SEPARATELY, the two
    partial softmaxes merged with a log-sum-exp combine (the reference's
    ``layers.py:216``): the cache is never concatenated with the new
    entry. Equal to the full softmax up to rounding. The reference's
    ``constrain`` hook (a sharding constraint on the scores) has nothing
    to constrain on one device and is not taken."""
    B, _, H, D = q.shape
    Hkv = k_buf.shape[2]
    g = H // Hkv
    scale = D ** -0.5
    # cache part: (B, Hkv, g, W) scores, grouped GQA (no kv repeat)
    qg = q[:, 0].reshape(B, Hkv, g, D)
    s_c = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k_buf.float()) * scale
    mask = (kv_valid & (kv_positions <= q_pos[:, None]))[:, None, None, :]
    s_c = s_c.masked_fill(~mask, float("-inf"))
    m_c = torch.amax(s_c, dim=-1)  # (B, Hkv, g)
    m_c_safe = torch.where(torch.isfinite(m_c), m_c, 0.0)
    p = torch.where(mask, torch.exp(s_c - m_c_safe[..., None]), 0.0)
    l_c = p.sum(dim=-1)
    o_c = torch.einsum("bhgk,bkhd->bhgd", p.to(v_buf.dtype), v_buf)
    m_c_safe, l_c, o_c = m_c_safe.reshape(B, H), l_c.reshape(B, H), o_c.reshape(B, H, D)
    # self part: one score per head
    ks, vs = _expand_kv(k_self, H), _expand_kv(v_self, H)
    s_s = torch.einsum("bqhd,bqhd->bhq", q.float(), ks.float())[:, :, 0] * scale  # (B, H)
    # merge: o_c holds sum_k exp(s_k - m_c) v_k; the weights are exp(s_k - m)
    m = torch.maximum(m_c_safe, s_s)
    alpha_c = torch.where(l_c > 0, torch.exp(m_c_safe - m), 0.0)
    alpha_s = torch.exp(s_s - m)
    denom = l_c * alpha_c + alpha_s
    o = (o_c.float() * (alpha_c / denom)[..., None]
         + vs[:, 0].float() * (alpha_s / denom)[..., None])
    return o.to(q.dtype)[:, None]


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


def init_mlp(gen: torch.Generator, cfg: ModelConfig, *, lead=(), device=None,
             d_ff: Optional[int] = None) -> Params:
    """The MLP's weights at width ``d_ff`` (``cfg.d_ff`` by default)."""
    f = d_ff or cfg.d_ff
    dims = {"wg": (cfg.d_model, f), "wu": (cfg.d_model, f), "wd": (f, cfg.d_model)}
    return {k: dense_init(gen, *dims[k], cfg.torch_dtype, lead=lead, device=device)
            for k in _mlp_keys(cfg)}


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
