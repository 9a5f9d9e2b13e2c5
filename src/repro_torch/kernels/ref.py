"""Plain PyTorch versions of the port's kernels, and the plain math they
are built from.

They keep the signatures of ``repro/kernels/ref.py``. This module is the
home of the plain attention (:func:`sdpa`, over query tiles
:func:`sdpa_qtiled`) and of the SSD scan's chunked dual form
(:func:`ssd_chunked`); ``moe_gmm_ref`` and ``moe_gmm_grouped_ref`` are
the expert products themselves. :mod:`repro_torch.kernels.ops` takes
these versions for CPU tensors and for ``use_kernels=False``, so a kernel
is held against the same math the model runs without it; on the card
they are what ``chip_smoke.py`` compares each kernel with.
``ssd_scan_sequential_ref`` is the step-by-step recurrence, the ground
truth for both the chunked form and the kernel. The models reach
:func:`sdpa`, :func:`sdpa_qtiled` and :func:`set_attn_qtile` through
:mod:`repro_torch.models.layers`; nothing here imports the models.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------


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
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Plain scaled-dot-product attention with GQA broadcast (the
    reference's ``"repeat"`` mode).

    q: (B,Sq,H,D); k,v: (B,Skv,Hkv,D). Masking uses absolute positions so
    the same code covers prefill and ring-buffer decode. A row with no
    live key returns 0. ``scale`` multiplies the scores (None: D ** -0.5).
    """
    B, Sq, H, D = q.shape
    Skv = k.shape[1]
    if q_positions is None:
        q_positions = torch.arange(Sq, dtype=torch.int32, device=q.device)[None, :]
    if kv_positions is None:
        kv_positions = torch.arange(Skv, dtype=torch.int32, device=q.device)[None, :]
    k = _expand_kv(k, H)
    v = _expand_kv(v, H)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * (
        D ** -0.5 if scale is None else scale)
    mask = _mask(B, q_positions[:, None, :, None], kv_positions[:, None, None, :],
                 causal, window, None if kv_valid is None else kv_valid[:, None, None, :])
    return torch.einsum("bhqk,bkhd->bqhd", _probs(logits, mask).to(v.dtype), v)


def _mask(B: int, qp: torch.Tensor, kp: torch.Tensor, causal: bool, window: Optional[int],
          valid: Optional[torch.Tensor]) -> torch.Tensor:
    """Live (query, key) pairs from broadcastable query / key positions."""
    mask = torch.ones((B,) + (1,) * (qp.ndim - 3) + (qp.shape[-2], kp.shape[-1]),
                      dtype=torch.bool, device=qp.device)
    if causal:
        mask = mask & (kp <= qp)
    if window is not None:
        mask = mask & (kp > qp - window)
    if valid is not None:
        mask = mask & valid
    return mask


def _probs(logits: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Softmax over the live keys; a row with none gives 0 (softmax of
    -inf alone is NaN)."""
    probs = torch.softmax(logits.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.where(mask.any(dim=-1, keepdim=True), probs, 0.0)


# Prefill attention over query tiles (the reference's layers.py:284-333):
# the plain sdpa materializes the (B, H, S, S) float32 scores, 68.7 GB at
# S = 32768 for 16 heads; tiles of n query rows bound them at (B, H, n, S)
# with the same values. 0 = off. Process-wide, as the reference's switch
# is; it never touches a kernel's path.
_ATTN_QTILE = 0


def set_attn_qtile(n: int) -> None:
    global _ATTN_QTILE
    _ATTN_QTILE = max(0, int(n))


def sdpa_qtiled(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_tile: int,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """:func:`sdpa` over a full sequence (positions 0..S-1 for queries and
    keys) in tiles of ``q_tile`` query rows, halved until they divide S;
    each tile attends to every key, as the reference's does."""
    B, S, H, D = q.shape
    qt = q_tile
    while S % qt:
        qt //= 2  # the largest power-of-two tile dividing S
    positions = torch.arange(S, dtype=torch.int32, device=q.device)[None].expand(B, S)
    if S // qt <= 1:
        return sdpa(q, k, v, causal=causal, q_positions=positions, kv_positions=positions,
                    window=window, scale=scale)
    return torch.cat([sdpa(q[:, i:i + qt], k, v, causal=causal,
                           q_positions=positions[:, i:i + qt], kv_positions=positions,
                           window=window, scale=scale)
                      for i in range(0, S, qt)], dim=1)


def flash_attention_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Attention over a full sequence at positions 0..S-1, in query tiles
    where :func:`set_attn_qtile` asks for them."""
    if _ATTN_QTILE:
        return sdpa_qtiled(q, k, v, causal=causal, window=window, q_tile=_ATTN_QTILE,
                           scale=scale)
    B, S = q.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=q.device)[None].expand(B, S)
    return sdpa(q, k, v, causal=causal, q_positions=positions,
                kv_positions=positions, window=window, scale=scale)


def decode_attention_ref(
    q: torch.Tensor,  # (B, 1, H, D)
    k: torch.Tensor,  # (B, W, Hkv, D)
    v: torch.Tensor,
    kv_positions: torch.Tensor,  # (B, W) int32
    kv_valid: torch.Tensor,  # (B, W) bool
    q_pos: torch.Tensor,  # (B,) int32
    scale: Optional[float] = None,
) -> torch.Tensor:
    return sdpa(q, k, v, causal=True, q_positions=q_pos[:, None],
                kv_positions=kv_positions, kv_valid=kv_valid, scale=scale)


# ---------------------------------------------------------------------------
# SSD scan
# ---------------------------------------------------------------------------


def _segsum(loga: torch.Tensor) -> torch.Tensor:
    """Lower-triangular pairwise sums: out[..., i, j] = sum_{j<k<=i} loga_k.

    loga: (..., Q). Returns (..., Q, Q) with -inf above the diagonal.
    """
    Q = loga.shape[-1]
    cum = torch.cumsum(loga, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]  # sum over (j, i]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=loga.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def ssd_chunked(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H)  post-softplus, > 0
    A: torch.Tensor,  # (H,)       negative
    B_: torch.Tensor,  # (B, S, N)
    C_: torch.Tensor,  # (B, S, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N) fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan (the dual form of arXiv:2405.21060). Returns
    (y: (B,S,H,P) in x's dtype, final_state: (B,H,P,N) float32)."""
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    Q = chunk
    if S % Q:
        raise ValueError(f"ssd_chunked: S={S} is not a multiple of chunk {Q}")
    nc = S // Q

    xw = (x.float() * dt.float()[..., None]).reshape(Bsz, nc, Q, H, P)
    loga = (dt.float() * A.float()).reshape(Bsz, nc, Q, H)  # log decay
    Bc = B_.float().reshape(Bsz, nc, Q, N)
    Cc = C_.float().reshape(Bsz, nc, Q, N)

    # --- intra-chunk (dual / attention-like form) --------------------------
    L = torch.exp(_segsum(loga.transpose(-1, -2)))  # (B,nc,H,Q,Q)
    scores = torch.einsum("bcin,bcjn->bcij", Cc, Bc)  # (B,nc,Q,Q)
    y_intra = torch.einsum("bchij,bcjhp->bcihp", L * scores[:, :, None], xw)

    # --- chunk-final states -------------------------------------------------
    cum = torch.cumsum(loga, dim=2)  # (B,nc,Q,H)
    total = cum[:, :, -1]  # (B,nc,H)
    decay_to_end = torch.exp(total[:, :, None] - cum)  # (B,nc,Q,H)
    chunk_states = torch.einsum("bcjn,bcjhp->bchpn", Bc, xw * decay_to_end[..., None])

    # --- inter-chunk recurrence over chunk states ---------------------------
    state = (torch.zeros((Bsz, H, P, N), dtype=torch.float32, device=x.device)
             if init_state is None else init_state.float())
    entering = []
    for c in range(nc):
        entering.append(state)  # the state *entering* chunk c
        state = state * torch.exp(total[:, c])[..., None, None] + chunk_states[:, c]
    entering = torch.stack(entering, dim=1)  # (B,nc,H,P,N)

    # --- inter-chunk output contribution ------------------------------------
    y_inter = torch.einsum("bcin,bchpn->bcihp", Cc, entering) * torch.exp(cum)[..., None]

    y = (y_intra + y_inter).reshape(Bsz, S, H, P)
    return y.to(x.dtype), state


def ssd_scan_ref(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) fp32, post-softplus
    A: torch.Tensor,  # (H,) fp32, negative
    B_: torch.Tensor,  # (B, S, N)
    C_: torch.Tensor,  # (B, S, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    return ssd_chunked(x, dt, A, B_, C_, chunk, init_state)


def ssd_scan_sequential_ref(
    x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, B_: torch.Tensor,
    C_: torch.Tensor, init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step-by-step recurrence, one token at a time, all in float32."""
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    f32 = torch.float32
    state = (torch.zeros((Bsz, H, P, N), dtype=f32, device=x.device)
             if init_state is None else init_state.float())
    ys = []
    for t in range(S):
        dt_t = dt[:, t].float()  # (B, H)
        decay = torch.exp(dt_t * A.float())
        xw = x[:, t].float() * dt_t[..., None]
        state = state * decay[..., None, None] + torch.einsum(
            "bhp,bn->bhpn", xw, B_[:, t].float())
        ys.append(torch.einsum("bhpn,bn->bhp", state, C_[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), state


# ---------------------------------------------------------------------------
# MoE expert products
# ---------------------------------------------------------------------------


def moe_gmm_ref(
    buf: torch.Tensor,  # (E, C, D) expert input buffers
    w: torch.Tensor,  # (E, D, F)
) -> torch.Tensor:
    """out[e] = buf[e] @ w[e], in float32, cast to buf's dtype."""
    return torch.einsum("ecd,edf->ecf", buf.float(), w.float()).to(buf.dtype)


def moe_gmm_grouped_ref(
    x: torch.Tensor,  # (R, D) rows sorted by expert
    w: torch.Tensor,  # (E, D, F)
    offsets: torch.Tensor,  # (E+1,) int32: expert e's rows offsets[e]:offsets[e+1]
) -> torch.Tensor:
    """out[r] = x[r] @ w[e] for each row r of expert e's group, in float32,
    cast to x's dtype: a loop over the experts (reads the offsets on the
    host)."""
    out = torch.empty((x.shape[0], w.shape[2]), dtype=x.dtype, device=x.device)
    bounds = offsets.tolist()
    for e in range(w.shape[0]):
        a, b = bounds[e], bounds[e + 1]
        out[a:b] = (x[a:b].float() @ w[e].float()).to(x.dtype)
    return out
