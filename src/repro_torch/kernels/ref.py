"""Plain PyTorch versions of the port's kernels.

They keep the signatures of ``repro/kernels/ref.py`` and delegate to the
port's plain model code (:func:`repro_torch.models.layers.sdpa`,
:func:`repro_torch.models.ssm.ssd_chunked`), so a kernel is held against
the same math the model runs with ``use_kernels=False`` (``moe_gmm_ref``
and ``moe_gmm_grouped_ref`` are the expert products themselves). ``ops`` takes them for CPU tensors; on the card they are what ``chip_smoke.py``
compares each kernel with. ``ssd_scan_sequential_ref`` is the step-by-step
recurrence, the ground truth for both the chunked form and the kernel.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.models import ssm as _ssm
from repro_torch.models.layers import sdpa


def flash_attention_ref(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    B, S = q.shape[:2]
    positions = torch.arange(S, dtype=torch.int32, device=q.device)[None].expand(B, S)
    return sdpa(q, k, v, causal=causal, q_positions=positions,
                kv_positions=positions, window=window)


def decode_attention_ref(
    q: torch.Tensor,  # (B, 1, H, D)
    k: torch.Tensor,  # (B, W, Hkv, D)
    v: torch.Tensor,
    kv_positions: torch.Tensor,  # (B, W) int32
    kv_valid: torch.Tensor,  # (B, W) bool
    q_pos: torch.Tensor,  # (B,) int32
) -> torch.Tensor:
    return sdpa(q, k, v, causal=True, q_positions=q_pos[:, None],
                kv_positions=kv_positions, kv_valid=kv_valid)


def ssd_scan_ref(
    x: torch.Tensor,  # (B, S, H, P)
    dt: torch.Tensor,  # (B, S, H) fp32, post-softplus
    A: torch.Tensor,  # (H,) fp32, negative
    B_: torch.Tensor,  # (B, S, N)
    C_: torch.Tensor,  # (B, S, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    return _ssm.ssd_chunked(x, dt, A, B_, C_, chunk, init_state)


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
