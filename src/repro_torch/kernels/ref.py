"""Plain PyTorch versions of the attention kernels.

They keep the signatures of ``repro/kernels/ref.py`` and delegate to the
port's plain attention (:func:`repro_torch.models.layers.sdpa`), so a
kernel is held against the same math the model runs with
``use_kernels=False``. ``ops`` takes them for CPU tensors; on the card
they are what ``chip_smoke.py`` compares each kernel with.
"""

from __future__ import annotations

from typing import Optional

import torch

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
