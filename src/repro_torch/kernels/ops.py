"""Public entry points of the port's kernels: attention, the SSD scan and
the MoE expert product.

A tensor on the CPU takes the plain PyTorch version (that is how the CPU
tests run the model); a CUDA tensor launches the hand-written kernel,
which raises if it cannot build or launch. Nothing falls back from the
kernel to the plain version.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
) -> torch.Tensor:
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_valid: torch.Tensor,
    q_pos: torch.Tensor,
) -> torch.Tensor:
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k, v, kv_positions, kv_valid, q_pos)
    return _dec.decode_attention(q, k, v, kv_positions, kv_valid, q_pos)


def ssd_scan(
    x: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    B_: torch.Tensor,
    C_: torch.Tensor,
    chunk: int,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cpu":
        return ref.ssd_scan_ref(x, dt, A, B_, C_, chunk, init_state)
    return _ssd.ssd_scan(x, dt, A, B_, C_, chunk, init_state)


def moe_gmm(buf: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if buf.device.type == "cpu":
        return ref.moe_gmm_ref(buf, w)
    return _gmm.moe_gmm(buf, w)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {"flash_attention": _fa.launches, "decode_attention": _dec.launches,
            "ssd_scan": _ssd.launches, "moe_gmm": _gmm.launches}


def reset_launch_counts() -> None:
    _fa.launches = 0
    _dec.launches = 0
    _ssd.launches = 0
    _gmm.launches = 0
