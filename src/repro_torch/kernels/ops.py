"""Public entry points of the port's kernels: attention, the SSD scan and
the MoE expert products (over per-expert buffers, or ragged over rows
sorted by expert).

This is the one place that picks between a hand-written kernel and its
plain version in :mod:`repro_torch.kernels.ref`. Each entry point takes
the model's ``use_kernels`` flag: with it off, or for a tensor on the CPU
(that is how the CPU tests run the model), the plain version runs; else
the kernel launches, and raises if it cannot build or launch (a meta
tensor reaches the kernel's wrapper too). Nothing falls back from the
kernel to the plain version.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import moe_gmm as _gmm
from repro_torch.kernels import ref
from repro_torch.kernels import ssd_scan as _ssd


def _plain(x: torch.Tensor, use_kernels: bool) -> bool:
    return not use_kernels or x.device.type == "cpu"


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    use_kernels: bool = True,
) -> torch.Tensor:
    if _plain(q, use_kernels):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    return _fa.flash_attention(q, k, v, causal=causal, window=window)


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_valid: torch.Tensor,
    q_pos: torch.Tensor,
    *,
    use_kernels: bool = True,
) -> torch.Tensor:
    if _plain(q, use_kernels):
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
    *,
    use_kernels: bool = True,
) -> Tuple[torch.Tensor, torch.Tensor]:
    if _plain(x, use_kernels):
        return ref.ssd_scan_ref(x, dt, A, B_, C_, chunk, init_state)
    return _ssd.ssd_scan(x, dt, A, B_, C_, chunk, init_state)


def moe_gmm(buf: torch.Tensor, w: torch.Tensor, *, use_kernels: bool = True) -> torch.Tensor:
    if _plain(buf, use_kernels):
        return ref.moe_gmm_ref(buf, w)
    return _gmm.moe_gmm(buf, w)


def moe_gmm_grouped(x: torch.Tensor, w: torch.Tensor, offsets: torch.Tensor, *,
                    use_kernels: bool = True) -> torch.Tensor:
    if _plain(x, use_kernels):
        return ref.moe_gmm_grouped_ref(x, w, offsets)
    return _gmm.moe_gmm_grouped(x, w, offsets)


# the kernels whose launches are counted: one a library, and the grouped
# MoE product beside moe_gmm in csrc/moe_gmm.cu
LAUNCHED = _build.KERNELS + ("moe_gmm_grouped",)


def launch_counts() -> Dict[str, int]:
    """Kernel launches since the last :func:`reset_launch_counts`: the
    tracer's ``kernels.launches.<kernel>`` counters, one for each of
    :data:`LAUNCHED`."""
    counts = tracing.counters()
    return {k: counts.get(f"kernels.launches.{k}", 0) for k in LAUNCHED}


def reset_launch_counts() -> None:
    tracing.reset_counters("kernels.launches.")
