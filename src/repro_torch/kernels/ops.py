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

Attention takes the softmax ``scale``; None is 1/sqrt(head_dim), the
value every model but Granite's (1/128 at head_dim 128) uses, computed
as it always was. :func:`ssd_scan` takes any sequence length: it pads
the scan's tail to a whole chunk with rows of dt = 0 and x = B = C = 0,
which leave the state as it was (exp(0 * A) = 1, an input of 0), and
drops their outputs, so every real output and the final state are those
of the unpadded sequence. It records the span ``ssm.scan`` (batch,
tokens, pad_rows) around the call and counts the rows added (B x the
tail positions) under ``ssm.scan_pad_rows``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

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
    scale: Optional[float] = None,
    use_kernels: bool = True,
) -> torch.Tensor:
    if _plain(q, use_kernels):
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window, scale=scale)
    return _fa.flash_attention(q, k, v, causal=causal, window=window, scale=scale)


def decode_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_positions: torch.Tensor,
    kv_valid: torch.Tensor,
    q_pos: torch.Tensor,
    *,
    scale: Optional[float] = None,
    use_kernels: bool = True,
) -> torch.Tensor:
    if _plain(q, use_kernels):
        return ref.decode_attention_ref(q, k, v, kv_positions, kv_valid, q_pos, scale=scale)
    return _dec.decode_attention(q, k, v, kv_positions, kv_valid, q_pos, scale=scale)


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
    Bsz, S = x.shape[:2]
    pad = -S % chunk
    with tracing.span("ssm.scan", batch=Bsz, tokens=S, pad_rows=pad):
        if pad:
            tracing.count("ssm.scan_pad_rows", Bsz * pad)
            x = F.pad(x, (0, 0, 0, 0, 0, pad))
            dt = F.pad(dt, (0, 0, 0, pad))
            B_ = F.pad(B_, (0, 0, 0, pad))
            C_ = F.pad(C_, (0, 0, 0, pad))
        scan = ref.ssd_scan_ref if _plain(x, use_kernels) else _ssd.ssd_scan
        out = scan(x, dt, A, B_, C_, chunk, init_state)
    if not pad:
        return out
    y, state = out
    return y[:, :S], state


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
