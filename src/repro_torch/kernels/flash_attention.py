"""Flash attention for prefill: the wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:103``
(``flash_attention``; its plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`). bf16 runs on the
tensor cores over the GQA-packed rows of a kv head (``S * G``, G = H / Hkv
q heads a kv head): up to :data:`TC_MAX_ROWS` of them on ``mma.sync`` over
64-row tiles, above that on Hopper's warpgroup MMA fed by TMA over 128-row
tiles (the measured crossover is in the source). float32 runs on the CUDA
cores. Head dims 64, 96, 112 and 128; q, k and v start on 16 bytes (the
kernel copies 16-byte chunks, and TMA reads k and v). The wrapper checks
what the kernel takes, picks the body (:func:`body`), allocates the
output, launches on PyTorch's current stream and raises if the launch was
refused. It never falls back to the plain version:
:mod:`repro_torch.kernels.ops` routes CPU tensors and ``use_kernels=False``
there before this module is reached.

Counters: ``kernels.launches.flash_attention`` for every launch,
``kernels.launches.flash_attention_wgmma`` for those of the warpgroup-MMA
body, so a run shows the share of prefill calls it took.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import tracing
from repro_torch.kernels import _build

_ARGTYPES = (
    [ctypes.c_void_p] * 4          # q, k, v, o
    + [ctypes.c_int] * 8           # B, S, H, Hkv, D, causal, window, body
    + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
)
HEAD_DIMS = (64, 96, 112, 128)
DTYPES = (torch.float32, torch.bfloat16)
# the kernel's bodies, as flash_attention_launch numbers them
FLOAT32, BF16_MMA, BF16_WGMMA = 0, 1, 2
TC_MAX_ROWS = 512  # packed rows of a kv head up to which bf16 takes mma.sync


def body(dtype: torch.dtype, S: int, G: int) -> int:
    """The body a call launches: the CUDA-core one for float32; in bf16
    ``mma.sync`` while the packed rows of a kv head, ``S * G``, are at most
    :data:`TC_MAX_ROWS`, the warpgroup-MMA one above."""
    if dtype != torch.bfloat16:
        return FLOAT32
    return BF16_MMA if S * G <= TC_MAX_ROWS else BF16_WGMMA


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
    scale: Optional[float] = None,  # the scores' scale; None: D ** -0.5
) -> torch.Tensor:
    B, S, H, D = q.shape
    Hkv = k.shape[2]
    for name, t in (("q", q), ("k", k), ("v", v)):
        if not t.is_cuda:
            raise ValueError(f"flash_attention: {name} is on {t.device}, not CUDA")
        if t.dtype != q.dtype or t.dtype not in DTYPES:
            raise ValueError(f"flash_attention: {name} has dtype {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"flash_attention: {name} is not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"flash_attention: {name} does not start on 16 bytes")
    if k.shape != (B, S, Hkv, D) or v.shape != k.shape or H % Hkv:
        raise ValueError(f"flash_attention: shapes {q.shape} {k.shape} {v.shape}")
    if D not in HEAD_DIMS or S < 1:
        raise ValueError(f"flash_attention: head_dim {D} / seq {S} not supported")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention: window {window} < 1")
    if scale is not None and not scale > 0:
        raise ValueError(f"flash_attention: scale {scale} is not positive")
    launch = _build.load("flash_attention", _ARGTYPES)
    which = body(q.dtype, S, H // Hkv)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    B, S, H, Hkv, D, int(causal), window or 0, which,
                    D ** -0.5 if scale is None else scale,
                    torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention: kernel launch failed (CUDA error {rc})")
    tracing.count("kernels.launches.flash_attention")
    if which == BF16_WGMMA:
        tracing.count("kernels.launches.flash_attention_wgmma")
    return o
