"""Flash attention for prefill: the wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``src/repro/kernels/flash_attention.py:103``
(``flash_attention``; its plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`). bf16 runs on the
tensor cores over GQA-packed 64-row tiles, float32 on the CUDA cores (see
the source). Head dims 64, 96, 112 and 128; q, k and v start on 16 bytes
(the kernel copies 16-byte chunks). The wrapper checks
what the kernel takes, allocates the output, launches on PyTorch's
current stream and raises if the launch was refused. It never falls back
to the plain version: :mod:`repro_torch.kernels.ops` routes CPU tensors
there before this module is reached.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch import tracing
from repro_torch.kernels import _build

_ARGTYPES = (
    [ctypes.c_void_p] * 4          # q, k, v, o
    + [ctypes.c_int] * 8           # B, S, H, Hkv, D, causal, window, is_bf16
    + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
)
HEAD_DIMS = (64, 96, 112, 128)
DTYPES = (torch.float32, torch.bfloat16)


def flash_attention(
    q: torch.Tensor,  # (B, S, H, D)
    k: torch.Tensor,  # (B, S, Hkv, D)
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: Optional[int] = None,
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
    launch = _build.load("flash_attention", _ARGTYPES)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                    B, S, H, Hkv, D, int(causal), window or 0,
                    int(q.dtype == torch.bfloat16), D ** -0.5,
                    torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"flash_attention: kernel launch failed (CUDA error {rc})")
    tracing.count("kernels.launches.flash_attention")
    return o
