"""Decode attention: the wrapper of ``csrc/decode_attention.cu``.

Replaces the TPU kernel ``src/repro/kernels/decode_attention.py:80``
(``decode_attention``; its plain version is
:func:`repro_torch.kernels.ref.decode_attention_ref`). One launch splits
the window over a thread-block cluster of ``cluster_size(W)`` blocks and
merges their partial softmax sums in distributed shared memory (see the
source). Head dims 64, 96, 112 and 128, up to 16 q heads per kv head; q,
k and v start on 16 bytes (the kernel copies 16-byte chunks). The
wrapper checks
what the kernel takes, allocates the output, launches on PyTorch's
current stream and raises if the launch was refused. It never falls back
to the plain version: :mod:`repro_torch.kernels.ops` routes CPU tensors
there before this module is reached.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.kernels import _build

_ARGTYPES = (
    [ctypes.c_void_p] * 7          # q, k, v, kv_pos, kv_valid, q_pos, o
    + [ctypes.c_int] * 6           # B, W, H, Hkv, D, is_bf16
    + [ctypes.c_float, ctypes.c_void_p]  # scale, stream
)
HEAD_DIMS = (64, 96, 112, 128)
DTYPES = (torch.float32, torch.bfloat16)
MAX_GROUP = 16  # q heads per kv head the kernel's shared memory holds


def cluster_size(W: int) -> int:
    """Blocks of the cluster that one (b, kv head) of a launch at W slots
    splits its window over (the kernel's own rule, read from its library)."""
    return _build.load("decode_attention", [ctypes.c_int],
                       symbol="decode_attention_cluster_size")(W)


def decode_attention(
    q: torch.Tensor,  # (B, 1, H, D)
    k: torch.Tensor,  # (B, W, Hkv, D)
    v: torch.Tensor,
    kv_positions: torch.Tensor,  # (B, W) int32
    kv_valid: torch.Tensor,  # (B, W) bool
    q_pos: torch.Tensor,  # (B,) int32
) -> torch.Tensor:
    B, one, H, D = q.shape
    W, Hkv = k.shape[1], k.shape[2]
    tensors = (("q", q, q.dtype), ("k", k, q.dtype), ("v", v, q.dtype),
               ("kv_positions", kv_positions, torch.int32),
               ("kv_valid", kv_valid, torch.bool), ("q_pos", q_pos, torch.int32))
    for name, t, dtype in tensors:
        if not t.is_cuda:
            raise ValueError(f"decode_attention: {name} is on {t.device}, not CUDA")
        if t.dtype != dtype:
            raise ValueError(f"decode_attention: {name} has dtype {t.dtype}, not {dtype}")
        if not t.is_contiguous():
            raise ValueError(f"decode_attention: {name} is not contiguous")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.data_ptr() % 16:
            raise ValueError(f"decode_attention: {name} does not start on 16 bytes")
    if (one != 1 or k.shape != (B, W, Hkv, D) or v.shape != k.shape
            or kv_positions.shape != (B, W) or kv_valid.shape != (B, W)
            or q_pos.shape != (B,) or H % Hkv):
        raise ValueError(f"decode_attention: shapes {q.shape} {k.shape} "
                         f"{kv_positions.shape} {q_pos.shape}")
    if q.dtype not in DTYPES or D not in HEAD_DIMS or H // Hkv > MAX_GROUP or W < 1:
        raise ValueError(f"decode_attention: {q.dtype} head_dim {D} group "
                         f"{H // Hkv} window {W} not supported")
    launch = _build.load("decode_attention", _ARGTYPES)
    o = torch.empty_like(q)
    with torch.cuda.device(q.device):
        rc = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), kv_positions.data_ptr(),
                    kv_valid.data_ptr(), q_pos.data_ptr(), o.data_ptr(),
                    B, W, H, Hkv, D, int(q.dtype == torch.bfloat16), D ** -0.5,
                    torch.cuda.current_stream(q.device).cuda_stream)
    if rc:
        raise RuntimeError(f"decode_attention: kernel launch failed (CUDA error {rc})")
    tracing.count("kernels.launches.decode_attention")
    return o
