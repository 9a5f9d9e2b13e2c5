"""Mamba2 SSD chunked scan: the wrapper of ``csrc/ssd_scan.cu``.

Replaces the TPU kernel ``src/repro/kernels/ssd_scan.py:87`` (``ssd_scan``;
its plain version is :func:`repro_torch.kernels.ref.ssd_scan_ref`, the
step-by-step ground truth :func:`repro_torch.kernels.ref.ssd_scan_sequential_ref`).
The wrapper checks what the kernel takes, allocates the outputs, launches
on PyTorch's current stream and raises if the launch was refused. It
never falls back to the plain version: :mod:`repro_torch.kernels.ops`
routes CPU tensors and ``use_kernels=False`` there before this module is
reached.

x, B and C may be strided views (in the model they are slices of the
conv output): the kernel takes their batch and token strides, and needs
only the last axis contiguous and x's heads packed (head stride P).

bf16 runs on the tensor cores (C.B^T once for two heads, the decayed
scores rounded to bf16 in registers), float32 on the CUDA cores; the
designs are in ``csrc/ssd_scan.cu``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.kernels import _build

_PTR, _I64, _INT = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_ARGTYPES = (
    [_PTR, _I64, _I64]             # x, its batch and token strides
    + [_PTR, _PTR]                 # dt, A
    + [_PTR, _I64, _I64]           # B, strides
    + [_PTR, _I64, _I64]           # C, strides
    + [_PTR, _PTR, _PTR]           # init state (or NULL), y, final state
    + [_INT] * 7                   # Bsz, S, H, P, N, Q, is_bf16
    + [_PTR]                       # stream
)
HEAD_DIMS = (32, 64)
STATE_DIMS = (32, 64, 128)
CHUNKS = (32, 64, 256)
DTYPES = (torch.float32, torch.bfloat16)


def _check(name: str, t: torch.Tensor, dtype: torch.dtype) -> None:
    if not t.is_cuda:
        raise ValueError(f"ssd_scan: {name} is on {t.device}, not CUDA")
    if t.dtype != dtype:
        raise ValueError(f"ssd_scan: {name} has dtype {t.dtype}, not {dtype}")


def ssd_scan(
    x: torch.Tensor,  # (B, S, H, P) model dtype
    dt: torch.Tensor,  # (B, S, H) fp32, post-softplus
    A: torch.Tensor,  # (H,) fp32, negative
    B_: torch.Tensor,  # (B, S, N) x's dtype
    C_: torch.Tensor,  # (B, S, N)
    chunk: int,
    init_state: Optional[torch.Tensor] = None,  # (B, H, P, N) fp32
) -> Tuple[torch.Tensor, torch.Tensor]:
    Bsz, S, H, P = x.shape
    N = B_.shape[-1]
    for name, t, dtype in (("x", x, x.dtype), ("dt", dt, torch.float32),
                           ("A", A, torch.float32), ("B", B_, x.dtype),
                           ("C", C_, x.dtype)):
        _check(name, t, dtype)
    if init_state is not None:
        _check("init_state", init_state, torch.float32)
    if (dt.shape != (Bsz, S, H) or A.shape != (H,) or B_.shape != (Bsz, S, N)
            or C_.shape != B_.shape
            or (init_state is not None and init_state.shape != (Bsz, H, P, N))):
        raise ValueError(f"ssd_scan: shapes x {tuple(x.shape)} dt {tuple(dt.shape)} "
                         f"A {tuple(A.shape)} B {tuple(B_.shape)} C {tuple(C_.shape)}")
    if (x.dtype not in DTYPES or P not in HEAD_DIMS or N not in STATE_DIMS
            or chunk not in CHUNKS or S % chunk or S == 0):
        raise ValueError(f"ssd_scan: {x.dtype} head_dim {P} state {N} chunk {chunk} "
                         f"seq {S} not supported")
    if (x.stride(3) != 1 or (H > 1 and x.stride(2) != P)
            or B_.stride(2) != 1 or C_.stride(2) != 1):
        raise ValueError("ssd_scan: x, B and C need a contiguous last axis "
                         "and x its heads packed")
    if not (dt.is_contiguous() and A.is_contiguous()
            and (init_state is None or init_state.is_contiguous())):
        raise ValueError("ssd_scan: dt, A and init_state must be contiguous")
    launch = _build.load("ssd_scan", _ARGTYPES)
    y = torch.empty((Bsz, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((Bsz, H, P, N), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        rc = launch(x.data_ptr(), x.stride(0), x.stride(1), dt.data_ptr(), A.data_ptr(),
                    B_.data_ptr(), B_.stride(0), B_.stride(1),
                    C_.data_ptr(), C_.stride(0), C_.stride(1),
                    None if init_state is None else init_state.data_ptr(),
                    y.data_ptr(), state.data_ptr(),
                    Bsz, S, H, P, N, chunk, int(x.dtype == torch.bfloat16),
                    torch.cuda.current_stream(x.device).cuda_stream)
    if rc:
        raise RuntimeError(f"ssd_scan: kernel launch failed (CUDA error {rc})")
    tracing.count("kernels.launches.ssd_scan")
    return y, state
